"""The port's C++ host runtime (``tts_max_tpu_torch/csrc/ttsmax_native.cc``),
loaded with ``ctypes`` (counterpart of ``tts_max_tpu/native``).

Two host loops run here: ``NativeTokenizer.encode``, behind
``core.tokenization.ByteTokenizer.encode`` (every request's prompt and
every SFT sample), and ``levenshtein``, behind
``training.rlhf.reward_utils.edit_distance`` (every WER/CER reward). The
source compiles with ``g++`` at first use into ``build/host/`` beside the
package, under a name that carries a hash of the source, the compiler and
its flags; a process writes a temporary file and renames it into place, so
that several processes can build at once. A missing compiler or a failed
build raises with the compiler's output: no caller falls back to Python.
Each call counts on ``levenshtein.calls`` or ``NativeTokenizer.encode_calls``
(``counts()``, ``reset_counts()``), as the kernels count their launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "ttsmax_native.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX = "g++"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()

_I32P = ctypes.POINTER(ctypes.c_int32)


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((CXX, *CXX_FLAGS)).encode())
    return BUILD_DIR / f"libttsmax_native-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """The library for the current source, compiled if it is not there yet.
    Raises ``RuntimeError`` with the compiler's output if it cannot be."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run {CXX} to build {SOURCE.name}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} failed for {SOURCE.name} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.ttsmax_port_levenshtein.restype = ctypes.c_int32
            lib.ttsmax_port_levenshtein.argtypes = [_I32P, ctypes.c_int32, _I32P,
                                                    ctypes.c_int32]
            lib.ttsmax_port_tokenizer_new.restype = ctypes.c_void_p
            lib.ttsmax_port_tokenizer_new.argtypes = []
            lib.ttsmax_port_tokenizer_free.restype = None
            lib.ttsmax_port_tokenizer_free.argtypes = [ctypes.c_void_p]
            lib.ttsmax_port_tokenizer_add_tokens.restype = None
            lib.ttsmax_port_tokenizer_add_tokens.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, _I32P, _I32P, ctypes.c_int32]
            lib.ttsmax_port_tokenizer_set_speech_table.restype = None
            lib.ttsmax_port_tokenizer_set_speech_table.argtypes = [
                ctypes.c_void_p, _I32P, ctypes.c_int32]
            lib.ttsmax_port_tokenizer_encode.restype = ctypes.c_int32
            lib.ttsmax_port_tokenizer_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32, _I32P, ctypes.c_int32]
            _lib = lib
        return _lib


def levenshtein(ref, hyp) -> int:
    """Edit distance between two sequences of hashable tokens (words or
    characters), each token mapped to an int32 id first."""
    lib = get_lib()
    vocab: dict = {}
    r = [vocab.setdefault(x, len(vocab)) for x in ref]
    h = [vocab.setdefault(x, len(vocab)) for x in hyp]
    d = lib.ttsmax_port_levenshtein((ctypes.c_int32 * len(r))(*r), len(r),
                                    (ctypes.c_int32 * len(h))(*h), len(h))
    with _count_lock:
        levenshtein.calls += 1
    return int(d)


levenshtein.calls = 0


class NativeTokenizer:
    """The C++ encode of a ``ByteTokenizer`` vocabulary: ``added_tokens``
    (text -> id) and ``speech_table``, the ids of "<|s_0|>", "<|s_1|>", ...
    in code order."""

    encode_calls = 0

    def __init__(self, added_tokens: dict[str, int], speech_table) -> None:
        self._lib = get_lib()
        self._handle = self._lib.ttsmax_port_tokenizer_new()
        tokens = [t.encode("utf-8") for t in added_tokens]
        lens = np.fromiter(map(len, tokens), np.int32, len(tokens))
        ids = np.fromiter(added_tokens.values(), np.int32, len(tokens))
        self._lib.ttsmax_port_tokenizer_add_tokens(
            self._handle, b"".join(tokens), lens.ctypes.data_as(_I32P),
            ids.ctypes.data_as(_I32P), len(tokens))
        table = np.ascontiguousarray(speech_table, dtype=np.int32)
        self._lib.ttsmax_port_tokenizer_set_speech_table(
            self._handle, table.ctypes.data_as(_I32P), len(table))

    def encode(self, text: str) -> np.ndarray:
        """The int32 ids of ``text`` (no bos)."""
        data = text.encode("utf-8")
        out = np.empty(len(data), dtype=np.int32)
        n = self._lib.ttsmax_port_tokenizer_encode(self._handle, data, len(data),
                                                   out.ctypes.data_as(_I32P), len(out))
        if n < 0:
            raise RuntimeError(f"native encode overflowed {len(out)} ids")
        with _count_lock:
            NativeTokenizer.encode_calls += 1
        return out[:n]

    def __del__(self) -> None:
        handle = getattr(self, "_handle", None)
        if handle is not None:
            self._lib.ttsmax_port_tokenizer_free(handle)


def counts() -> dict[str, int]:
    """Native calls since the last ``reset_counts``."""
    return {"encode": NativeTokenizer.encode_calls, "levenshtein": levenshtein.calls}


def reset_counts() -> None:
    with _count_lock:
        NativeTokenizer.encode_calls = 0
        levenshtein.calls = 0
