"""Build and load the port's CUDA kernels (``tts_max_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. Libraries
go to ``build/kernels/`` beside the package and are named by a hash of
their source and flags, so an edited source rebuilds and an unchanged one
is reused. Nothing is built when a module is imported: the first launch of
a kernel builds its library, or ``build_all`` builds every source at once,
one ``nvcc`` process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("flash_attention", "flash_decode")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")
    return str(path)


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for dep in sorted(CSRC.glob("*.cuh")):
        h.update(dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str) -> tuple[Path, Path, subprocess.Popen] | None:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.with_suffix(".log"), "w")
    try:
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT,
        )
    finally:
        log.close()
    return out, tmp, proc


def _finish(name: str, started) -> None:
    out, tmp, proc = started
    if proc.wait() != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu:\n{out.with_suffix('.log').read_text()}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def build_all() -> None:
    """Compile every source that has no current library, in parallel."""
    started = {name: _start(name) for name in SOURCES}
    for name, st in started.items():
        if st is not None:
            _finish(name, st)


def build_log(name: str) -> str:
    """nvcc's output for the current build of ``name`` (ptxas register and
    shared-memory report), or '' when the library was built elsewhere."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _libs:
        st = _start(name)
        if st is not None:
            _finish(name, st)
        _libs[name] = ctypes.CDLL(str(library_path(name)))
    return _libs[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise for a nonzero ``cudaError_t`` returned by a C entry point of
    ``lib`` (each library exports ``cuda_error_string``)."""
    if err != 0:
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
