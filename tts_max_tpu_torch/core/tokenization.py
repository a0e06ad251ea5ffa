"""Tokenization: base-LM tokenizer extended with the 65536-token speech vocab.

Copy of ``tts_max_tpu/core/tokenization.py`` (numpy only; the port imports
nothing of the JAX package). 8 special markers + ``codebook_size`` speech
tokens are added via ``add_tokens(sorted(new_tokens))`` (NOTE:
*lexicographic* sort — "<|s_10|>" precedes "<|s_2|>"), then
``<|extra_token_i|>`` pads the vocab to the fixed 193856.

- ``SpeechVocab``: a precomputed numpy speech_id ↔ token_id map so the hot
  decode path never round-trips through strings.
- ``ByteTokenizer``: a self-contained byte-level base tokenizer so the whole
  pipeline runs air-gapped (no HF download). ``encode`` runs the port's C++
  host library (``tts_max_tpu_torch.native``), built on first use or
  raising; ``encode_plain`` is the Python loop it is held to in the tests.
- ``build_tokenizer``: an HF directory's ``tokenizer.json`` (Llama 3's
  byte-level BPE), read by the port's own ``core/hf_tokenizer.py`` where the
  JAX package calls ``transformers.AutoTokenizer``.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

import numpy as np

from tts_max_tpu_torch import native
from tts_max_tpu_torch.core import constants

_SPECIAL_RE = re.compile(r"<\|[^|<>]+\|>")


def extension_tokens(codebook_size: int = constants.CODEBOOK_SIZE) -> list[str]:
    """The added-token list in the exact order the reference adds them."""
    new_tokens = list(constants.SPECIAL_TOKENS)
    new_tokens.extend(
        constants.SPEECH_TOKEN_TEMPLATE.format(i) for i in range(codebook_size)
    )
    return sorted(new_tokens)


def extract_speech_ids(text: str) -> list[int]:
    """The N of every "<|s_N|>" in ``text``, in order."""
    return [int(m) for m in re.findall(r"<\|s_(\d+)\|>", text)]


@dataclass
class SpeechVocab:
    """Dense id-level mapping between codec codes and token ids."""

    speech_to_token: np.ndarray  # [codebook_size] int32
    token_to_speech: np.ndarray  # [vocab_size] int32, -1 where not a speech token
    speech_start_id: int
    speech_end_id: int
    text_prompt_start_id: int
    text_prompt_end_id: int

    def tokens_from_codes(self, codes: np.ndarray) -> np.ndarray:
        return self.speech_to_token[codes]

    def generation_window(self) -> tuple[int, int]:
        """(lo, size) of the contiguous token-id window containing every
        speech token and the structural markers SpeechVocab tracks
        (``<|speech_end|>`` in particular — the generation EOS).

        Every "<|s_N|>" sorts before every special, so the 65536 speech
        tokens occupy one contiguous id block immediately followed by the 8
        specials; constrained decode computes logits only over this window.
        """
        lo = int(self.speech_to_token.min())
        hi = int(self.speech_to_token.max())
        if hi - lo + 1 != len(self.speech_to_token):
            raise ValueError("speech token ids are not contiguous")
        for sid in (
            self.speech_start_id,
            self.speech_end_id,
            self.text_prompt_start_id,
            self.text_prompt_end_id,
        ):
            hi = max(hi, sid)
        return lo, hi - lo + 1

    def codes_from_tokens(self, tokens: np.ndarray) -> np.ndarray:
        """Keep only speech tokens, mapped back to codec codes."""
        mapped = self.token_to_speech[tokens]
        return mapped[mapped >= 0]


class ByteTokenizer:
    """Minimal byte-level tokenizer with HF-compatible surface.

    ids: 0 pad, 1 bos, 2 eos, 3..258 bytes; added tokens follow.
    Special tokens (``<|...|>``) are matched atomically.
    """

    def __init__(self) -> None:
        self._base = 259
        self._added: dict[str, int] = {}
        self._added_rev: dict[int, str] = {}
        self.pad_token_id = 0
        self.bos_token_id = 1
        self.eos_token_id = 2
        self._native: native.NativeTokenizer | None = None  # per vocabulary

    def __len__(self) -> int:
        return self._base + len(self._added)

    def add_tokens(self, tokens: list[str]) -> int:
        n = 0
        for t in tokens:
            if t not in self._added:
                tid = self._base + len(self._added)
                self._added[t] = tid
                self._added_rev[tid] = t
                n += 1
        if n:
            self._native = None
        return n

    def _native_tokenizer(self) -> native.NativeTokenizer:
        """The C++ encoder of the current vocabulary, built again after
        ``add_tokens`` changed it."""
        nt = self._native
        if nt is None:
            template, table = constants.SPEECH_TOKEN_TEMPLATE, []
            while template.format(len(table)) in self._added:
                table.append(self._added[template.format(len(table))])
            nt = self._native = native.NativeTokenizer(self._added, table)
        return nt

    def convert_tokens_to_ids(self, token: str | list[str]):
        if isinstance(token, list):
            return [self.convert_tokens_to_ids(t) for t in token]
        return self._added.get(token, 0)

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        ids = self._native_tokenizer().encode(text).tolist()
        return [self.bos_token_id, *ids] if add_special_tokens else ids

    def encode_plain(self, text: str, add_special_tokens: bool = False) -> list[int]:
        """``encode`` in Python: the plain version the native encode is held
        to. No main path calls it."""
        ids: list[int] = [self.bos_token_id] if add_special_tokens else []
        pos = 0
        while pos < len(text):
            m = _SPECIAL_RE.search(text, pos)
            seg_end = m.start() if m else len(text)
            for b in text[pos:seg_end].encode("utf-8"):
                ids.append(3 + b)
            if m:
                tok = m.group(0)
                if tok in self._added:
                    ids.append(self._added[tok])
                else:
                    for b in tok.encode("utf-8"):
                        ids.append(3 + b)
                pos = m.end()
            else:
                pos = seg_end
        return ids

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        out: list[str] = []
        buf = bytearray()
        for i in ids:
            i = int(i)
            if 3 <= i < 259:
                buf.append(i - 3)
                continue
            if buf:
                out.append(buf.decode("utf-8", errors="replace"))
                buf = bytearray()
            if i in self._added_rev:
                out.append(self._added_rev[i])
            elif not skip_special_tokens and i in (0, 1, 2):
                out.append(["<pad>", "<bos>", "<eos>"][i])
        if buf:
            out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)

    def __call__(self, text, **kw):
        return {"input_ids": self.encode(text)}


def extend_tokenizer(
    tokenizer,
    codebook_size: int = constants.CODEBOOK_SIZE,
    expected_vocab_size: int | None = constants.FIXED_VOCAB_SIZE,
):
    """Add speech/special/extra tokens in the reference's order."""
    original = len(tokenizer)
    if expected_vocab_size is not None and original == expected_vocab_size:
        return tokenizer
    tokenizer.add_tokens(extension_tokens(codebook_size))
    if expected_vocab_size is not None:
        new_size = len(tokenizer)
        if new_size < expected_vocab_size:
            extra = [
                constants.EXTRA_TOKEN_TEMPLATE.format(i)
                for i in range(expected_vocab_size - new_size)
            ]
            tokenizer.add_tokens(extra)
        if len(tokenizer) != expected_vocab_size:
            raise ValueError(
                f"Expected tokenizer size {expected_vocab_size}, got {len(tokenizer)}"
            )
    return tokenizer


def build_tokenizer(
    model_dir: str,
    max_seq_len: int = 2048,
    codebook_size: int = constants.CODEBOOK_SIZE,
    expected_vocab_size: int | None = constants.FIXED_VOCAB_SIZE,
):
    """An HF directory's tokenizer (its ``tokenizer.json`` and
    ``tokenizer_config.json``, read by the port's ``HFTokenizer``) with
    ``pad_token = eos_token``, extended with the speech vocabulary: the ids
    ``transformers.AutoTokenizer`` and ``extend_tokenizer`` give, without
    ``transformers``. A dir without ``tokenizer.json`` raises
    ``FileNotFoundError``, an unsupported file ``ValueError``."""
    from tts_max_tpu_torch.core.hf_tokenizer import HFTokenizer

    if not os.path.isfile(os.path.join(model_dir, "tokenizer.json")):
        raise FileNotFoundError(f"{model_dir} has no tokenizer.json")
    tokenizer = HFTokenizer.from_dir(model_dir)
    tokenizer.model_max_length = max_seq_len
    tokenizer.pad_token = tokenizer.eos_token
    return extend_tokenizer(tokenizer, codebook_size, expected_vocab_size)


def build_byte_tokenizer(
    codebook_size: int = constants.CODEBOOK_SIZE,
    expected_vocab_size: int | None = None,
) -> ByteTokenizer:
    """Air-gapped tokenizer for tests / from-scratch runs. Includes the
    llama-style chat-header tokens used by text SFT."""
    tok = ByteTokenizer()
    tok.add_tokens(["<|start_header_id|>", constants.END_HEADER_ID, "<|eot_id|>"])
    return extend_tokenizer(tok, codebook_size, expected_vocab_size)


def speech_vocab(tokenizer, codebook_size: int = constants.CODEBOOK_SIZE) -> SpeechVocab:
    """Precompute the dense speech_id ↔ token_id maps for a tokenizer."""
    tokens = [constants.SPEECH_TOKEN_TEMPLATE.format(i) for i in range(codebook_size)]
    ids = np.asarray(tokenizer.convert_tokens_to_ids(tokens), dtype=np.int32)
    vocab_size = len(tokenizer)
    inv = np.full((vocab_size,), -1, dtype=np.int32)
    inv[ids] = np.arange(codebook_size, dtype=np.int32)
    return SpeechVocab(
        speech_to_token=ids,
        token_to_speech=inv,
        speech_start_id=int(tokenizer.convert_tokens_to_ids(constants.SPEECH_START_TOKEN)),
        speech_end_id=int(tokenizer.convert_tokens_to_ids(constants.SPEECH_END_TOKEN)),
        text_prompt_start_id=int(
            tokenizer.convert_tokens_to_ids(constants.TEXT_PROMPT_START_TOKEN)
        ),
        text_prompt_end_id=int(
            tokenizer.convert_tokens_to_ids(constants.TEXT_PROMPT_END_TOKEN)
        ),
    )
