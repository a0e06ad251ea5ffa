"""Whisper-backed ASR for the WER reward (counterpart of
``tts_max_tpu/training/rlhf/asr.py``).

``make_transcribe_fn`` packages the port's Whisper (``models/whisper.py``)
as the ``transcribe_fn(audio, language) -> str`` backend that
``reward_utils.eval_wer`` consumes: log-mel, encoder and greedy decode on
the model's device, the forced prompt ``<|startoftranscript|>[<|lang|>]
[<|task|>][<|notimestamps|>]``. The function counts its calls (``calls``)
and the calls that returned a transcript (``completed``), so that a caller
can tell a transcript from the reward's default.

``load_transcriber`` reads a local HF Whisper directory: the weights through
the port's safetensors reader, the tokenizer with ``WhisperTokenizer``
below, which reads ``tokenizer.json`` (through ``core/hf_tokenizer``) and
``tokenizer_config.json`` instead of ``transformers``' ``WhisperTokenizer``
and gives the values the JAX loader takes from it.
"""

from __future__ import annotations

import json
import os
import re
from typing import Callable, Mapping

import numpy as np
import torch

from tts_max_tpu_torch.core.hf_tokenizer import CHAR_TO_BYTE, HFTokenizer
from tts_max_tpu_torch.models import whisper

_TIMESTAMP = re.compile(r"<\|(\d+\.\d+)\|>")


class WhisperTokenizer:
    """The lookups and the decode of ``transformers.WhisperTokenizer`` (the
    Python one the JAX loader uses) over a Whisper dir's files:

    - ``additional_special_tokens`` from ``tokenizer_config.json`` (else
      ``special_tokens_map.json``, else the added tokens ``tokenizer.json``
      marks special), and the special ids: those and the bos, eos, unk and
      pad tokens (``<|endoftext|>`` by default);
    - ``convert_tokens_to_ids``: an unknown token gives the unk id;
    - ``decode(ids, skip_special_tokens)``: with ``skip_special_tokens`` a
      sequence that starts with ``<|startofprev|>`` keeps only what follows
      ``<|startoftranscript|>`` (nothing without one) and special ids are
      dropped; runs of vocab tokens are decoded from GPT-2's byte alphabet
      as UTF-8 (invalid bytes replaced) run by run, added tokens (the
      timestamps) kept as text between them; then every ``<|x.xx|>`` is cut
      out of the text. No clean-up of spaces, as the Python tokenizer does
      none.
    """

    def __init__(self, model_dir: str):
        self._tok = HFTokenizer.from_dir(model_dir)
        config = {}
        for name in ("tokenizer_config.json", "special_tokens_map.json"):
            path = os.path.join(model_dir, name)
            if os.path.isfile(path):
                with open(path, encoding="utf-8") as f:
                    for k, v in json.load(f).items():
                        config.setdefault(k, v)

        def content(t):
            return t.get("content") if isinstance(t, dict) else t

        self.additional_special_tokens = [content(t) for t in config.get(
            "additional_special_tokens", [t.content for i, t in sorted(
                self._tok._added_tokens.items()) if t.special])]
        eot = "<|endoftext|>"
        self.unk_token = content(config.get("unk_token")) or eot
        named = [content(config.get("bos_token")) or eot, content(config.get("eos_token")) or eot,
                 self.unk_token, content(config.get("pad_token"))]
        self.all_special_ids = {self.convert_tokens_to_ids(t)
                                for t in named + self.additional_special_tokens if t}
        self.unk_token_id = self.convert_tokens_to_ids(self.unk_token)

    def __len__(self) -> int:
        return len(self._tok)

    def convert_tokens_to_ids(self, token: str) -> int | None:
        i = self._tok.token_to_id(token)
        return i if i is not None else self._tok.token_to_id(self.unk_token)

    def _strip_prompt(self, ids: list[int]) -> list[int]:
        prev = self.convert_tokens_to_ids("<|startofprev|>")
        start = self.convert_tokens_to_ids("<|startoftranscript|>")
        if ids and ids[0] == prev:
            return ids[ids.index(start):] if start in ids else []
        return ids

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        ids = [int(i) for i in ids]
        if skip_special_tokens:
            ids = self._strip_prompt(ids)
        pieces, run = [], []

        def flush():
            if run:
                pieces.append(bytes(CHAR_TO_BYTE[c] for c in "".join(run))
                              .decode("utf-8", errors="replace"))
                run.clear()

        for i in ids:
            if skip_special_tokens and i in self.all_special_ids:
                continue
            added = self._tok._added_tokens.get(i)
            if added is not None:
                flush()
                pieces.append(added.content)
            else:
                run.append(self._tok.id_to_token(i))
        flush()
        return _TIMESTAMP.sub("", "".join(pieces))

    def language_token_ids(self) -> dict[str, int]:
        """``{"en": id of <|en|>, ...}``: the additional special tokens
        ``<|xx|>`` of at most 8 characters with an alphabetic inner part."""
        out = {}
        for code in self.additional_special_tokens:
            if code.startswith("<|") and code.endswith("|>") and len(code) <= 8:
                inner = code[2:-2]
                if inner.isalpha():
                    out[inner] = self.convert_tokens_to_ids(code)
        return out


def make_transcribe_fn(
    params,
    cfg: whisper.WhisperConfig,
    detokenize_fn: Callable[[list[int]], str],
    *,
    language_token_ids: Mapping[str, int] | None = None,
    task_token_id: int | None = None,
    notimestamps_token_id: int | None = None,
    max_len: int = 224,
    default_language: str = "en",
) -> Callable[[np.ndarray, str], str]:
    """``transcribe_fn(audio [n] @16 kHz, language) -> str`` on the
    device of ``params``.

    The forced prompt is ``<|startoftranscript|>[<|lang|>][<|task|>]
    [<|notimestamps|>]``, each piece present only when its id is given.
    """
    language_token_ids = dict(language_token_ids or {})
    chunk_samples = cfg.max_source_positions * 2 * whisper.HOP_LENGTH
    dev = params["decoder"]["embed"].device
    widen = whisper.Widen()  # each bf16 decoder weight widened once for the model

    @torch.inference_mode()
    def transcribe(audio: np.ndarray, language: str) -> str:
        transcribe.calls += 1
        wav = whisper.pad_or_trim(audio, chunk_samples)
        mel = whisper.log_mel_spectrogram(torch.from_numpy(wav).to(dev)[None], cfg.n_mels)
        enc = whisper.encode(params, cfg, mel)
        prompt_ids = [cfg.decoder_start_token_id]
        lang_id = language_token_ids.get(
            (language or default_language).lower(),
            language_token_ids.get(default_language),
        )
        if lang_id is not None:
            prompt_ids.append(lang_id)
        if task_token_id is not None:
            prompt_ids.append(task_token_id)
        if notimestamps_token_id is not None:
            prompt_ids.append(notimestamps_token_id)
        prompt = torch.tensor([prompt_ids], dtype=torch.int32, device=dev)
        tokens, lengths = whisper.greedy_decode(params, cfg, enc, prompt, max_len, widen)
        n = int(lengths[0])
        text = detokenize_fn(tokens[0, len(prompt_ids):n].tolist())
        transcribe.completed += 1
        return text

    transcribe.calls = 0
    transcribe.completed = 0
    return transcribe


def load_transcriber(
    model_dir: str,
    *,
    max_len: int = 224,
    dtype=torch.bfloat16,
    device="cuda",
) -> Callable[[np.ndarray, str], str]:
    """``transcribe_fn`` from a local HF whisper dir (weights and tokenizer
    files): the transcribe task, no timestamps, the language forced per
    sample. The weights load in ``dtype`` (bf16, as JAX's default)."""
    params, cfg = whisper.load_whisper(model_dir, dtype=dtype, device=device)
    tok = WhisperTokenizer(model_dir)

    def tok_id(t: str) -> int | None:
        i = tok.convert_tokens_to_ids(t)
        return None if i is None or i == tok.unk_token_id else i

    def detok(ids: list[int]) -> str:
        return tok.decode(ids, skip_special_tokens=True).strip()

    return make_transcribe_fn(
        params,
        cfg,
        detok,
        language_token_ids=tok.language_token_ids(),
        task_token_id=tok_id("<|transcribe|>"),
        notimestamps_token_id=tok_id("<|notimestamps|>"),
        max_len=max_len,
    )
