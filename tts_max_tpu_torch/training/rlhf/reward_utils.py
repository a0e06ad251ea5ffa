"""Reward evaluation utilities: WER/CER, normalizers, transcript cleanup
(counterpart of ``tts_max_tpu/training/rlhf/reward_utils.py``).

reward = exp(-2.5·wer); dnsmos [1,5] → [0,1]; cosine [-1,1] → [0,1]; CER
instead of WER for zh/ja/ko; punctuation-stripped lowercase normalization.
The edit distance runs the port's C++ host library
(``tts_max_tpu_torch.native.levenshtein``); ``edit_distance_plain`` is the
Python loop it is held to in the tests.
"""

from __future__ import annotations

import math
import string
import sys
import unicodedata

import numpy as np

from tts_max_tpu_torch import native

EVAL_SAMPLE_RATE = 16000
DEFAULT_WER = 5.0
DEFAULT_DNSMOS = 0.0
DEFAULT_SIMILARITY = 0.0
CER_LANG_LIST = ("zh", "ja", "ko")

# ascii + CJK punctuation (zhon.hanzi.punctuation equivalent via Unicode)
_PUNCT = set(string.punctuation) | {
    chr(c)
    for c in range(sys.maxunicode + 1)
    if unicodedata.category(chr(c)).startswith("P")
}


def normalize_transcript(transcript: str, language: str) -> str:
    normalized = transcript.lower().strip()
    normalized = "".join(c for c in normalized if c not in _PUNCT)
    normalized = " ".join(normalized.split())
    if language in CER_LANG_LIST:
        normalized = normalized.replace(" ", "")
    return normalized


def edit_distance(ref: list, hyp: list) -> int:
    """Levenshtein distance over token sequences (words or characters)."""
    return native.levenshtein(ref, hyp)


def edit_distance_plain(ref: list, hyp: list) -> int:
    """``edit_distance`` in Python: the plain version the native one is held
    to. No main path calls it."""
    if not ref:
        return len(hyp)
    prev = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, 1):
        cur = [i] + [0] * len(hyp)
        for j, h in enumerate(hyp, 1):
            cur[j] = min(
                prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (0 if r == h else 1)
            )
        prev = cur
    return prev[-1]


def word_error_rate(reference: str, hypothesis: str) -> float:
    ref = reference.split()
    hyp = hypothesis.split()
    if not ref:
        return 0.0 if not hyp else 1.0
    return edit_distance(ref, hyp) / len(ref)


def char_error_rate(reference: str, hypothesis: str) -> float:
    if not reference:
        return 0.0 if not hypothesis else 1.0
    return edit_distance(list(reference), list(hypothesis)) / len(reference)


def normalize_wer(wer: float) -> float:
    """reward = exp(-2.5·wer)."""
    return math.exp(-2.5 * wer)


def normalize_dnsmos(dnsmos: float) -> float:
    return (dnsmos - 1) / 4


def normalize_similarity(similarity: float) -> float:
    return (similarity + 1) / 2


def eval_wer(
    transcribe_fn,
    audio: np.ndarray,
    sample_rate: int,
    ground_truth: str,
    language: str,
) -> float:
    """WER (CER for zh/ja/ko) of transcribe_fn(audio) vs ground truth.

    ``transcribe_fn(audio [n], language) -> str`` is the pluggable ASR
    backend (``asr.load_transcriber``'s Whisper). As in the reference, a
    failing backend or an empty transcript gives ``DEFAULT_WER``."""
    audio = np.asarray(audio).reshape(-1)
    if audio.size == 0:
        return DEFAULT_WER
    if sample_rate != EVAL_SAMPLE_RATE:
        from scipy.signal import resample_poly

        g = math.gcd(sample_rate, EVAL_SAMPLE_RATE)
        audio = resample_poly(audio, EVAL_SAMPLE_RATE // g, sample_rate // g)
    try:
        transcription = transcribe_fn(audio, language)
    except Exception:
        return DEFAULT_WER
    if not transcription:
        return DEFAULT_WER
    truth = normalize_transcript(ground_truth, language)
    hyp = normalize_transcript(transcription, language)
    if language in CER_LANG_LIST:
        return char_error_rate(truth, hyp)
    return word_error_rate(truth, hyp)


def eval_similarity(embed_fn, prompt_audio: np.ndarray, completion_audio: np.ndarray) -> float:
    """Cosine similarity of speaker embeddings; ``embed_fn(audio [n]) ->
    embedding [d]`` (``ecapa.load_wavlm_similarity_embedder``). As in the
    reference, a failing backend gives ``DEFAULT_SIMILARITY``."""
    completion_audio = np.asarray(completion_audio).reshape(-1)
    if completion_audio.size == 0:
        return DEFAULT_SIMILARITY
    try:
        a = np.asarray(embed_fn(np.asarray(prompt_audio).reshape(-1)))
        b = np.asarray(embed_fn(completion_audio))
        denom = np.linalg.norm(a) * np.linalg.norm(b)
        if denom == 0:
            return DEFAULT_SIMILARITY
        return float(np.dot(a, b) / denom)
    except Exception:
        return DEFAULT_SIMILARITY
