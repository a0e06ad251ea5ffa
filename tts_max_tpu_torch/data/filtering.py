"""Composable sample filters returning reason strings (or None to keep).

Copy of ``tts_max_tpu/data/filtering.py`` (the port imports nothing of the JAX package).

Behavior parity with tts/data/filtering.py:8-74.
"""

from __future__ import annotations

import string

from tts_max_tpu_torch.data.samples import Sample


def filter_empty_transcript(sample: Sample):
    return "empty_transcript" if sample.transcript == "" else None


def filter_non_english(sample: Sample):
    return "non_english" if sample.language != "en" else None


def filter_long_duration(sample: Sample):
    return "long_duration" if sample.duration > 30.0 else None


def filter_punct_or_space_only_transcript(sample: Sample):
    t = sample.transcript
    if bool(t) and all(c in string.punctuation or c == " " for c in t):
        return "punct_or_space_only_transcript"
    return None


def filter_allowed_languages(allowed_languages):
    def _filter(sample: Sample):
        if allowed_languages and sample.language not in allowed_languages:
            return f"languages-{sample.language}"
        return None

    return _filter


def filter_min_sample_rate(min_sample_rate: int):
    def _filter(sample: Sample):
        if sample.sample_rate < min_sample_rate:
            return f"sampling_rate-{sample.sample_rate}"
        return None

    return _filter


def filter_min_dnsmos_score(min_dnsmos_score: float):
    def _filter(sample: Sample):
        if sample.dnsmos_mos_ovr < min_dnsmos_score:
            return "dnsmos"
        return None

    return _filter


def filter_min_audio_duration(min_audio_duration: float):
    def _filter(sample: Sample):
        if sample.duration < min_audio_duration:
            return "audio_duration"
        return None

    return _filter


DEFAULT_LOAD_FILTERS = (
    filter_empty_transcript,
    filter_non_english,
    filter_long_duration,
    filter_punct_or_space_only_transcript,
)


def apply_filters(sample: Sample, filters) -> str | None:
    """First matching filter reason, or None to keep (short-circuit)."""
    for f in filters:
        reason = f(sample)
        if reason:
            return reason
    return None
