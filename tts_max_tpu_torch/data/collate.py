"""Batch collation with TPU-static shapes.

Copy of ``tts_max_tpu/data/collate.py`` (the port imports nothing of the JAX package).

The reference pads each batch to its own longest sequence
(tts_datasets.py:169-223) — on TPU that recompiles per batch shape. Here
batches pad to the smallest *bucket* ≥ the batch max (default power-of-two-ish
ladder up to max_seq_len), so the jitted train step compiles once per bucket
and loss parity is preserved via -100 label masking.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from tts_max_tpu_torch.core import constants


def default_buckets(max_seq_len: int) -> tuple[int, ...]:
    buckets = []
    b = 128
    while b < max_seq_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_seq_len)
    return tuple(buckets)


def bucket_length(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def collate(
    features: list[dict[str, Any]],
    pad_token_id: int,
    buckets: Sequence[int] | None = None,
    max_seq_len: int = 2048,
) -> dict[str, Any]:
    """Pad input_ids/labels to the bucket length; carry bookkeeping fields.

    Returns {} for an all-fast-forward batch (resume path)."""
    if sum(len(f) for f in features) == 0:
        return {}
    buckets = buckets or default_buckets(max_seq_len)
    longest = max(len(f["input_ids"]) for f in features)
    L = bucket_length(longest, buckets)
    n = len(features)
    input_ids = np.full((n, L), pad_token_id, dtype=np.int32)
    labels = np.full((n, L), constants.LOSS_IGNORE_TOKEN_ID, dtype=np.int32)
    for i, f in enumerate(features):
        ids = f["input_ids"][:L]
        lb = f["labels"][:L]
        input_ids[i, : len(ids)] = ids
        labels[i, : len(lb)] = lb
    out = {
        "source": [f.get("source", "default") for f in features],
        "input_ids": input_ids,
        "labels": labels,
        "tokens_processed": np.asarray(
            [f["tokens_processed"] for f in features], dtype=np.int64
        ),
        "audio_processed_sec": np.asarray(
            [f["audio_processed_sec"] for f in features], dtype=np.float64
        ),
    }
    if "generated_audio_duration_sec" in features[0]:
        out["generated_audio_duration_sec"] = np.asarray(
            [f["generated_audio_duration_sec"] for f in features], dtype=np.float64
        )
    return out


def prettify_batch(batch: dict[str, Any]) -> dict[str, Any]:
    """Strip bookkeeping fields before feeding the model
    (reference tts_datasets.py:287-297)."""
    return {
        k: v
        for k, v in batch.items()
        if k
        not in (
            "tokens_processed",
            "generated_audio_duration_sec",
            "audio_processed_sec",
            "source",
        )
    }
