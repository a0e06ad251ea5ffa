"""Vectorized-dataset IO: the codes/index/samples triple-file format.

Copy of ``tts_max_tpu/data/codes_io.py`` (the port imports nothing of the JAX package).

Byte-compatible with the reference layout
(tts/data/data_utils.py:98-152, tools/data/data_vectorizer.py
save_data, tools/data/data_merger.py merge_shards):

- ``{split}_codes.npy``        raw int32 (headerless; written via np.memmap)
- ``{split}_codes_index.npy``  np.save array of per-sample START offsets
- ``{split}_samples.jsonl``    one Sample json per line, aligned with index

Shard files carry a ``_{rank}`` suffix before the extension.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Any, Sequence

import numpy as np

from tts_max_tpu_torch.data import filtering
from tts_max_tpu_torch.data.samples import Sample


def codes_paths(dataset_dir: str, split: str, rank: int | None = None):
    suf = f"_{rank}" if rank is not None else ""
    return (
        os.path.join(dataset_dir, f"{split}_codes{suf}.npy"),
        os.path.join(dataset_dir, f"{split}_codes_index{suf}.npy"),
        os.path.join(dataset_dir, f"{split}_samples{suf}.jsonl"),
    )


def write_shard(
    dataset_dir: str,
    split: str,
    codes: np.ndarray,
    codes_index: np.ndarray,
    samples: Sequence[Sample],
    rank: int | None = None,
) -> None:
    """Write one (rank-)shard in the reference format."""
    os.makedirs(dataset_dir, exist_ok=True)
    codes_path, index_path, samples_path = codes_paths(dataset_dir, split, rank)
    np.save(index_path, np.asarray(codes_index, dtype=np.int64))
    arr = np.memmap(codes_path, dtype=np.int32, mode="w+", shape=(len(codes),))
    arr[:] = np.asarray(codes, dtype=np.int32)
    arr.flush()
    with open(samples_path, "w", encoding="utf-8") as f:
        for s in samples:
            f.write(json.dumps(s.to_json(), ensure_ascii=False) + "\n")


def load_codes(dataset_dir: str, split: str, rank: int | None = None):
    """Return (codes memmap int32 [N], index array, samples jsonl lines)."""
    codes_path, index_path, samples_path = codes_paths(dataset_dir, split, rank)
    codes = np.memmap(codes_path, dtype=np.int32, mode="r")
    index = np.load(index_path)
    with open(samples_path, encoding="utf-8") as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    return codes, index, lines


def load_and_filter_audio_codes_and_samples(
    dataset_dir: str, split: str, dataset_config=None, extra_filters=()
) -> tuple[np.ndarray, list[Sample], list[tuple[int, int]], dict[str, int]]:
    """Reference data_utils.py:98-152 equivalent: memmap codes + per-sample
    (start, end) spans for samples surviving the filter chain."""
    dataset_name = os.path.basename(dataset_dir) + "_" + split
    codes, index, lines = load_codes(dataset_dir, split)
    n_codes = codes.shape[0]

    filters = list(extra_filters)
    if dataset_config is not None:
        filters = [
            filtering.filter_allowed_languages(dataset_config.allowed_languages),
            filtering.filter_min_sample_rate(dataset_config.min_sample_rate),
            filtering.filter_min_dnsmos_score(dataset_config.min_dnsmos_score),
            filtering.filter_min_audio_duration(dataset_config.min_duration_sec),
            filtering.filter_empty_transcript,
            filtering.filter_long_duration,
            filtering.filter_punct_or_space_only_transcript,
        ] + filters

    kept_samples: list[Sample] = []
    kept_spans: list[tuple[int, int]] = []
    status: collections.Counter = collections.Counter()
    for idx, line in enumerate(lines):
        sample = Sample.from_json(json.loads(line), dataset_name)
        status["total"] += 1
        reason = filtering.apply_filters(sample, filters)
        if reason:
            status[f"filtered_by_{reason}"] += 1
            status["total_filtered"] += 1
            continue
        status[sample.language] += 1
        left = int(index[idx])
        right = int(index[idx + 1]) if idx < len(index) - 1 else n_codes
        kept_samples.append(sample)
        kept_spans.append((left, right))
    return codes, kept_samples, kept_spans, dict(status)


def merge_shards(dataset_dir: str, split: str, output_dir: str | None = None,
                 ranks: Sequence[int] | None = None) -> dict[str, Any]:
    """Offline shard merge (reference data_merger.py:150-215): shift index
    offsets, concatenate codes, keep samples aligned."""
    output_dir = output_dir or dataset_dir
    if ranks is None:
        ranks = sorted(
            int(f.rsplit("_", 1)[1].split(".")[0])
            for f in os.listdir(dataset_dir)
            if f.startswith(f"{split}_codes_") and not f.startswith(f"{split}_codes_index")
        )
    all_codes, all_index, all_lines = [], [], []
    offset = 0
    for r in ranks:
        codes, index, lines = load_codes(dataset_dir, split, rank=r)
        if len(index) != len(lines):
            raise ValueError(
                f"shard {r}: codes_index has {len(index)} entries but samples "
                f"file has {len(lines)} lines"
            )
        all_codes.append(np.asarray(codes))
        all_index.append(np.asarray(index) + offset)
        all_lines.extend(lines)
        offset += codes.shape[0]
    merged_codes = np.concatenate(all_codes) if all_codes else np.zeros(0, np.int32)
    merged_index = np.concatenate(all_index) if all_index else np.zeros(0, np.int64)
    if len(all_lines) != len(merged_index):
        raise ValueError("sample/index count mismatch after merge")

    codes_path, index_path, samples_path = codes_paths(output_dir, split)
    os.makedirs(output_dir, exist_ok=True)
    arr = np.memmap(codes_path, dtype=np.int32, mode="w+", shape=(len(merged_codes),))
    arr[:] = merged_codes
    arr.flush()
    np.save(index_path, merged_index, allow_pickle=False)
    with open(samples_path, "w", encoding="utf-8") as f:
        for line in all_lines:
            f.write(line + "\n")
    return {
        "num_shards": len(ranks),
        "total_codes": int(len(merged_codes)),
        "total_samples": len(all_lines),
    }


def validate_merged(dataset_dir: str, split: str) -> None:
    """Post-merge contiguity validation (reference data_merger.py:218-246)."""
    codes, index, lines = load_codes(dataset_dir, split)
    if len(index) != len(lines):
        raise ValueError(
            f"{split}: index entries [{len(index)}] != samples [{len(lines)}]"
        )
    prev = 0
    for i, off in enumerate(index):
        if off != prev and i > 0 and off < prev:
            raise ValueError(f"{split}: non-monotonic offset at {i}: {off} < {prev}")
        prev = off
    if len(index) and index[0] != 0:
        raise ValueError(f"{split}: first offset must be 0, got {index[0]}")
    if len(index) and index[-1] > codes.shape[0]:
        raise ValueError(f"{split}: last offset beyond codes array")


def chunk_work(work_items: list, worker_id: int, num_workers: int) -> list:
    """Static sharding of work items by rank (reference data_utils.py:17-34)."""
    if num_workers <= 1:
        return work_items
    total = len(work_items)
    chunk_size = total // num_workers
    start = worker_id * chunk_size
    end = total if worker_id == num_workers - 1 else start + chunk_size
    return work_items[start:end]
