"""Offline shard merge: the vectorizer's per-rank shards -> one dataset per
split (counterpart of ``tools/data_merger.py``).

Discovers ``<split>_codes_<rank>`` shards, shifts the index offsets,
concatenates, checks contiguity, and optionally removes the shards; the
files are byte-identical to the JAX tool's (``data/codes_io.py``).

  python -m tts_max_tpu_torch.tools.data_merger --dataset_dir out [--remove_shards]
"""

from __future__ import annotations

import argparse
import os

from tts_max_tpu_torch.data import codes_io
from tts_max_tpu_torch.utils.logging import get_logger, setup_logging

log = get_logger("merger")


def main(argv=None) -> dict:
    """Returns {split: merge info} for the splits that had shards."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_dir", required=True)
    parser.add_argument("--splits", nargs="*", default=["train", "val"])
    parser.add_argument("--remove_shards", action="store_true")
    args = parser.parse_args(argv)
    setup_logging(0)

    merged = {}
    for split in args.splits:
        shard_files = [
            f for f in os.listdir(args.dataset_dir)
            if f.startswith(f"{split}_codes_") and not f.startswith(f"{split}_codes_index")
        ]
        if not shard_files:
            log.info("No %s shards found, skipping.", split)
            continue
        merged[split] = codes_io.merge_shards(args.dataset_dir, split)
        codes_io.validate_merged(args.dataset_dir, split)
        log.info("Merged %s: %s", split, merged[split])
        if args.remove_shards:
            ranks = sorted(int(f.rsplit("_", 1)[1].split(".")[0]) for f in shard_files)
            for r in ranks:
                for p in codes_io.codes_paths(args.dataset_dir, split, r):
                    if os.path.exists(p):
                        os.remove(p)
            log.info("Removed %d %s shard files.", len(ranks) * 3, split)
    return merged


if __name__ == "__main__":
    main()
