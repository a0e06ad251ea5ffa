"""Codec-encode job: a jsonl of samples -> codes/index/samples shards
(counterpart of ``tools/data_vectorizer.py``).

Each process takes its static ``chunk_work`` share of the samples, splits
off a validation share, and encodes its wavs in batches through
``api.AudioEncoder`` on the device (on the card the encoder's activations
run kernel G, ``ops/act1d.py``). A batch is zero-padded to a 1 s bucket and
each sample trimmed back to its own code count. Shards are written in the
JAX tool's byte format (``data/codes_io.py``); ``data_merger`` joins them.

  python -m tts_max_tpu_torch.tools.data_vectorizer --samples_path s.jsonl \\
      --output_dir out [--codec_checkpoint ckpt.pt] [--val_ratio 0.01] \\
      [--batch_size 8] [--dry_run] [--tiny] [--process_index R --process_count N] \\
      [--device cuda]

``--process_index`` and ``--process_count`` default to the launcher's rank
and world size (torchrun's ``RANK``/``WORLD_SIZE``, SLURM's), as the JAX
tool's default reads ``jax.process_index()``; 0 and 1 without a launcher.
Each process encodes alone: no group is joined.

Without ``--codec_checkpoint`` the encoder has seeded weights and an
all-zero semantic stream (smoke mode), at full width or, with ``--tiny``,
at the tiny test widths.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from tts_max_tpu_torch.core.constants import CODEC_SAMPLE_RATE
from tts_max_tpu_torch.parallel.mesh import launcher_env
from tts_max_tpu_torch.data import codes_io
from tts_max_tpu_torch.data.audio_io import load_wav
from tts_max_tpu_torch.data.filtering import DEFAULT_LOAD_FILTERS, apply_filters
from tts_max_tpu_torch.data.samples import Sample, read_samples_jsonl
from tts_max_tpu_torch.device import resolve_device
from tts_max_tpu_torch.models.codec import api, encoder as enc
from tts_max_tpu_torch.models.codec.encoder import pad_wav_for_encode
from tts_max_tpu_torch.utils.logging import get_logger, setup_logging

log = get_logger("vectorizer")


def build_encoder(codec_checkpoint: str = "", tiny: bool = False, device="cuda",
                  seed: int = 0) -> api.AudioEncoder:
    """The encoder of ``codec_checkpoint`` (with its w2v-bert), or, without
    one, seeded weights (``encoder.init_encoder``) with an all-zero semantic
    stream."""
    if codec_checkpoint:
        return api.create_encoder(codec_checkpoint, device=device)
    dev = resolve_device(device)
    cfg = enc.tiny_encoder_config() if tiny else enc.EncoderConfig()
    params = enc.init_encoder(cfg, seed=seed, device=dev)

    def zero_semantic(wav: np.ndarray) -> torch.Tensor:
        return torch.zeros(wav.shape[0], wav.shape[1] // cfg.hop_length,
                           cfg.semantic_input_dim, device=dev)

    log.warning("No codec checkpoint: encoding with random weights (smoke mode).")
    return api.AudioEncoder(params, cfg, zero_semantic, device=dev)


def encode_samples(encoder: api.AudioEncoder, samples: list[Sample], batch_size: int
                   ) -> tuple[np.ndarray, np.ndarray, list[Sample]]:
    """Encode one process's samples in batches: (codes int32, index int64
    offsets, the samples kept). A batch is zero-padded to the longest wav
    rounded up to whole seconds and each sample trimmed to its own code
    count, the approximation the JAX tool makes; unreadable wavs are
    skipped."""
    hop = encoder._cfg.hop_length
    all_codes: list[np.ndarray] = []
    index: list[int] = []
    kept: list[Sample] = []
    offset = 0
    t0 = time.time()
    batch_wavs: list[np.ndarray] = []
    batch_samples: list[Sample] = []

    def flush():
        nonlocal offset
        if not batch_wavs:
            return
        own = [pad_wav_for_encode(w[None], hop).shape[1] // hop for w in batch_wavs]
        bucket = ((max(len(w) for w in batch_wavs) + 16000) // 16000) * 16000
        padded = np.zeros((len(batch_wavs), bucket), dtype=np.float32)
        for i, w in enumerate(batch_wavs):
            padded[i, : len(w)] = w
        codes = np.asarray(encoder.encode(padded))
        for i, sample in enumerate(batch_samples):
            all_codes.append(codes[i, : own[i]].astype(np.int32))
            index.append(offset)
            offset += own[i]
            kept.append(sample)
        batch_wavs.clear()
        batch_samples.clear()

    for i, sample in enumerate(samples):
        try:
            wav, _ = load_wav(sample.wav_path, CODEC_SAMPLE_RATE)
        except Exception as e:  # unreadable wavs are skipped, as in the JAX tool
            log.warning("Skipping sample [%s] because: %s", sample.wav_path, e)
            continue
        batch_wavs.append(wav[0])
        batch_samples.append(sample)
        if len(batch_wavs) >= batch_size:
            flush()
        if (i + 1) % 100 == 0:
            log.info("Encoded %d/%d samples (%.2f samples/s)", i + 1, len(samples),
                     (i + 1) / (time.time() - t0))
    flush()
    codes_arr = np.concatenate(all_codes) if all_codes else np.zeros(0, dtype=np.int32)
    return codes_arr, np.asarray(index, dtype=np.int64), kept


def main(argv=None) -> dict:
    """Returns {split: (samples kept, codes)} of this process's shards."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--samples_path", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--codec_checkpoint", default="")
    parser.add_argument("--val_ratio", type=float, default=0.01)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--dry_run", action="store_true")
    parser.add_argument("--tiny", action="store_true", help="tiny random codec (tests/smoke)")
    parser.add_argument("--process_index", type=int, default=-1,
                        help="this process's share (default: the launcher's rank, or 0)")
    parser.add_argument("--process_count", type=int, default=-1,
                        help="the number of shares (default: the launcher's world, or 1)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain PyTorch path)")
    args = parser.parse_args(argv)
    launcher = launcher_env()
    rank = (args.process_index if args.process_index >= 0
            else launcher.rank if launcher else 0)
    world = (args.process_count if args.process_count > 0
             else launcher.world_size if launcher else 1)
    setup_logging(rank, silence_nonmain=False)

    samples = read_samples_jsonl(
        args.samples_path, os.path.basename(os.path.dirname(args.samples_path)) or "ds")
    samples = [s for s in samples if not apply_filters(s, DEFAULT_LOAD_FILTERS)]
    if args.dry_run:
        samples = samples[: args.batch_size * world * 50]
    mine = codes_io.chunk_work(samples, rank, world)
    log.info("Process %d/%d encodes %d samples", rank, world, len(mine))

    encoder = build_encoder(args.codec_checkpoint, args.tiny, args.device)
    n_val = max(1, int(len(mine) * args.val_ratio)) if len(mine) > 1 else 0
    splits = {"train": mine[n_val:], "val": mine[:n_val]}
    os.makedirs(args.output_dir, exist_ok=True)
    written = {}
    for split, split_samples in splits.items():
        if not split_samples:
            continue
        codes, index, kept = encode_samples(encoder, split_samples, args.batch_size)
        codes_io.write_shard(args.output_dir, split, codes, index, kept, rank=rank)
        written[split] = (len(kept), len(codes))
        log.info("Saved %s shard %d: %d samples, %d codes", split, rank, len(kept),
                 len(codes))
    return written


if __name__ == "__main__":
    main()
