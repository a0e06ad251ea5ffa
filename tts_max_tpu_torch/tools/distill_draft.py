"""Distill a shallow draft SpeechLM from a target for speculative decoding
(counterpart of ``tools/distill_draft.py``).

The draft starts as the target's first ``--draft_layers`` layers
(``training/distill.truncated_draft``) and is trained to match the target's
token distribution (blockwise forward KL) on a vectorized TTS dataset; it is
written as an HF dir that serving loads beside the target
(``speculative_generate(target, ..., draft, ...)``).

  python -m tts_max_tpu_torch.tools.distill_draft --dataset_dir ds \\
      --output_dir draft [--model_dir serving | --architecture llama-3.2-1b] \\
      [--draft_layers 4] [--steps 2000] [--batch 8] [--seq 512] [--lr 3e-4] \\
      [--chunk 256] [--device cuda]

The target is an HF dir (``--model_dir``, read through ``hf_import`` in
bf16), or seeded random bf16 weights of ``--architecture`` (smoke mode).
The tokenizer is the dir's own (``tokenizer.json``, extended with the
speech vocabulary and no padding ids) where it has one, else the byte
tokenizer: serving dirs may carry no tokenizer files. Batches are
drawn with ``np.random.default_rng(--seed)`` as in the JAX tool. The
optimizer is ``optax.adamw(lr, b1=0.9, b2=0.95, weight_decay=0.01,
mu_dtype=bf16)``: ``training/optim.AdamW`` has its eps (1e-8) and decays
every leaf, as optax without a mask does.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from tts_max_tpu_torch.core.config import DatasetConfig
from tts_max_tpu_torch.core.tokenization import build_byte_tokenizer, build_tokenizer
from tts_max_tpu_torch.data import codes_io
from tts_max_tpu_torch.data.datasets import TtsFineTuningDataset
from tts_max_tpu_torch.device import resolve_device, to_device_async
from tts_max_tpu_torch.models import hf_import, llama
from tts_max_tpu_torch.training import distill
from tts_max_tpu_torch.training.optim import AdamW
from tts_max_tpu_torch.utils.logging import get_logger, setup_logging

log = get_logger("distill_draft")

class DistillResult(NamedTuple):
    """Every step's KL and grad norm (read once, after the loop); the host
    seconds of step 1 (to its logged read) and of steps 2.. (to that read
    after the loop); the padded and the real (mask) tokens of each step;
    and the draft's config."""

    kl: list
    grad_norm: list
    first_seconds: float
    rest_seconds: float
    tokens_per_step: int
    real_tokens: list
    draft_cfg: llama.LlamaConfig


def main(argv=None) -> DistillResult:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_dir", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--model_dir", default="", help="target HF dir; empty = random init")
    parser.add_argument("--architecture", default="llama-tiny")
    parser.add_argument("--draft_layers", type=int, default=4)
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seq", type=int, default=512)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--chunk", type=int, default=256)
    parser.add_argument("--log_steps", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain PyTorch path)")
    args = parser.parse_args(argv)
    setup_logging(0)
    device = resolve_device(args.device)
    dtype = torch.bfloat16

    tokenizer = build_byte_tokenizer()
    if args.model_dir and os.path.isfile(os.path.join(args.model_dir, "tokenizer.json")):
        # a malformed or unsupported tokenizer.json raises: no silent byte ids
        tokenizer = build_tokenizer(args.model_dir, expected_vocab_size=None)
    if args.model_dir and os.path.isdir(args.model_dir):
        params, cfg = hf_import.load_model_from_hf_dir(args.model_dir, device=device,
                                                       dtype=dtype)
    else:
        cfg = dataclasses.replace(
            llama.config_for_architecture(args.architecture, vocab_size=len(tokenizer)),
            dtype=dtype)
        params = llama.init_params(cfg, seed=args.seed, device=device)
        log.warning("No --model_dir: distilling against a RANDOM target (recipe smoke mode).")
    cfg = dataclasses.replace(cfg, max_seq_len=args.seq)

    codes, samples, spans, _ = codes_io.load_and_filter_audio_codes_and_samples(
        args.dataset_dir, "train", DatasetConfig())
    ds = TtsFineTuningDataset(os.path.basename(args.dataset_dir), samples, codes, spans,
                              tokenizer, max_seq_len=args.seq)
    log.info("Distillation dataset: %d samples", len(ds))
    pad_id = tokenizer.pad_token_id or 0

    def to_device(a: np.ndarray) -> torch.Tensor:
        return to_device_async(torch.from_numpy(a), device)

    def make_batch(rng):
        idxs = rng.integers(0, len(ds), args.batch)
        toks = np.full((args.batch, args.seq), pad_id, np.int32)
        mask = np.zeros((args.batch, args.seq), bool)
        for r, i in enumerate(idxs):
            ids = ds[int(i)]["input_ids"][: args.seq]
            toks[r, : len(ids)] = ids
            mask[r, : len(ids)] = True
        return to_device(toks), to_device(mask), int(mask.sum())

    draft, draft_cfg = distill.truncated_draft(params, cfg, args.draft_layers)
    tx = AdamW(args.lr, betas=(0.9, 0.95), weight_decay=0.01, mu_dtype="bf16")
    opt_state = tx.init(draft)
    step_fn = distill.make_distill_step(draft_cfg, cfg, tx, chunk_size=args.chunk)

    rng = np.random.default_rng(args.seed)
    kls, norms, real = [], [], []  # the step's outputs stay on the device until logged
    t0 = t1 = time.perf_counter()
    for step in range(1, args.steps + 1):
        toks, mask, n_real = make_batch(rng)
        draft, opt_state, loss, gnorm = step_fn(draft, params, opt_state, toks, mask)
        kls.append(loss)
        norms.append(gnorm)
        real.append(n_real)
        if step % args.log_steps == 0 or step == 1:
            log.info("step %d: kl %.4f grad_norm %.2f (%.0f tok/s)", step, float(loss),
                     float(gnorm), step * args.batch * args.seq / (time.perf_counter() - t0))
        if step == 1:
            t1 = time.perf_counter()
    kls, norms = torch.stack(kls).tolist(), torch.stack(norms).tolist()
    t_end = time.perf_counter()

    os.makedirs(args.output_dir, exist_ok=True)
    hf_import.save_model_to_hf_dir(draft, draft_cfg, args.output_dir)  # fp32, as JAX writes
    log.info("Draft (%d layers) written to %s: serve it with speculative_generate(target, "
             "draft, ...)", args.draft_layers, args.output_dir)
    return DistillResult(kls, norms, t1 - t0, t_end - t1, args.batch * args.seq, real,
                         draft_cfg)


if __name__ == "__main__":
    main()
