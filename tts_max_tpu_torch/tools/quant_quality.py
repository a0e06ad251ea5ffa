"""Quantization quality: agreement of weight-only quantized serving weights
with the bf16 model (counterpart of ``tools/quant_quality.py``).

For each mode of ``--modes`` (``models/quantization.quantize_for_serving``)
against the unquantized model:

  - hidden-state SNR (dB) of the last layer's output: smooth and monotonic
    in the per-layer quantization error;
  - top-1 / top-8 agreement: the share of next-token distributions whose
    argmax (top-8 set) matches, over every position of a B x P prefill;
  - logit RMSE over those positions;
  - greedy divergence: the mean step at which a greedy decode of
    ``--steps`` tokens first differs from the unquantized one (``--steps``
    when it never does), and the share of equal tokens. On the card the
    quantized decode's layer products run kernel Q (``ops/quant_matmul.py``).

Random weights are the air-gapped proxy: their logit margins are near zero,
so top-1 and divergence are chaotic lower bounds there and the SNR is the
smooth comparison. ``--fixture`` reads the trained anchor model
(``tests/fixtures/quant_anchor.npz``: decisive margins) and prompts from its
affine-chain language; ``--model_dir`` measures a real HF dir.

  python -m tts_max_tpu_torch.tools.quant_quality [--arch llama-1b] \\
      [--modes int8,int4,int4-g128,int4-g64] [--batch 8] [--prompt 128] \\
      [--steps 64] [--model_dir DIR | --fixture] [--seed 0] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from tts_max_tpu_torch import convert
from tts_max_tpu_torch.device import resolve_device
from tts_max_tpu_torch.inference.generate import make_generate_fn
from tts_max_tpu_torch.models import hf_import, llama, quantization
from tts_max_tpu_torch.ops.sampling import SamplingParams
from tts_max_tpu_torch.training.optim import tree_map

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "fixtures", "quant_anchor.npz")
RANDOM_NOTE = ("NOTE: random-init weights have near-zero logit margins, so top1/div@ are "
               "chaotic lower bounds at >tiny scale; hidden-state SNR is the smooth "
               "cross-mode comparison. Re-run with --model_dir on a real checkpoint for "
               "serving-quality gates.")


@torch.inference_mode()
def agreement(params_q, params_ref, cfg: llama.LlamaConfig, tokens: torch.Tensor,
              top: int = 8) -> tuple[float, float, float, float]:
    """(top-1 agreement, top-k overlap, logit RMSE, hidden-state SNR in dB)
    of ``params_q`` against ``params_ref`` over every position of one
    prefill of ``tokens`` [B, P]; computed on the device, four scalars read
    back."""
    hq = llama.forward_hidden(params_q, cfg, tokens)
    hr = llama.forward_hidden(params_ref, cfg, tokens)
    snr_db = 10.0 * torch.log10((hr.float() ** 2).sum() / ((hq - hr).float() ** 2).sum())
    lq = llama._logits(hq, params_q, cfg)
    lr = llama._logits(hr, params_ref, cfg)
    top1 = (lq.argmax(-1) == lr.argmax(-1)).float().mean()
    kq = torch.topk(lq, top, dim=-1).indices
    kr = torch.topk(lr, top, dim=-1).indices
    overlap = (kq[..., :, None] == kr[..., None, :]).any(-1).float().mean()
    rmse = torch.sqrt(((lq - lr) ** 2).mean())
    return float(top1), float(overlap), float(rmse), float(snr_db)


def greedy_divergence(params_q, params_ref, cfg: llama.LlamaConfig, tokens, lengths,
                      steps: int) -> tuple[float, float]:
    """(mean first step at which the greedy decodes differ, ``steps`` for a
    row that never does; the share of equal tokens)."""
    sp = SamplingParams(temperature=0.0, repetition_penalty=1.0, frequency_penalty=0.0)
    gen = make_generate_fn(cfg, sp, max_new_tokens=steps, eos_id=-1,
                           cache_len=tokens.shape[1] + steps, device=tokens.device)
    tq = gen(params_q, tokens, lengths, None).tokens.cpu().numpy()
    tr = gen(params_ref, tokens, lengths, None).tokens.cpu().numpy()
    same = tq == tr
    first_div = np.where(same.all(-1), steps, np.argmin(same, axis=-1))
    return float(first_div.mean()), float(same.mean())


def load_anchor(device, dtype=torch.float32):
    """The anchor fixture's params and config, read with numpy: kernels and
    the embedding in ``dtype``, norm scales in fp32 as the port keeps them
    (the JAX loader casts those to ``dtype`` too)."""
    data = np.load(FIXTURE, allow_pickle=False)
    cfg = llama.LlamaConfig(**json.loads(str(data["__config"])), dtype=dtype)
    tree: dict = {}
    for key in data.files:
        if key.startswith("__"):
            continue
        *parts, leaf = key.split("/")
        node = tree
        for p in parts:
            node = node.setdefault(p, {})
        node[leaf] = data[key]
    return convert.llama_from_numpy(tree, cfg, device=device), cfg


def make_anchor_prompts(batch: int, length: int, vocab_size: int, seed: int = 0):
    """Prompts from the fixture's trained language (affine chains), so the
    next-token margins are decisive (``tests/fixtures/load_quant_anchor``'s
    recipe)."""
    rng = np.random.default_rng(seed)
    toks = np.zeros((batch, length), dtype=np.int32)
    for i in range(batch):
        a, b = ((5, 17), (11, 101))[i % 2]
        toks[i, 0] = (i % 2) + 1
        t = int(rng.integers(3, vocab_size))
        for j in range(1, length):
            toks[i, j] = t
            t = (a * t + b) % (vocab_size - 3) + 3
    return toks


def main(argv=None) -> list[dict]:
    """Prints one row a mode and returns them as dicts."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-1b")
    ap.add_argument("--modes", default="int8,int4,int4-g128,int4-g64")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=128)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--model_dir", default="",
                    help="a real checkpoint (HF dir) instead of random init")
    ap.add_argument("--fixture", action="store_true",
                    help="the trained anchor fixture (tests/fixtures/quant_anchor.npz)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dtype = torch.bfloat16  # the unquantized reference, as in the JAX tool

    if args.fixture:
        params, cfg = load_anchor(device, dtype)
        args.arch = "anchor-fixture"
    elif args.model_dir:
        params, cfg = hf_import.load_model_from_hf_dir(args.model_dir, device=device,
                                                       dtype=dtype)
    else:
        cfg = dataclasses.replace(
            llama.config_for_architecture(args.arch, max_seq_len=args.prompt + args.steps),
            dtype=dtype)
        params = llama.init_params(cfg, seed=args.seed, device=device)

    if args.fixture:
        toks = make_anchor_prompts(args.batch, args.prompt, cfg.vocab_size, args.seed)
    else:
        toks = np.random.default_rng(args.seed).integers(
            3, cfg.vocab_size, (args.batch, args.prompt)).astype(np.int32)
    tokens = torch.from_numpy(toks).to(device)
    lengths = torch.full((args.batch,), args.prompt, dtype=torch.int32, device=device)

    kind = "anchor fixture" if args.fixture else "real ckpt" if args.model_dir else "random init"
    print(f"quant_quality {args.arch} ({kind}), {args.batch}x{args.prompt} prompts, "
          f"{args.steps} greedy steps", flush=True)
    if not args.model_dir and not args.fixture:
        print(RANDOM_NOTE, flush=True)
    print(f"{'mode':>10}  {'snr_db':>7}  {'top1':>6}  {'top8':>6}  {'rmse':>7}  "
          f"{'div@':>6}  {'tok=':>6}")
    rows = []
    for mode in args.modes.split(","):
        # quantize_for_serving replaces the leaves of the dicts it is given
        qp = quantization.quantize_for_serving(tree_map(lambda t: t, params), mode)
        t1, t8, rmse, snr = agreement(qp, params, cfg, tokens)
        div, match = greedy_divergence(qp, params, cfg, tokens, lengths, args.steps)
        del qp
        rows.append(dict(mode=mode, snr_db=snr, top1=t1, top8=t8, rmse=rmse, div=div,
                         match=match))
        print(f"{mode:>10}  {snr:7.2f}  {t1:6.3f}  {t8:6.3f}  {rmse:7.4f}  {div:6.1f}  "
              f"{match:6.3f}", flush=True)
    return rows


if __name__ == "__main__":
    main()
