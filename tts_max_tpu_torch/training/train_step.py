"""The SpeechLM training step (counterpart of ``tts_max_tpu/training/train_step.py``).

One call runs every gradient-accumulation micro-step, global-norm clipping
with a non-finite guard, and the AdamW update, on one device. The JAX
package's jitted, sharded step (``make_train_step``, ``data_sh_axis1``,
``_opt_state_shardings``) waits for multi-device training (ROADMAP.md,
queue 1 item 4).

The non-finite guard is JAX's: a non-finite global grad norm zeroes the
grads and the updates, so the parameters stay exactly unchanged while the
moments decay one step, and the step reports ``nonfinite=1`` for the loop
to checkpoint and stop.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tts_max_tpu_torch.core.constants import LOSS_IGNORE_TOKEN_ID
from tts_max_tpu_torch.models import llama
from tts_max_tpu_torch.training.optim import AdamW, apply_updates, global_norm, tree_map


class StepMetrics(NamedTuple):
    loss: float  # mean loss over micro-steps
    grad_norm: float
    nonfinite: float  # 1.0 if the update was skipped
    tokens: int  # number of loss tokens


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor):
    """HF-convention shifted cross entropy: logits[:, :-1] predict
    labels[:, 1:]; -100 positions are ignored; mean over valid tokens.
    Returns (loss, number of valid tokens)."""
    logits = logits[:, :-1]
    targets = labels[:, 1:].long()
    valid = targets != LOSS_IGNORE_TOKEN_ID
    safe = torch.where(valid, targets, 0)
    logprobs = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logprobs, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    n = valid.sum()
    return nll.sum() / n.clamp_min(1), n


def _chunk_nll(hc, tc, params, cfg):
    logits = llama._logits(hc, params, cfg)  # fp32 [B, C, V]
    valid = tc != LOSS_IGNORE_TOKEN_ID
    safe = torch.where(valid, tc, 0)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, safe[..., None])[..., 0]
    return torch.where(valid, lse - tgt, 0.0).sum(), valid.sum()


def chunked_causal_lm_loss(params, cfg: llama.LlamaConfig, hidden: torch.Tensor,
                           labels: torch.Tensor, chunk_size: int):
    """Blockwise cross entropy over the 193856-token head.

    The sequence is cut into ``chunk_size``-token chunks; each computes its
    fp32 logits [B, C, V] and reduces them at once to ``logsumexp -
    target_logit``, under ``torch.utils.checkpoint`` so the backward pass
    recomputes a chunk's logits instead of storing them: one chunk's
    logits are live at a time. The same value as :func:`causal_lm_loss`."""
    h = hidden[:, :-1]
    t = labels[:, 1:].long()
    T = h.shape[1]
    C = min(chunk_size, T)
    nll_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    n_valid = torch.zeros((), dtype=torch.int64, device=h.device)
    for c0 in range(0, T, C):
        s, k = checkpoint(_chunk_nll, h[:, c0:c0 + C], t[:, c0:c0 + C], params, cfg,
                          use_reentrant=False)
        nll_sum = nll_sum + s
        n_valid = n_valid + k
    return nll_sum / n_valid.clamp_min(1), n_valid


def loss_fn(params, cfg: llama.LlamaConfig, batch, loss_chunk_size: int = 0):
    if loss_chunk_size > 0:
        hidden = llama.forward_hidden(params, cfg, batch["input_ids"])
        return chunked_causal_lm_loss(params, cfg, hidden, batch["labels"], loss_chunk_size)
    logits = llama.forward(params, cfg, batch["input_ids"])
    return causal_lm_loss(logits, batch["labels"])


def to_device_batch(batch, device) -> dict:
    """numpy or torch arrays -> int64 tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
            .to(device=device, dtype=torch.int64) for k, v in batch.items()}


def _loss_and_grads(params, cfg, batch, loss_chunk_size):
    """(loss, valid tokens, grads in the params' dtypes) of one micro-batch."""
    leaves = []

    def track(p):
        q = p.detach().requires_grad_(True)
        leaves.append(q)
        return q

    live = tree_map(track, params)
    with torch.enable_grad():
        loss, toks = loss_fn(live, cfg, batch, loss_chunk_size)
        grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return loss.detach(), toks, tree_map(lambda _: next(it), params)


def train_step(params, opt_state, batch, *, cfg: llama.LlamaConfig, tx: AdamW,
               gradient_clip_value: float = 1.0, loss_chunk_size: int = 0):
    """One optimizer step over a macro-batch.

    batch: {"input_ids": [A, B, L], "labels": [A, B, L]} (numpy or tensors)
    with A gradient-accumulation micro-steps. For A > 1 the grads are summed
    in fp32 and divided by A, as JAX's fp32 ``zero_grads`` carry does.
    Returns (new_params, new_opt_state, StepMetrics); ``params`` is not
    modified."""
    batch = to_device_batch(batch, llama.params_device(params))
    accum = batch["input_ids"].shape[0]
    if accum == 1:
        loss, toks, grads = _loss_and_grads(
            params, cfg, {k: v[0] for k, v in batch.items()}, loss_chunk_size)
    else:
        grads, loss_sum, toks = None, torch.zeros(()), 0
        for a in range(accum):
            mloss, mtoks, g = _loss_and_grads(
                params, cfg, {k: v[a] for k, v in batch.items()}, loss_chunk_size)
            grads = (tree_map(lambda x: x.float(), g) if grads is None
                     else tree_map(torch.add, grads, g))
            loss_sum = loss_sum + mloss.cpu()
            toks = toks + mtoks
        grads = tree_map(lambda x: x / accum, grads)
        loss = loss_sum / accum

    with torch.no_grad():
        gnorm = global_norm(grads)
        finite = bool(torch.isfinite(gnorm))
        if finite:
            if float(gnorm) > gradient_clip_value:
                scale = gradient_clip_value / gnorm
                grads = tree_map(lambda g: g * scale, grads)
        else:
            grads = tree_map(torch.zeros_like, grads)
        updates, new_state = tx.update(grads, opt_state, params)
        new_params = apply_updates(params, updates) if finite else params
    metrics = StepMetrics(loss=float(loss), grad_norm=float(gnorm),
                          nonfinite=0.0 if finite else 1.0, tokens=int(toks))
    return new_params, new_state, metrics


def eval_step(params, batch, *, cfg: llama.LlamaConfig, loss_chunk_size: int = 0):
    """(loss, valid tokens) on one eval micro-batch [B, L]."""
    batch = to_device_batch(batch, llama.params_device(params))
    with torch.no_grad():
        loss, toks = loss_fn(params, cfg, batch, loss_chunk_size)
    return float(loss), int(toks)
