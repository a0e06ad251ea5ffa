"""Draft-model distillation for speculative decoding (counterpart of
``tts_max_tpu/training/distill.py``).

Speculative decoding (``inference/speculative.py``) is exact for any draft,
but pays off only when the draft's proposals are accepted often enough. This
module makes such a draft:

- ``truncated_draft``: the target's first N layers with its embedding, final
  norm and head, every leaf copied (the standard shallow-draft init);
- ``distill_loss`` / ``make_distill_step``: train the draft to match the
  target's token distribution (forward KL, blockwise over the 193856-token
  head so no [B, S, V] tensor lives, as ``train_step.chunked_causal_lm_loss``
  does) on the TTS dataset the target serves.

The target runs under ``torch.no_grad``: its forward then launches kernel A
without the training outputs (the log-sum-exp and O's residual) and keeps no
graph; XLA drops that work by dead-code elimination, autograd would not. The
draft stays vocabulary-compatible by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tts_max_tpu_torch.models import llama
from tts_max_tpu_torch.training.optim import AdamW, apply_updates, global_norm, tree_map


def truncated_draft(params: Any, cfg: llama.LlamaConfig, n_layers: int
                    ) -> tuple[Any, llama.LlamaConfig]:
    """The draft: the target's first ``n_layers`` stacked layers, and its
    embedding, final norm and head; every leaf cloned, so the draft trains
    apart from the frozen target."""
    if not 0 < n_layers <= cfg.n_layers:
        raise ValueError(f"n_layers {n_layers} not in (0, {cfg.n_layers}]")
    draft = dict(params)
    draft["layers"] = tree_map(lambda x: x[:n_layers], params["layers"])
    return tree_map(lambda t: t.detach().clone(), draft), dataclasses.replace(
        cfg, n_layers=n_layers)


def _chunk_kl(thc, dhc, mc, target_params, draft_params, target_cfg, draft_cfg,
              temperature):
    """Sum over the real positions of one chunk of KL(target || draft)."""
    tlp = F.log_softmax(llama._logits(thc, target_params, target_cfg) / temperature, dim=-1)
    dlp = F.log_softmax(llama._logits(dhc, draft_params, draft_cfg) / temperature, dim=-1)
    kl = (tlp.exp() * (tlp - dlp)).sum(-1)  # [B, C]
    return torch.where(mc, kl, 0.0).sum()


def distill_loss(draft_params, target_params, tokens: torch.Tensor, mask: torch.Tensor, *,
                 draft_cfg: llama.LlamaConfig, target_cfg: llama.LlamaConfig,
                 chunk_size: int = 256, temperature: float = 1.0) -> torch.Tensor:
    """Mean forward KL(target || draft) per real next-token position.

    tokens [B, S] int, mask [B, S] bool (True on real positions). The head
    runs in ``chunk_size``-position chunks, each under
    ``torch.utils.checkpoint`` (the counterpart of ``jax.checkpoint``), so
    the backward pass recomputes a chunk's logits instead of storing them."""
    with torch.no_grad():
        th = llama.forward_hidden(target_params, target_cfg, tokens)[:, :-1]
    dh = llama.forward_hidden(draft_params, draft_cfg, tokens)[:, :-1]
    m = mask[:, 1:]
    n_t = th.shape[1]
    c = min(chunk_size, n_t)
    total = torch.zeros((), dtype=torch.float32, device=th.device)
    for c0 in range(0, n_t, c):
        total = total + checkpoint(
            _chunk_kl, th[:, c0:c0 + c], dh[:, c0:c0 + c], m[:, c0:c0 + c], target_params,
            draft_params, target_cfg, draft_cfg, temperature, use_reentrant=False)
    return total / m.sum().clamp_min(1)


def make_distill_step(draft_cfg: llama.LlamaConfig, target_cfg: llama.LlamaConfig,
                      tx: AdamW, chunk_size: int = 256, grad_clip: float = 1.0,
                      temperature: float = 1.0):
    """``step(draft_params, target_params, opt_state, tokens, mask) ->
    (draft_params, opt_state, loss, grad_norm)``, the last two 0-d tensors
    on the device (nothing is read back). KL gradients with respect to the
    draft only. JAX's clip rule: the grads are scaled by clip / norm only
    when the global norm is finite and above the clip, so non-finite grads
    pass through unscaled; they are scaled in fp32, as JAX's bf16 grads
    times an fp32 scale are."""

    def step(draft_params, target_params, opt_state, tokens, mask):
        device = llama.params_device(draft_params)
        tokens = torch.as_tensor(np.asarray(tokens) if not torch.is_tensor(tokens)
                                 else tokens).to(device=device, dtype=torch.int64)
        mask = torch.as_tensor(np.asarray(mask) if not torch.is_tensor(mask)
                               else mask).to(device=device, dtype=torch.bool)
        leaves = []

        def track(p):
            q = p.detach().requires_grad_(True)
            leaves.append(q)
            return q

        live = tree_map(track, draft_params)
        with torch.enable_grad():
            loss = distill_loss(live, target_params, tokens, mask, draft_cfg=draft_cfg,
                                target_cfg=target_cfg, chunk_size=chunk_size,
                                temperature=temperature)
            grads = torch.autograd.grad(loss, leaves)
        del live, leaves
        it = iter(grads)
        grads = tree_map(lambda _: next(it), draft_params)
        with torch.no_grad():
            gnorm = global_norm(grads)
            scale = torch.where(torch.isfinite(gnorm) & (gnorm > grad_clip),
                                grad_clip / gnorm, torch.ones_like(gnorm))
            grads = tree_map(lambda g: g.float() * scale, grads)
            updates, opt_state = tx.update(grads, opt_state, draft_params)
            draft_params = apply_updates(draft_params, updates)
        return draft_params, opt_state, loss.detach(), gnorm

    return step
