"""The plain reference: a Llama-architecture decoder (SmolLM2, Mistral and
Llama share its equations) in float32 PyTorch, with TF32 off, written from
the published description: RMSNorm, half-split rotary embeddings (the HF
convention), grouped-query causal softmax attention, a SiLU-gated MLP, a
tied or untied output head, shifted cross entropy, global-norm clipping and
optax's AdamW.

It imports torch only: nothing of the program, nothing of JAX. It takes the
configuration file's published keys and the benchmark's weight tree (dense
kernels ``[in, out]``, layers stacked on a leading axis, the layout the
benchmark hands to both sides) and works everything else out itself. It
runs layer by layer, each layer's weights raised to float32 as it comes,
and attention in blocks of queries, so that it fits beside nothing else on
the card.

``fp8=True`` is the control: every matrix product takes its two inputs
rounded to float8 e4m3 (one scale per row of the activations, one per
output column of the weights), the precision below the configuration's
bfloat16 that a later change would be tempted to serve in.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

E4M3_MAX = 448.0


def full_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Spec:
    """The shapes of a configuration file (published ``config.json`` keys)."""

    def __init__(self, conf: dict):
        self.dim = conf["hidden_size"]
        self.layers = conf["num_hidden_layers"]
        self.heads = conf["num_attention_heads"]
        self.kv_heads = conf["num_key_value_heads"]
        self.head_dim = conf.get("head_dim") or self.dim // self.heads
        self.eps = conf["rms_norm_eps"]
        self.theta = float(conf["rope_theta"])
        self.tied = conf["tie_word_embeddings"]
        self.vocab = conf["vocab_size"]
        if conf.get("rope_scaling"):
            raise ValueError("the reference computes unscaled rotary embeddings only")


def fake_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def mm(x: torch.Tensor, w: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    """x [..., in] @ w [in, out] in float32."""
    if fp8:
        x = x + (fake_fp8(x, -1) - x).detach()
        w = w + (fake_fp8(w, 0) - w).detach()
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope_tables(head_dim: int, n: int, theta: float, device):
    inv = 1.0 / theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)
    ang = np.outer(np.arange(n, dtype=np.float64), inv)
    return (torch.tensor(np.cos(ang), dtype=torch.float32, device=device),
            torch.tensor(np.sin(ang), dtype=torch.float32, device=device))


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, D]: rotate (x1, x2) halves by each position's angles."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(q, k, v, block: int = 512) -> torch.Tensor:
    """Causal softmax attention of q [B, S, Hq, D] over k, v [B, S, Hkv, D],
    query blocks at a time; each kv head serves Hq / Hkv query heads."""
    b, s, hq, d = q.shape
    rep = hq // k.shape[2]
    k = k.repeat_interleave(rep, dim=2).transpose(1, 2)  # [B, Hq, S, D]
    v = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    q = q.transpose(1, 2) * d ** -0.5
    out = []
    keys = torch.arange(s, device=q.device)
    for a in range(0, s, block):
        z = min(s, a + block)
        scores = q[:, :, a:z] @ k[:, :, :z].transpose(-1, -2)
        mask = keys[None, :z] > torch.arange(a, z, device=q.device)[:, None]
        probs = torch.softmax(scores.masked_fill(mask, float("-inf")), dim=-1)
        out.append(probs @ v[:, :, :z])
    return torch.cat(out, dim=2).transpose(1, 2)


def layer_weights(weights: dict, i: int) -> dict:
    """Layer i's weights, raised to float32."""
    lw = weights["layers"]
    return {
        "attn_norm": lw["attn_norm"]["scale"][i].float(),
        "mlp_norm": lw["mlp_norm"]["scale"][i].float(),
        **{n: lw["attn"][n]["kernel"][i].float() for n in ("wq", "wk", "wv", "wo")},
        **{n: lw["mlp"][n]["kernel"][i].float() for n in ("w_gate", "w_up", "w_down")},
    }


def decoder_layer(h, w: dict, spec: Spec, cos, sin, fp8: bool = False):
    """h [B, S, D] through one layer."""
    b, s, _ = h.shape
    x = rms_norm(h, w["attn_norm"], spec.eps)
    q = mm(x, w["wq"], fp8).view(b, s, spec.heads, spec.head_dim)
    k = mm(x, w["wk"], fp8).view(b, s, spec.kv_heads, spec.head_dim)
    v = mm(x, w["wv"], fp8).view(b, s, spec.kv_heads, spec.head_dim)
    o = attention(rope(q, cos, sin), rope(k, cos, sin), v)
    h = h + mm(o.reshape(b, s, -1), w["wo"], fp8)
    x = rms_norm(h, w["mlp_norm"], spec.eps)
    return h + mm(F.silu(mm(x, w["w_gate"], fp8)) * mm(x, w["w_up"], fp8), w["w_down"], fp8)


def head_rows(weights: dict, spec: Spec, lo: int, size: int) -> torch.Tensor:
    """The output head's columns [lo, lo + size) as a float32 [D, size]."""
    if spec.tied:
        return weights["embed"]["embedding"][lo:lo + size].float().t()
    return weights["lm_head"]["kernel"][:, lo:lo + size].float()


@torch.no_grad()
def next_token_logits(weights: dict, conf: dict, tokens: torch.Tensor, positions,
                      window: tuple[int, int], fp8: bool = False) -> torch.Tensor:
    """float32 logits over ids [lo, lo + size) of the token after each of
    ``positions`` in the sequence ``tokens`` [S] (every later position is
    masked by causality, so one pass serves them all)."""
    full_fp32()
    spec = Spec(conf)
    s = tokens.shape[0]
    cos, sin = rope_tables(spec.head_dim, s, spec.theta, tokens.device)
    h = weights["embed"]["embedding"][tokens.long()].float()[None]
    for i in range(spec.layers):
        h = decoder_layer(h, layer_weights(weights, i), spec, cos, sin, fp8)
    idx = torch.as_tensor(positions, device=tokens.device).long()
    x = rms_norm(h[0, idx], weights["norm"]["scale"].float(), spec.eps)
    return mm(x, head_rows(weights, spec, *window), fp8)


# --- training -------------------------------------------------------------------------


def leaves_of(weights: dict, spec: Spec) -> dict[str, torch.Tensor]:
    """The benchmark's weight tree as the reference's leaves (views)."""
    lw = weights["layers"]
    out = {"embed": weights["embed"]["embedding"], "norm": weights["norm"]["scale"]}
    if not spec.tied:
        out["lm_head"] = weights["lm_head"]["kernel"]
    for i in range(spec.layers):
        for n in ("attn_norm", "mlp_norm"):
            out[f"layers/{i}/{n}"] = lw[n]["scale"][i]
        for blk, names in (("attn", ("wq", "wk", "wv", "wo")), ("mlp", ("w_gate", "w_up", "w_down"))):
            for n in names:
                out[f"layers/{i}/{n}"] = lw[blk][n]["kernel"][i]
    return out


def _layer_of(p: dict, i: int) -> dict:
    return {n: p[f"layers/{i}/{n}"] for n in
            ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")}


def _chunk_nll(x, head, targets, fp8):
    logits = mm(x, head, fp8)
    nll = torch.logsumexp(logits, -1) - logits.gather(-1, targets.clamp_min(0)[..., None])[..., 0]
    return torch.where(targets >= 0, nll, 0.0).sum()


def loss(p: dict, spec: Spec, input_ids: torch.Tensor, labels: torch.Tensor,
         fp8: bool = False, chunk: int = 256) -> torch.Tensor:
    """Mean shifted cross entropy over labels that are not -100, each layer
    and each chunk of positions under a checkpoint."""
    b, s = input_ids.shape
    cos, sin = rope_tables(spec.head_dim, s, spec.theta, input_ids.device)
    h = p["embed"][input_ids.long()]
    for i in range(spec.layers):
        h = checkpoint(decoder_layer, h, _layer_of(p, i), spec, cos, sin, fp8,
                       use_reentrant=False)
    x = rms_norm(h[:, :-1], p["norm"], spec.eps)
    targets = labels[:, 1:].long()
    targets = torch.where(targets == -100, -1, targets)
    head = p["embed"].t() if spec.tied else p["lm_head"]
    total = x.new_zeros(())
    for a in range(0, s - 1, chunk):
        total = total + checkpoint(_chunk_nll, x[:, a:a + chunk], head,
                                   targets[:, a:a + chunk], fp8, use_reentrant=False)
    return total / (targets >= 0).sum().clamp_min(1)


def train(weights: dict, conf: dict, batches, *, lr: float, betas=(0.9, 0.95),
          weight_decay: float = 0.1, eps: float = 1e-8, clip: float = 1.0,
          fp8: bool = False) -> dict:
    """Steps of AdamW (optax's: bias-corrected moments, decay added to the
    update, on every leaf) on float32 copies of ``weights`` over
    ``batches`` [(input_ids, labels)], each after clipping to the global
    norm ``clip``. Returns each step's loss, each leaf's norm of the first
    step's clipped gradient, and of its change over all the steps."""
    full_fp32()
    spec = Spec(conf)
    start = leaves_of(weights, spec)
    p = {k: v.detach().float().clone().requires_grad_(True) for k, v in start.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2 = betas
    losses, first_grad = [], None
    for t, (ids, labels) in enumerate(batches, start=1):
        value = loss(p, spec, ids, labels, fp8)
        grads = torch.autograd.grad(value, list(p.values()))
        losses.append(float(value.detach()))
        with torch.no_grad():
            gnorm = math.sqrt(sum(float(g.square().sum()) for g in grads))
            scale = clip / gnorm if gnorm > clip else 1.0
            if first_grad is None:
                first_grad = {k: float(g.norm()) * scale for k, g in zip(p, grads)}
            for (k, v), g in zip(p.items(), grads):
                g = g * scale
                mu[k].mul_(b1).add_(g, alpha=1 - b1)
                nu[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                u = (mu[k] / (1 - b1 ** t)) / ((nu[k] / (1 - b2 ** t)).sqrt() + eps)
                v.sub_(lr * (u + weight_decay * v))
        del grads
    with torch.no_grad():
        change = {k: float((v - start[k].float()).norm()) for k, v in p.items()}
    return {"losses": losses, "grad_norm": first_grad, "change_norm": change}
