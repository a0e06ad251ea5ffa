"""Plain PyTorch attention (counterpart of ``tts_max_tpu/ops/attention.py``).

These are the plain versions of the CUDA kernels — the CPU path of their
wrappers and the reference ``chip_smoke.py`` holds the kernels against on
the card — plus two attentions the JAX package leaves to XLA and the port
leaves to plain ops on every device: the non-causal attention of the Vocos
backbone and ``window_attention`` (the prefix-cache suffix prefill).

Layouts match the JAX package: [B, S, H, D] for attention, [B, T, Hkv, D]
for a cache, with an int8 cache as ``{"q": int8 [B, T, Hkv, D],
"scale": f32 [B, T, Hkv]}``.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30

# How far a kernel's output may lie from its plain version here, as
# (rtol, atol) in |out - ref| <= atol + rtol * |ref|. Both compute in fp32
# and round once to q's dtype. In fp32 they differ by sum order and expf
# only. In bf16 the two fp32 results may round one bf16 ulp apart, and one
# ulp is at most 2^-7 |ref|. A dropped or repeated cache row moves the
# output by far more than that.
KERNEL_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -7, 1e-5)}

# How far the backward kernel's gradients (dq, dk, dv) may lie from their
# plain version, as (rtol, atol) in |g - ref| <= rtol |ref| + atol max|ref|
# (``grad_tol_ratio``), the max over the whole tensor. Unlike a forward
# output, a gradient element is a sum with cancellation: dk and dv add up to
# S query rows, and with GQA the n_rep heads of a group, so a different sum
# order moves an element by ~2^-24 times the sum of its terms' magnitudes,
# which is set by the tensor's scale, not by the element; hence the atol
# relative to max|ref|. In fp32 the kernel recomputes the probabilities from
# kernel A's log-sum-exp and sums in tiles: rtol 1e-4, atol 1e-5 of the max.
# In bf16 both versions round each grad once (one bf16 ulp, at most 2^-7
# |ref|), and the kernel rounds P and dS once to bf16 where they enter the
# tensor cores (2^-9 relative per term), which moves a grad element by up
# to 2^-9 of the sum of its terms' magnitudes; that error scales with the
# tensor, so atol is 2^-8 of the max. (D = sum(dO * O) must come from the
# unrounded O: from O rounded to bf16, dS = P (dP - D) cancels into errors
# beyond this atol under a sharp softmax; tests/test_torch_tc_numerics.py.)
# A dropped key row (its dk, dv rows zero) or a dropped query row (the last
# key's dv is that row's alone) moves an element by about its own size.
GRAD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2.0 ** -7, 2.0 ** -8)}


def grad_tol_ratio(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| / (rtol |ref| + atol max|ref|) under ``GRAD_TOL`` of
    ref's dtype: at most 1 where the gradients agree. Non-finite values give
    inf."""
    rtol, atol = GRAD_TOL[ref.dtype]
    o, r = out.float(), ref.float()
    if not bool(torch.isfinite(o).all()):
        return float("inf")
    limit = rtol * r.abs() + atol * r.abs().max().clamp_min(1e-30)
    return float(((o - r).abs() / limit).max())


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, n_kv, D] -> [B, S, n_kv * n_rep, D] for GQA."""
    return x if n_rep == 1 else x.repeat_interleave(n_rep, dim=2)


def causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    kv_len: int | None = None,
) -> torch.Tensor:
    """Plain version of kernel A (JAX ``pallas_attention.flash_attention``).

    q: [B, S, Hq, D]; k, v: [B, S, Hkv, D] with query head h reading kv head
    h // (Hq/Hkv). Keys at positions >= ``kv_len`` (default S) are masked,
    and with ``causal`` keys after the query. The arithmetic is the flash
    kernel's: inputs upcast to fp32, scores, softmax and the weighted sum in
    fp32, the output rounded once to q's dtype.
    """
    s, d = q.shape[1], q.shape[3]
    kv_len = s if kv_len is None else kv_len
    n_rep = q.shape[2] // k.shape[2]
    qf = q.float() * (d ** -0.5)
    kf = repeat_kv(k, n_rep).float()
    vf = repeat_kv(v, n_rep).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    pos = torch.arange(s, device=q.device)
    valid = (pos < kv_len)[None, :]
    if causal:
        valid = valid & (pos[None, :] <= pos[:, None])
    logits = logits.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)


def causal_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    *,
    causal: bool = True,
    kv_len: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of kernel A's backward (the JAX package's
    ``pallas_attention._bwd``): dq, dk, dv of ``causal_attention`` for the
    output cotangent g [B, S, Hq, D], each in its input's dtype.

    The ``kv_len`` rule is JAX's: q, k, v and g are cut to their first
    ``kv_len`` rows, differentiated there, and padded back with zeros. So
    query rows at or past ``kv_len`` get dq = 0 and add nothing to dk and
    dv, although their forward outputs are not zero; plain autograd over
    the whole sequence would count them. The arithmetic is torch autograd
    through ``causal_attention``'s fp32 math, rounded once to each input's
    dtype.
    """
    s = q.shape[1]
    n = s if kv_len is None else kv_len
    with torch.enable_grad():
        qs, ks, vs = (x[:, :n].detach().requires_grad_(True) for x in (q, k, v))
        out = causal_attention(qs, ks, vs, causal=causal)
        dq, dk, dv = torch.autograd.grad(out, (qs, ks, vs), g[:, :n].to(out.dtype))

    def repad(x):
        return x if n == s else torch.nn.functional.pad(x, (0, 0, 0, 0, 0, s - n))

    return repad(dq), repad(dk), repad(dv)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention (Vocos backbone): fp32 scores and softmax,
    probabilities in q's dtype. q, k, v: [B, S, H, D] -> [B, S, H, D]."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def decode_attention(
    q: torch.Tensor, k_cache, v_cache, lengths: torch.Tensor
) -> torch.Tensor:
    """Plain version of kernel B (JAX ``pallas_decode.flash_decode_attention``).

    q: [B, Hq, D]; caches [B, T, Hkv, D] in q's dtype or int8 dicts;
    lengths: [B] valid rows, including the token just written. Rows at or
    beyond a sequence's length may hold anything, NaN included: they are
    zeroed before they meet a probability, so they never reach the result.
    The arithmetic is the flash kernel's: q scaled in fp32 and rounded to
    its dtype, int8 rows dequantized with their per-(token, head) scales,
    everything else in fp32. Returns [B, Hq, D] in q's dtype.
    """
    quant = isinstance(k_cache, dict)
    kq = k_cache["q"] if quant else k_cache
    vq = v_cache["q"] if quant else v_cache
    b, t, hkv, d = kq.shape
    hq = q.shape[1]
    n_rep = hq // hkv
    qg = (q.float() * (d ** -0.5)).to(q.dtype).float().reshape(b, hkv, n_rep, d)
    kf, vf = kq.float(), vq.float()
    if quant:
        kf = kf * k_cache["scale"][..., None]
        vf = vf * v_cache["scale"][..., None]
    ok = torch.arange(t, device=q.device)[None, :] < lengths[:, None]  # [B, T]
    kf = torch.where(ok[:, :, None, None], kf, 0.0)
    vf = torch.where(ok[:, :, None, None], vf, 0.0)
    logits = torch.einsum("bgrd,bkgd->bgrk", qg, kf)
    logits = logits.masked_fill(~ok[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrk,bkgd->bgrd", probs, vf)
    return out.reshape(b, hq, d).to(q.dtype)


def ragged_decode_attention_plain(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """Plain version of kernel C (JAX ``pallas_decode.ragged_decode_attention``).

    q: [B, Hq, D]; caches [B, T, Hkv, D] (bf16 or fp32, no int8); lengths:
    [B] valid rows, including the token just written. The arithmetic is the
    ragged kernel's, which differs from kernel B's in two places: the scaled
    query stays in fp32 (B rounds it to q's dtype), and a length of 0 gives
    zeros (``acc / max(l, 1e-30)`` with nothing accumulated). Rows at or
    beyond a sequence's length may hold anything, NaN included: they are
    zeroed before they meet a probability. Returns [B, Hq, D] in q's dtype.
    """
    b, t, hkv, d = k_cache.shape
    hq = q.shape[1]
    qg = (q.float() * (d ** -0.5)).reshape(b, hkv, hq // hkv, d)
    ok = torch.arange(t, device=q.device)[None, :] < lengths[:, None]  # [B, T]
    kf = torch.where(ok[:, :, None, None], k_cache.float(), 0.0)
    vf = torch.where(ok[:, :, None, None], v_cache.float(), 0.0)
    live = ok[:, None, None, :]
    logits = torch.einsum("bgrd,bkgd->bgrk", qg, kf).masked_fill(~live, NEG_INF)
    p = torch.where(live, torch.exp(logits - logits.amax(-1, keepdim=True)), 0.0)
    out = torch.einsum("bgrk,bkgd->bgrd", p, vf) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(b, hq, d).to(q.dtype)


def window_attention(
    q: torch.Tensor, k_cache, v_cache, lengths: torch.Tensor
) -> torch.Tensor:
    """W-token window attention against a padded KV cache (counterpart of
    the JAX package's ``ops.attention.window_attention``, which XLA
    computes outside any Pallas kernel; so this is plain torch on every
    device, not the plain version of a kernel).

    q: [B, W, Hq, D], window position i at absolute position lengths[b] + i,
    its K/V already written to the cache at that row; caches [B, T, Hkv, D]
    or int8 dicts; lengths: [B] valid rows BEFORE the window. Query i
    attends rows <= lengths + i. The arithmetic is the JAX function's:
    scores in q's dtype then fp32, K scales folded into the scores and V
    scales into the probabilities, which are rounded to q's dtype before
    the weighted sum. Returns [B, W, Hq, D] in q's dtype.
    """
    k_quant = isinstance(k_cache, dict)
    v_quant = isinstance(v_cache, dict)
    kq = k_cache["q"] if k_quant else k_cache
    vq = v_cache["q"] if v_quant else v_cache
    b, t, hkv, d = kq.shape
    w, hq = q.shape[1], q.shape[2]
    qg = q.reshape(b, w, hkv, hq // hkv, d)
    logits = torch.einsum("bwgrd,bkgd->bgrwk", qg, kq.to(q.dtype)).float() * d ** -0.5
    if k_quant:
        logits = logits * k_cache["scale"].transpose(1, 2)[:, :, None, None, :]
    pos = torch.arange(t, device=q.device)[None, None, None, None, :]
    limit = (lengths[:, None] + torch.arange(w, device=q.device)[None, :])
    logits = torch.where(pos <= limit[:, None, None, :, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if v_quant:
        probs = probs * v_cache["scale"].transpose(1, 2)[:, :, None, None, :]
    probs = probs.to(q.dtype)
    out = torch.einsum("bgrwk,bkgd->bwgrd", probs, vq.to(q.dtype))
    return out.reshape(b, w, hq, d)
