"""Plain PyTorch attention (counterpart of ``tts_max_tpu/ops/attention.py``).

These are the plain versions of the two CUDA kernels — the CPU path of
their wrappers and the reference ``chip_smoke.py`` holds the kernels
against on the card — plus the non-causal attention of the Vocos backbone,
which the JAX package leaves to XLA and the port leaves to plain ops.

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
