"""Weight-only int8/int4 quantization for serving, and int8 KV-cache rows
(counterpart of ``tts_max_tpu/models/quantization.py``).

Decode reads every weight once a step, so storing the weights in fewer bits
cuts the bytes a step moves: per-output-channel symmetric int8, or int4
with a min-MSE clip search, per channel or in sub-channel groups of the
contraction dim. Activations stay in the compute dtype.

A quantized kernel is ``{"q": int8 [..., in, out], "scale": f32 [...,
out]}``, or ``{"q4": uint8 [..., in, out/2], "scale": ...}`` with two int4
levels a byte (low nibble first, pairs along the last axis in the natural
orientation), the scale grouped as ``[..., in/g, out]``. A quantized
embedding is ``{"q": int8 [V, D], "scale": f32 [V]}`` (per row), whose row
scales double as the output scales of the tied LM head. The int4 bytes
stay packed at rest and on the card: the kernel of ``ops/quant_matmul.py``
reads the nibbles, so the JAX package's ``unpack_packed_params`` (a TPU S4
layout workaround) has no counterpart.

``matmul``, ``embed_lookup`` and ``tied_logits`` take plain or quantized
leaves; the quantized products go through ``ops/quant_matmul.py``.
"""

from __future__ import annotations

from typing import Any

import torch

from tts_max_tpu_torch.ops.quant_matmul import (  # noqa: F401 (re-exported)
    dequantize,
    is_grouped,
    is_packed4,
    is_quantized,
    quant_matmul,
    quant_tied_logits,
    unpack_q4,
)


def _min_mse_scale(w32: torch.Tensor, amax: torch.Tensor, axis: int, qmax: float
                   ) -> torch.Tensor:
    """Clip search: the scale of the clip ratio (1.0 to 0.6 of the abs-max)
    with the least squared error per channel (or per group), in fp32."""
    best_err = None
    best_scale = torch.clamp_min(amax / qmax, 1e-12)
    for ratio in (1.0, 0.9, 0.8, 0.7, 0.6):
        s = torch.clamp_min(amax * ratio / qmax, 1e-12)
        deq = torch.clamp(torch.round(w32 / s), -qmax, qmax) * s
        err = torch.sum((deq - w32) ** 2, dim=axis, keepdim=True)
        if best_err is None:
            best_err, best_scale = err, s
        else:
            best_scale = torch.where(err < best_err, s, best_scale)
            best_err = torch.minimum(err, best_err)
    return best_scale


def _pack4(q: torch.Tensor) -> torch.Tensor:
    """int4 levels [-7, 7] (any dtype) -> nibble-packed uint8 along the last
    axis (low nibble first; two's complement)."""
    u = q.to(torch.int8).to(torch.int32) & 0xF
    return (u[..., 0::2] | (u[..., 1::2] << 4)).to(torch.uint8)


def quantize_tensor(w: torch.Tensor, axis: int, bits: int = 8,
                    group_size: int | None = None) -> dict[str, torch.Tensor]:
    """Symmetric int8/int4 of ``w``, reducing only over ``axis`` (the
    contraction dim): leading dims (the stacked layers of ``[L, in, out]``)
    keep their own scales. Bitwise equal to the JAX package's
    ``quantize_tensor`` (fp32 division, round-half-to-even).

    ``bits=8``: ``{"q": int8 like w, "scale": f32 with axis removed}``.
    ``bits=4``: the clip-searched scale and ``{"q4": uint8 [..., last/2]}``
    (the last axis must be even). ``group_size`` (int4 kernels ``[..., K,
    N]`` only): one scale per ``group_size`` rows of K, ``scale [..., K/g,
    N]``.
    """
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    qmax = 7.0 if bits == 4 else 127.0
    w32 = w.float()
    if group_size is not None:
        if bits != 4:
            raise ValueError("group_size is an int4 kernel option")
        if axis != w.ndim - 2:
            raise ValueError("grouped quantization expects kernel orientation [..., K, N]")
        k = w.shape[axis]
        if k % group_size:
            raise ValueError(f"K={k} not divisible by group_size={group_size}")
        if w.shape[-1] % 2:
            raise ValueError("int4 packing needs an even last axis")
        lead, n = w.shape[:-2], w.shape[-1]
        wg = w32.reshape(*lead, k // group_size, group_size, n)
        amax = wg.abs().amax(dim=-2, keepdim=True)
        scale = _min_mse_scale(wg, amax, -2, qmax)
        q = torch.clamp(torch.round(wg / scale), -qmax, qmax)
        return {"q4": _pack4(q.reshape(*lead, k, n)), "scale": scale.squeeze(-2)}
    amax = w32.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(amax / qmax, 1e-12)
    if bits == 4:
        scale = _min_mse_scale(w32, amax, axis, qmax)
    q = torch.clamp(torch.round(w32 / scale), -qmax, qmax)
    sq_scale = scale.squeeze(axis)
    if bits == 8:
        return {"q": q.to(torch.int8), "scale": sq_scale}
    if w.shape[-1] % 2:
        raise ValueError("int4 packing needs an even last axis")
    return {"q4": _pack4(q), "scale": sq_scale}


def _quantize_tree(tree: Any, bits: int, embed_bits: int, group_size: int | None,
                   consume: bool, path: tuple = ()) -> Any:
    """Every matmul kernel per output channel (``embed_bits`` for the
    ``lm_head``), the embedding per row; other leaves as they are. With
    ``consume`` the dicts of ``tree`` are updated in place, each leaf
    replaced as soon as its quantized form exists."""
    if isinstance(tree, dict):
        out = tree if consume else {}
        for k in list(tree):
            v = tree[k]
            if k == "kernel" and isinstance(v, torch.Tensor) and v.ndim >= 2:
                b = embed_bits if path and path[-1] == "lm_head" else bits
                out[k] = quantize_tensor(v, axis=v.ndim - 2, bits=b,
                                         group_size=group_size if b == 4 else None)
            elif k == "embedding":
                out[k] = quantize_tensor(v, axis=1, bits=embed_bits)  # per row
            else:
                out[k] = _quantize_tree(v, bits, embed_bits, group_size, consume,
                                        path + (k,))
            del v
        return out
    if isinstance(tree, list):
        return [_quantize_tree(v, bits, embed_bits, group_size, consume, path) for v in tree]
    return tree


def quantize_llama_params(params: Any, bits: int = 8, embed_bits: int | None = None,
                          group_size: int | None = None) -> Any:
    """A new parameter tree: every matmul kernel quantized per output
    channel and the embedding per row; norm scales as they are.

    ``embed_bits`` is the embedding's and the LM head's (default: int8 at
    least, since the logits' precision drives sampling and the windowed
    head read is small beside the layers). ``group_size`` (int4) gives the
    layer kernels sub-channel grouped scales; the embedding and LM head keep
    per-row / per-channel scales."""
    eb = embed_bits if embed_bits is not None else max(bits, 8)
    return _quantize_tree(params, bits, eb, group_size, consume=False)


def quantize_for_serving(params: Any, mode: str) -> Any:
    """The serving CLIs' quantization: ``mode`` in {"", "int8", "int4",
    "int4-gN"} ("int4-g128": 128-row groups, the int4 form of better
    quality). Runs on the parameters' device, leaf by leaf, updating
    ``params`` in place and returning it: each full-precision leaf is
    released as soon as its quantized form exists, so the two trees never
    sit whole in memory together (the JAX package quantizes under one jit
    for the same reason)."""
    if not mode:
        return params
    group_size = None
    if mode.startswith("int4-g"):
        group_size = int(mode[len("int4-g"):])
        mode = "int4"
    bits = 4 if mode == "int4" else 8
    return _quantize_tree(params, bits, max(bits, 8), group_size, consume=True)


# --- compute helpers used by the model code ---------------------------------


def matmul(x: torch.Tensor, p) -> torch.Tensor:
    """x @ kernel for a plain ``[K, N]`` kernel (cast to x's dtype) or a
    quantized one (``ops/quant_matmul.quant_matmul``); the result in x's
    dtype."""
    if is_quantized(p):
        return quant_matmul(x, p)
    return x @ p.to(x.dtype)


def embed_lookup(emb, tokens: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Embedding rows of ``tokens`` in ``dtype``; a quantized embedding's
    rows are gathered packed, then unpacked and scaled in ``dtype``."""
    tokens = tokens.long()
    if is_quantized(emb):
        if "q4" in emb:
            rows = unpack_q4(emb["q4"][tokens], dtype)
        else:
            rows = emb["q"][tokens].to(dtype)
        return rows * emb["scale"][tokens][..., None].to(dtype)
    return emb[tokens].to(dtype)


def tied_logits(h: torch.Tensor, emb) -> torch.Tensor:
    """fp32 logits ``h @ embedding.T`` for a plain or quantized embedding
    (row scales become output scales)."""
    if is_quantized(emb):
        return quant_tied_logits(h, emb)
    return (h @ emb.to(h.dtype).T).float()
