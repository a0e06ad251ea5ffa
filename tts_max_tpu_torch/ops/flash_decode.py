"""Kernel B: flash decode attention over a contiguous KV cache
(``csrc/flash_decode.cu``).

Replaces the JAX package's Pallas ``flash_decode_attention``
(``tts_max_tpu/ops/pallas_decode.py``). On a CUDA tensor the wrapper
launches the kernel; on a CPU tensor it runs the plain version,
``ops.attention.decode_attention``. There is no fallback from one to the
other: a CUDA input the kernel does not take raises.

The kernel splits each sequence's rows over several blocks (split-K) and a
second, small kernel combines the partial softmax states; ``_num_splits``
picks the split from the cache length and the card's SM count so that a
batch of one still spreads over the card.
"""

from __future__ import annotations

import ctypes

import torch

from tts_max_tpu_torch.ops import cuda_build
from tts_max_tpu_torch.ops.attention import decode_attention as plain

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_REP = 8
_MIN_ROWS_PER_SPLIT = 64


def flash_decode_attention(
    q: torch.Tensor, k_cache, v_cache, lengths: torch.Tensor
) -> torch.Tensor:
    """q: [B, Hq, D]; caches [B, T, Hkv, D] in q's dtype, or int8 dicts
    ``{"q": int8 [B, T, Hkv, D], "scale": f32 [B, T, Hkv]}``; lengths: [B]
    valid rows including the token just written. Reads only rows
    < lengths[b]. Returns [B, Hq, D] in q's dtype."""
    quant = isinstance(k_cache, dict)
    if quant != isinstance(v_cache, dict):
        raise ValueError("k and v caches must both be int8 dicts or both not")
    kq = k_cache["q"] if quant else k_cache
    vq = v_cache["q"] if quant else v_cache
    b, t, hkv, d = kq.shape
    hq = q.shape[1]
    if q.shape != (b, hq, d) or vq.shape != kq.shape or hq % hkv:
        raise ValueError(f"shapes q {tuple(q.shape)} cache {tuple(kq.shape)} "
                         f"do not fit")
    if lengths.shape != (b,):
        raise ValueError(f"lengths shape {tuple(lengths.shape)} != ({b},)")
    if q.device.type == "cpu":
        return plain(q, k_cache, v_cache, lengths)
    tensors = [q, kq, vq, lengths]
    if quant:
        ks, vs = k_cache["scale"], v_cache["scale"]
        tensors += [ks, vs]
        if ks.shape != (b, t, hkv) or vs.shape != ks.shape:
            raise ValueError("int8 cache scales must be [B, T, Hkv]")
        if ks.dtype != torch.float32 or vs.dtype != torch.float32:
            raise ValueError("int8 cache scales must be float32")
    if q.device.type != "cuda" or any(x.device != q.device for x in tensors):
        raise ValueError("all inputs must share one CUDA device")
    if q.dtype not in _Q_DTYPES:
        raise ValueError(f"q dtype {q.dtype} not in {list(_Q_DTYPES)}")
    cache_dtype = torch.int8 if quant else q.dtype
    if kq.dtype != cache_dtype or vq.dtype != cache_dtype:
        raise ValueError(f"cache dtype {kq.dtype}/{vq.dtype}, need {cache_dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {_HEAD_DIMS}")
    if hq // hkv > _MAX_REP:
        raise ValueError(f"{hq // hkv} query heads per kv head > {_MAX_REP}")
    if lengths.dtype != torch.int32:
        raise ValueError(f"lengths dtype {lengths.dtype}, need int32")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("q, caches, scales and lengths must be contiguous")

    n_split = _num_splits(b, hkv, t, q.device)
    rows_per_split = -(-t // n_split)
    n_rep = hq // hkv
    part_acc = torch.empty(b, hkv, n_split, n_rep, d, dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty(b, hkv, n_split, n_rep, 2, dtype=torch.float32,
                          device=q.device)
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.flash_decode_fwd(
        q.data_ptr(), kq.data_ptr(), vq.data_ptr(),
        k_cache["scale"].data_ptr() if quant else None,
        v_cache["scale"].data_ptr() if quant else None,
        lengths.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        out.data_ptr(), b, t, hq, hkv, d, n_split, rows_per_split,
        d ** -0.5, _Q_DTYPES[q.dtype], int(quant),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    cuda_build.check(lib, err, "flash_decode_fwd")
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0


def _num_splits(b: int, hkv: int, t: int, device: torch.device) -> int:
    """Splits of the T axis: about two blocks per SM in all, each split at
    least ``_MIN_ROWS_PER_SPLIT`` rows long."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, -(-2 * sms // (b * hkv)))
    rows = max(_MIN_ROWS_PER_SPLIT, -(-t // want))
    return -(-t // rows)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("flash_decode")
    fn = lib.flash_decode_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p,
                       i, i, i, i, i, i, i, ctypes.c_float, i, i, p]
        fn.restype = i
    return lib
