"""Kernel C: ragged decode attention over a padded contiguous KV cache
(``csrc/ragged_decode.cu``).

Replaces the JAX package's Pallas ``ragged_decode_attention``
(``tts_max_tpu/ops/pallas_decode.py``), the decode attention its docstring
gives to the serving engine's padded pool: the contiguous engine's decode
step runs it over a bf16 or fp32 cache (``llama.decode_step(ragged=True)``).
On a CUDA tensor the wrapper launches the kernel; on a CPU tensor it runs
the plain version, ``ops.attention.ragged_decode_attention_plain``. There is
no fallback from one to the other: a CUDA input the kernel does not take
(an int8 cache, another head_dim, a non-contiguous tensor) raises.

One block of 128 threads per (sequence, kv head) walks that sequence's
rows in tiles of ``block_k`` = 128, as many tiles as its length needs.
"""

from __future__ import annotations

import ctypes

import torch

from tts_max_tpu_torch.ops import cuda_build
from tts_max_tpu_torch.ops.attention import ragged_decode_attention_plain as plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_REP = 8
BLOCK_K = 128  # the kernel's tile of rows (compiled in)


def ragged_decode_attention(
    q: torch.Tensor, k_cache, v_cache, lengths: torch.Tensor, *, block_k: int = BLOCK_K
) -> torch.Tensor:
    """q: [B, Hq, D]; caches [B, T, Hkv, D] in q's dtype (bf16 or fp32);
    lengths: [B] valid rows including the token just written. Reads only
    rows < lengths[b]; a length of 0 gives zeros. Returns [B, Hq, D] in q's
    dtype."""
    if isinstance(k_cache, dict) or isinstance(v_cache, dict):
        raise ValueError("ragged decode attention takes bf16/fp32 caches, not int8 "
                         "dicts (kernel B serves int8 KV)")
    if block_k != BLOCK_K:
        raise ValueError(f"block_k {block_k}: the kernel is built for {BLOCK_K}")
    b, t, hkv, d = k_cache.shape
    hq = q.shape[1]
    if q.shape != (b, hq, d) or v_cache.shape != k_cache.shape or hq % hkv:
        raise ValueError(f"shapes q {tuple(q.shape)} cache {tuple(k_cache.shape)} "
                         f"do not fit")
    if lengths.shape != (b,):
        raise ValueError(f"lengths shape {tuple(lengths.shape)} != ({b},)")
    if q.device.type == "cpu":
        return plain(q, k_cache, v_cache, lengths)
    tensors = [q, k_cache, v_cache, lengths]
    if q.device.type != "cuda" or any(x.device != q.device for x in tensors):
        raise ValueError("all inputs must share one CUDA device")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q dtype {q.dtype} not in {list(_DTYPES)}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"cache dtype {k_cache.dtype}/{v_cache.dtype}, need {q.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {_HEAD_DIMS}")
    if hq // hkv > _MAX_REP:
        raise ValueError(f"{hq // hkv} query heads per kv head > {_MAX_REP}")
    if lengths.dtype != torch.int32:
        raise ValueError(f"lengths dtype {lengths.dtype}, need int32")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("q, caches and lengths must be contiguous")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("caches must start on a 16-byte boundary (vector loads)")

    out = torch.empty_like(q)
    lib = _lib()
    err = lib.ragged_decode_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), b, t, hq, hkv, d, d ** -0.5, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    cuda_build.check(lib, err, "ragged_decode_fwd")
    ragged_decode_attention.launches += 1
    return out


ragged_decode_attention.launches = 0


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("ragged_decode")
    fn = lib.ragged_decode_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = i
    return lib
