"""Kernel C: ragged decode attention over a padded contiguous KV cache
(``csrc/ragged_decode.cu``).

Replaces the JAX package's Pallas ``ragged_decode_attention``
(``tts_max_tpu/ops/pallas_decode.py``), the decode attention its docstring
gives to the serving engine's padded pool: the contiguous engine's decode
step runs it over a bf16 or fp32 cache (``llama.decode_step(ragged=True)``).
On a CUDA tensor the wrapper launches the kernel; on a CPU tensor it runs
the plain version, ``ops.attention.ragged_decode_attention_plain``. There is
no fallback from one to the other: a CUDA input the kernel does not take
(an int8 cache, another head_dim, a non-contiguous or misaligned tensor)
raises.

The kernel is kernel B's split-K schedule (``flash_decode.num_splits``, two
launches): bf16 on the tensor cores with the scaled query split into bf16
hi + lo (C keeps it in fp32 where B rounds it), fp32 on the CUDA cores.
"""

from __future__ import annotations

import ctypes
import operator

import torch

from tts_max_tpu_torch.ops import cuda_build
from tts_max_tpu_torch.ops.attention import ragged_decode_attention_plain as plain
from tts_max_tpu_torch.ops.flash_decode import _Q_DTYPES, check_inputs, num_splits, partials


def ragged_decode_attention(
    q: torch.Tensor, k_cache, v_cache, lengths: torch.Tensor, *, block_k: int = 128
) -> torch.Tensor:
    """q: [B, Hq, D]; caches [B, T, Hkv, D] in q's dtype (bf16 or fp32);
    lengths: [B] valid rows including the token just written. Reads only
    rows < lengths[b]; a length of 0 gives zeros. Returns [B, Hq, D] in q's
    dtype. ``block_k`` (>= 1) is the JAX kernel's TPU tile of rows; it has
    no effect here, where the split comes from the SM count, and the result
    is the same function either way."""
    if isinstance(k_cache, dict) or isinstance(v_cache, dict):
        raise ValueError("ragged decode attention takes bf16/fp32 caches, not int8 "
                         "dicts (kernel B serves int8 KV)")
    if operator.index(block_k) < 1:
        raise ValueError(f"block_k {block_k} < 1")
    b, t, hkv, d = k_cache.shape
    hq = q.shape[1]
    if q.shape != (b, hq, d) or v_cache.shape != k_cache.shape or hq % hkv:
        raise ValueError(f"shapes q {tuple(q.shape)} cache {tuple(k_cache.shape)} "
                         f"do not fit")
    if lengths.shape != (b,):
        raise ValueError(f"lengths shape {tuple(lengths.shape)} != ({b},)")
    if q.device.type == "cpu":
        return plain(q, k_cache, v_cache, lengths)
    check_inputs(q, k_cache, v_cache, [], [lengths])

    n_split, rows_per_split = num_splits(b, hkv, t, q.device)
    part_acc, part_ml = partials(q, hkv, n_split)
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.ragged_decode_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(), b, t, hq, hkv, d,
        n_split, rows_per_split, d ** -0.5, _Q_DTYPES[q.dtype],
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
        fn.argtypes = [p] * 7 + [i] * 7 + [ctypes.c_float, i, p]
        fn.restype = i
    return lib
