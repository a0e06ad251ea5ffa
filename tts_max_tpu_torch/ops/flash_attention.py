"""Kernel A: causal flash attention for prefill (``csrc/flash_attention.cu``).

Replaces the JAX package's Pallas ``flash_attention``
(``tts_max_tpu/ops/pallas_attention.py``). On a CUDA tensor the wrapper
launches the kernel; on a CPU tensor it runs the plain version,
``ops.attention.causal_attention``, which has the kernel's arithmetic. There
is no fallback from one to the other: a CUDA input the kernel does not take
raises.
"""

from __future__ import annotations

import ctypes

import torch

from tts_max_tpu_torch.ops import cuda_build
from tts_max_tpu_torch.ops.attention import causal_attention as plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    kv_len: int | None = None,
) -> torch.Tensor:
    """q: [B, S, Hq, D]; k, v: [B, S, Hkv, D] -> [B, S, Hq, D] in q's dtype.

    GQA is native: query head h reads kv head h // (Hq/Hkv). Keys at or
    beyond ``kv_len`` (default S) are masked.
    """
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    kv_len = s if kv_len is None else kv_len
    if k.shape != (b, s, hkv, d) or v.shape != k.shape or hq % hkv:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not fit")
    if not 1 <= kv_len <= s:
        raise ValueError(f"kv_len {kv_len} outside [1, {s}]")
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, kv_len=kv_len)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v must share one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need one of "
                         f"{list(_DTYPES)} for all three")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {_HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, hq, hkv, d, kv_len, int(causal), d ** -0.5, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    cuda_build.check(lib, err, "flash_attention_fwd")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = i
    return lib
