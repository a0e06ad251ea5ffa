"""Kernel A, causal flash attention (``csrc/flash_attention.cu``), and its
backward, kernel A' (``csrc/flash_attention_bwd.cu``).

Kernel A replaces the JAX package's Pallas ``flash_attention``
(``tts_max_tpu/ops/pallas_attention.py``); A' replaces its ``custom_vjp``
backward ``_bwd`` (an XLA recompute of the reference attention) and the
Pallas dq/dkv kernels of the bundled TPU flash attention
(``tts_max_tpu/ops/attention.py``, ``_tpu_flash_causal``).

``flash_attention`` is a ``torch.autograd.Function`` on every device. On a
CUDA tensor its forward launches kernel A, with a per-row log-sum-exp (and,
in bf16, O's rounding residual) when an input needs a gradient, and its
backward launches A'. On a CPU tensor it runs the plain versions,
``ops.attention.causal_attention`` and ``causal_attention_bwd``, which have
the kernels' arithmetic. There is no fallback from one to the other: a CUDA
input a kernel does not take raises. bf16 inputs run both kernels on the
tensor cores (``mma.sync``, ``cp.async``), fp32 inputs on the CUDA cores.
"""

from __future__ import annotations

import ctypes

import torch

from tts_max_tpu_torch.ops import cuda_build
from tts_max_tpu_torch.ops.attention import causal_attention as plain
from tts_max_tpu_torch.ops.attention import causal_attention_bwd as plain_bwd

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _check(q, k, v, kv_len):
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if k.shape != (b, s, hkv, d) or v.shape != k.shape or hq % hkv:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not fit")
    kv_len = s if kv_len is None else kv_len
    if not 1 <= kv_len <= s:
        raise ValueError(f"kv_len {kv_len} outside [1, {s}]")
    return kv_len


def _check_cuda(*xs):
    q = xs[0]
    if q.device.type != "cuda" or any(x.device != q.device for x in xs):
        raise ValueError(f"tensors must share one CUDA device, got "
                         f"{[str(x.device) for x in xs]}")
    if q.dtype not in _DTYPES or any(x.dtype != q.dtype for x in xs):
        raise ValueError(f"dtypes {[x.dtype for x in xs]}: need one of "
                         f"{list(_DTYPES)} for all")
    if q.shape[3] not in _HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[3]} not in {_HEAD_DIMS}")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError("tensors must be contiguous")
    if q.dtype == torch.bfloat16 and any(x.data_ptr() % 16 for x in xs):
        raise ValueError("bf16 tensors must start 16-byte aligned (16-byte copies)")


def flash_attention_fwd(q, k, v, causal: bool = True, kv_len: int | None = None,
                        with_lse: bool = False):
    """Kernel A on CUDA tensors: (out [B, S, Hq, D] in q's dtype, lse,
    out_lo), the last two None unless ``with_lse``. Then it also writes each
    row's log-sum-exp of the scaled scores, fp32 [B, Hq, S], in base 2:
    log2(sum_k 2^(log2(e) * q.k * D^-1/2)), natural log-sum-exp times
    log2(e); and for bf16 O's rounding residual out_lo = bf16(o - out) of
    the fp32 output o, [B, S, Hq, D] bf16 (None for fp32), so that out +
    out_lo carries ~16 significant bits for the backward's D = sum(dO * O).
    No autograd."""
    kv_len = _check(q, k, v, kv_len)
    _check_cuda(q, k, v)
    b, s, hq, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty(b, hq, s, dtype=torch.float32, device=q.device)
           if with_lse else None)
    out_lo = torch.empty_like(q) if with_lse and q.dtype == torch.bfloat16 else None
    lib = _lib("flash_attention")
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        None if out_lo is None else out_lo.data_ptr(),
        b, s, hq, k.shape[2], d, kv_len, int(causal), d ** -0.5, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    cuda_build.check(lib, err, "flash_attention_fwd")
    flash_attention.launches += 1
    return out, lse, out_lo


def flash_attention_bwd(q, k, v, out, lse, g, causal: bool = True,
                        kv_len: int | None = None, out_lo=None):
    """dq, dk, dv (each in q's dtype) of ``flash_attention`` for the output
    cotangent g, under the ``kv_len`` rule of ``causal_attention_bwd``.

    On CUDA tensors it launches kernel A' (causal only), which reads kernel
    A's output, base-2 log-sum-exp and, for bf16, the output's rounding
    residual ``out_lo`` (all three from ``flash_attention_fwd(...,
    with_lse=True)``); on CPU tensors it runs the plain backward, which
    needs none of them."""
    kv_len = _check(q, k, v, kv_len)
    if q.device.type == "cpu":
        return plain_bwd(q, k, v, g, causal=causal, kv_len=kv_len)
    if not causal:
        raise ValueError("the backward kernel takes causal attention only")
    g = g.contiguous()
    _check_cuda(q, k, v, out, g)
    b, s, hq, d = q.shape
    if lse is None or lse.shape != (b, hq, s) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError("lse must be kernel A's fp32 [B, Hq, S] log-sum-exp")
    if (out_lo is not None) != (q.dtype == torch.bfloat16):
        raise ValueError("out_lo: kernel A's bf16 residual of the output for bf16 "
                         "inputs, None for fp32")
    if out_lo is not None:
        if out_lo.shape != q.shape:
            raise ValueError(f"out_lo shape {tuple(out_lo.shape)} is not q's")
        _check_cuda(q, out_lo)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(b, hq, s, dtype=torch.float32, device=q.device)
    lib = _lib("flash_attention_bwd")
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if out_lo is None else out_lo.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, s, hq, k.shape[2], d, kv_len, d ** -0.5, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    cuda_build.check(lib, err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, kv_len):
        ctx.causal, ctx.kv_len = causal, kv_len
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v)
            return plain(q, k, v, causal=causal, kv_len=kv_len)
        need_grad = any(ctx.needs_input_grad[:3])
        if need_grad and not causal:
            raise ValueError("the backward kernel takes causal attention only")
        out, lse, out_lo = flash_attention_fwd(q, k, v, causal, kv_len, with_lse=need_grad)
        if need_grad:
            ctx.save_for_backward(q, k, v, out, lse, out_lo)
        return out

    @staticmethod
    def backward(ctx, g):
        if g.device.type == "cpu":
            q, k, v = ctx.saved_tensors
            out = lse = out_lo = None
        else:
            q, k, v, out, lse, out_lo = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g, ctx.causal, ctx.kv_len,
                                         out_lo)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    kv_len: int | None = None,
) -> torch.Tensor:
    """q: [B, S, Hq, D]; k, v: [B, S, Hkv, D] -> [B, S, Hq, D] in q's dtype,
    differentiable on every device.

    GQA is native: query head h reads kv head h // (Hq/Hkv). Keys at or
    beyond ``kv_len`` (default S) are masked. ``.launches`` counts kernel
    A's launches, ``flash_attention_bwd.launches`` kernel A''s.
    """
    kv_len = _check(q, k, v, kv_len)
    if q.device.type != "cpu":
        _check_cuda(q, k, v)
    return _FlashAttention.apply(q, k, v, causal, kv_len)


flash_attention.launches = 0
flash_attention_bwd.launches = 0


_ARGTYPES = {
    "flash_attention": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "flash_attention_bwd": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}


def _lib(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, its entry point's types set."""
    lib = cuda_build.load(name)
    fn = getattr(lib, "flash_attention_fwd" if name == "flash_attention" else name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return lib
