"""Paged decode attention over a block-pool KV cache (counterpart of
``tts_max_tpu/ops/paged_attention.py``), through ``csrc/paged_decode.cu``.

The cache is a pool ``[N, bs, Hkv, D]`` per layer (or the stacked
``[L, N, bs, Hkv, D]`` caches with ``layer=``); each sequence owns an
ordered list of block ids, its row of ``table [B, P]``; unallocated
entries hold a valid id (0, the serving engine's sink block) and are masked
by ``lengths``. int8 pools are ``{"q": int8 [N, bs, Hkv, D], "scale": f32
[N, bs, Hkv]}``.

The JAX package has three Pallas kernels for this one function, which
differ only in how they schedule it on a TPU: ``paged_decode_attention_dense``
(kernel D, block-diagonal MXU products, and its stacked ``layer=`` form),
``paged_decode_attention_dma`` (E, double-buffered page DMAs) and
``paged_decode_attention`` (F, a ``(B, P)`` grid). Here one CUDA kernel
serves all three entry points, which keep the JAX signatures and each count
their own launches. On a CPU tensor each runs the plain version,
``paged_decode_attention_xla`` (gather through the table, then
``ops.attention.decode_attention``); on a CUDA tensor each launches the
kernel or raises. With bf16 queries (bf16 or int8 pools) the kernel runs on
the tensor cores and needs 16-byte aligned pools; fp32 queries run on the
CUDA cores.
"""

from __future__ import annotations

import ctypes
import operator

import torch

from tts_max_tpu_torch.ops import cuda_build
from tts_max_tpu_torch.ops.attention import decode_attention
from tts_max_tpu_torch.ops.flash_decode import _Q_DTYPES, check_inputs, partials, sm_count


def _split(pool):
    if isinstance(pool, dict):
        return pool["q"], pool["scale"]
    return pool, None


def paged_decode_attention_xla(q, k_pool, v_pool, table, lengths):
    """The plain version. q: [B, Hq, D]; pools [N, bs, Hkv, D] or int8 dicts;
    table: [B, P] block ids (all valid ids); lengths: [B] valid rows,
    including the token just written. Gathers each sequence's pages into a
    contiguous [B, P * bs, Hkv, D] cache and attends over it."""
    idx = table.long()
    b, p = table.shape

    def gather(pool):
        kq, scale = _split(pool)
        flat = kq[idx].reshape(b, p * kq.shape[1], *kq.shape[2:])
        if scale is None:
            return flat
        return {"q": flat, "scale": scale[idx].reshape(b, p * kq.shape[1], -1)}

    return decode_attention(q, gather(k_pool), gather(v_pool), lengths)


def paged_decode_attention_dense(q, k_pool, v_pool, table, lengths, *, layer=None,
                                 pages_per_block: int = 4, alias_caches: bool = False):
    """Entry point of kernel D. ``layer``: the pools are the stacked
    ``[L, N, bs, Hkv, D]`` caches and layer ``layer`` is read, with no copy.
    ``pages_per_block`` (>= 1) is the JAX kernel's TPU scheduling argument;
    it has no effect here, where the split size comes from the SM count,
    and the result is the same function either way. ``alias_caches=True``
    returns ``(out, k_pool, v_pool)``: the pools are returned as they came
    (PyTorch needs no in/out alias to keep a layer loop from copying them)."""
    if operator.index(pages_per_block) < 1:
        raise ValueError(f"pages_per_block {pages_per_block} < 1")
    out = _paged(paged_decode_attention_dense, q, k_pool, v_pool, table, lengths, layer)
    return (out, k_pool, v_pool) if alias_caches else out


def paged_decode_attention_dma(q, k_pool, v_pool, table, lengths):
    """Entry point of kernel E (same function as D)."""
    return _paged(paged_decode_attention_dma, q, k_pool, v_pool, table, lengths, None)


def paged_decode_attention(q, k_pool, v_pool, table, lengths):
    """Entry point of kernel F (same function as D)."""
    return _paged(paged_decode_attention, q, k_pool, v_pool, table, lengths, None)


paged_decode_attention_dense.launches = 0
paged_decode_attention_dma.launches = 0
paged_decode_attention.launches = 0


def _paged(entry, q, k_pool, v_pool, table, lengths, layer):
    quant = isinstance(k_pool, dict)
    if quant != isinstance(v_pool, dict):
        raise ValueError("k and v pools must both be int8 dicts or both not")
    kq, ks = _split(k_pool)
    vq, vs = _split(v_pool)
    stacked = layer is not None
    if stacked:
        layer = operator.index(layer)
        if kq.ndim != 5 or not 0 <= layer < kq.shape[0]:
            raise ValueError(f"layer {layer} of a pool shaped {tuple(kq.shape)}")
    n, bs, hkv, d = kq.shape[-4:]
    b, hq = q.shape[0], q.shape[1]
    p = table.shape[-1]
    if (kq.ndim != (5 if stacked else 4) or vq.shape != kq.shape
            or q.shape != (b, hq, d) or hq % hkv):
        raise ValueError(f"shapes q {tuple(q.shape)} pool {tuple(kq.shape)} do not fit")
    if table.shape != (b, p) or lengths.shape != (b,):
        raise ValueError(f"table {tuple(table.shape)} / lengths {tuple(lengths.shape)} "
                         f"do not fit batch {b}")
    if quant and (ks.shape != kq.shape[:-1] or vs.shape != ks.shape):
        raise ValueError("int8 pool scales must be [..., N, bs, Hkv]")
    if q.device.type == "cpu":
        if stacked:
            k_pool = {"q": kq[layer], "scale": ks[layer]} if quant else kq[layer]
            v_pool = {"q": vq[layer], "scale": vs[layer]} if quant else vq[layer]
        return paged_decode_attention_xla(q, k_pool, v_pool, table, lengths)

    check_inputs(q, kq, vq, [ks, vs] if quant else [], [lengths, table])

    pages = _pages_per_split(b, hkv, p, q.device)
    n_split = -(-p // pages)
    part_acc, part_ml = partials(q, hkv, n_split)
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.paged_decode_fwd(
        q.data_ptr(), kq.data_ptr(), vq.data_ptr(),
        ks.data_ptr() if quant else None, vs.data_ptr() if quant else None,
        table.data_ptr(), lengths.data_ptr(), part_acc.data_ptr(),
        part_ml.data_ptr(), out.data_ptr(), b, p, n, bs, hq, hkv, d,
        layer if stacked else -1, n_split, pages * bs, d ** -0.5,
        _Q_DTYPES[q.dtype], int(quant),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    cuda_build.check(lib, err, "paged_decode_fwd")
    entry.launches += 1
    return out


def _pages_per_split(b: int, hkv: int, p: int, device: torch.device) -> int:
    """Whole pages per split of the table's width: about two blocks per SM
    in all (kernel B's ``num_splits`` over pages instead of chunks)."""
    want = max(1, -(-2 * sm_count(device.index) // (b * hkv)))
    return -(-p // want)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("paged_decode")
    fn = lib.paged_decode_fwd
    if fn.argtypes is None:
        pt, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [pt] * 10 + [i] * 10 + [ctypes.c_float, i, i, pt]
        fn.restype = i
    return lib
