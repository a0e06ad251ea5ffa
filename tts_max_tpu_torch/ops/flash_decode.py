"""Kernel B: flash decode attention over a contiguous KV cache
(``csrc/flash_decode.cu``), and the launch plumbing it shares with kernel C
(``ops/ragged_decode.py``) and the paged kernel (``ops/paged_attention.py``).

Replaces the JAX package's Pallas ``flash_decode_attention``
(``tts_max_tpu/ops/pallas_decode.py``). On a CUDA tensor the wrapper
launches the kernel; on a CPU tensor it runs the plain version,
``ops.attention.decode_attention``. There is no fallback from one to the
other: a CUDA input the kernel does not take raises. bf16 queries (bf16 or
int8 cache) run on the tensor cores, which copy 16-byte pieces of each
row: the caches must start 16-byte aligned, q and the scales 4-byte
aligned. fp32 queries run on the CUDA cores.

The kernel splits each sequence's rows over several blocks (split-K) and a
second, small kernel combines the partial softmax states; ``num_splits``
picks the split from the cache length and the card's SM count so that a
batch of one still spreads over the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tts_max_tpu_torch.ops import cuda_build
from tts_max_tpu_torch.ops.attention import decode_attention as plain

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_REP = 8
_CHUNK = 32  # rows of one tensor-core chunk (decode_split.cuh's C)
_MIN_CHUNKS_PER_SPLIT = 4  # one chunk for each of a block's four warps


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
    scales = [k_cache["scale"], v_cache["scale"]] if quant else []
    if any(s.shape != (b, t, hkv) for s in scales):
        raise ValueError("int8 cache scales must be [B, T, Hkv]")
    check_inputs(q, kq, vq, scales, [lengths])

    n_split, rows_per_split = num_splits(b, hkv, t, q.device)
    part_acc, part_ml = partials(q, hkv, n_split)
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.flash_decode_fwd(
        q.data_ptr(), kq.data_ptr(), vq.data_ptr(),
        scales[0].data_ptr() if quant else None, scales[1].data_ptr() if quant else None,
        lengths.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        out.data_ptr(), b, t, hq, hkv, d, n_split, rows_per_split,
        d ** -0.5, _Q_DTYPES[q.dtype], int(quant),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    cuda_build.check(lib, err, "flash_decode_fwd")
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0


def check_inputs(q, kq, vq, scales, ints) -> None:
    """What every decode kernel (B, C, paged) needs of CUDA inputs: one
    device; q in fp32 or bf16; caches in q's dtype, or int8 with fp32
    ``scales``; head_dim 64 or 128; at most ``_MAX_REP`` query heads per kv
    head; int32 ``ints`` (lengths, a block table); everything contiguous;
    with bf16 q (the tensor cores) 16-byte aligned caches and 4-byte
    aligned q and scales. Raises ValueError otherwise."""
    tensors = [q, kq, vq, *scales, *ints]
    if q.device.type != "cuda" or any(x.device != q.device for x in tensors):
        raise ValueError("all inputs must share one CUDA device")
    if q.dtype not in _Q_DTYPES:
        raise ValueError(f"q dtype {q.dtype} not in {list(_Q_DTYPES)}")
    cache_dtype = torch.int8 if scales else q.dtype
    if kq.dtype != cache_dtype or vq.dtype != cache_dtype:
        raise ValueError(f"cache dtype {kq.dtype}/{vq.dtype}, need {cache_dtype}")
    if any(s.dtype != torch.float32 for s in scales):
        raise ValueError("int8 cache scales must be float32")
    d, hq, hkv = q.shape[-1], q.shape[1], kq.shape[-2]
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {_HEAD_DIMS}")
    if hq // hkv > _MAX_REP:
        raise ValueError(f"{hq // hkv} query heads per kv head > {_MAX_REP}")
    if any(x.dtype != torch.int32 for x in ints):
        raise ValueError(f"lengths / table dtype {[x.dtype for x in ints]}, need int32")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("q, caches, scales, lengths and table must be contiguous")
    if q.dtype == torch.bfloat16 and (
            kq.data_ptr() % 16 or vq.data_ptr() % 16 or q.data_ptr() % 4
            or any(s.data_ptr() % 4 for s in scales)):
        raise ValueError("bf16 q must start 4-byte and the caches 16-byte aligned, "
                         "the scales 4-byte (the tensor cores copy 16-byte pieces)")


def num_splits(b: int, hkv: int, t: int, device: torch.device) -> tuple[int, int]:
    """(n_split, rows_per_split) of the T axis: whole ``_CHUNK``-row chunks
    per split, so that no chunk straddles two splits; about two blocks per
    SM in all, each split at least ``_MIN_CHUNKS_PER_SPLIT`` chunks long.
    At batch 8 and T = 2048 that is five 416-row splits. At batch 1 (1359
    live rows of 1536, 8 kv heads) the floor decides: 128-row splits, 88
    live blocks for 132 SMs, every warp busy. On an H100 these took 0.0129
    ms against 0.0146 for 64-row splits (176 blocks, two of four warps
    idle) and 0.0178 for 32 (``tools/bench_decode.py --rows`` of this
    package): a block's fixed cost (q fragments, the merge, its partial and
    the combine's share) outweighs spreading one sequence over every SM."""
    want = max(1, -(-2 * sm_count(device.index) // (b * hkv)))
    n_chunks = -(-t // _CHUNK)
    rows = _CHUNK * max(_MIN_CHUNKS_PER_SPLIT, -(-n_chunks // want))
    return -(-t // rows), rows


def partials(q: torch.Tensor, hkv: int, n_split: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The fp32 scratch of a split-K launch: part_acc [B, Hkv, n_split,
    n_rep, D] and part_ml [B, Hkv, n_split, n_rep, 2]."""
    b, hq, d = q.shape
    shape = (b, hkv, n_split, hq // hkv)
    return (torch.empty(*shape, d, dtype=torch.float32, device=q.device),
            torch.empty(*shape, 2, dtype=torch.float32, device=q.device))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """SMs of CUDA device ``index`` (a tensor's device always has one), read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("flash_decode")
    fn = lib.flash_decode_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p,
                       i, i, i, i, i, i, i, ctypes.c_float, i, i, p]
        fn.restype = i
    return lib
