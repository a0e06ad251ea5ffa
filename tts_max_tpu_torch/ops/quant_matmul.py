"""Weight-only int8/int4 products at decode shapes (``csrc/quant_matmul.cu``),
their plain versions, and the layout helpers of quantized leaves.

The JAX package has no ``pallas_call`` here: XLA computes
``quantization.matmul`` and ``tied_logits``
(``tts_max_tpu/models/quantization.py:256``, ``:296``), fusing the cast of
the int8 or int4 weight into the product so that decode reads the weight at
its stored density. Eager PyTorch would write a bf16 copy of every weight
on every step instead, so the port computes the two products in one
hand-written kernel with two entries:

- ``quant_matmul`` (entry ``kn``): ``y[M, N] = x[M, K] @ W`` for a kernel
  ``{"q": int8 [K, N], "scale": [N]}``, ``{"q4": uint8 [K, N/2], "scale":
  [N]}`` or grouped ``{"q4", "scale": [K/g, N]}``; y in x's dtype (bf16 or
  fp32).
- ``quant_tied_logits`` (entry ``vd``): ``logits[M, V] = (h[M, D] .
  E[V, D]^T) * scale[V]`` in fp32, for an int8 ``{"q": [V, D]}`` or int4
  ``{"q4": [V, D/2]}`` embedding (window).

The rule by rows: a product of at most ``R_MAX`` token rows (a decode step
or lockstep step of up to 16 sequences, ``decode_window``) launches the
kernel on a CUDA tensor. A product of more rows (a prefill, an engine's
group prefill) is a large matrix product, as XLA computes it outside any
Pallas kernel in the JAX package: it dequantizes the weight to x's dtype
and calls ``torch.matmul``. On a CPU tensor both wrappers run the plain
version, the JAX package's formulas in torch. There is no fallback: a CUDA
input within the kernel's rows that it does not take (a misaligned or
strided tensor, an unknown form) raises.

The kernel (``csrc/quant_matmul.cu``, one launch a product, no scratch
memory): both entries run ``mma.m16n8k16`` on the tensor cores with the
levels widened exactly to bf16 as the A operand (16 output columns, or
vocab rows, by 16 k) and x's rows as the n8 side (1-8 rows one tile, 9-16
two; ``row_tiles``). kn streams 128 (or, for a narrow N, 64) bytes of
every level row a block (``TILE_BYTES``) through an 8-stage ring of
32-row stages in shared memory, 16 bytes a lane, and reads each warp's 32
bytes with ``ldmatrix.trans``, which gives the fragment its k pairs in
order and its 16 rows as columns 2g, 2g + 1 (int8) or 4g..4g + 3 (int4) of
a 16-byte piece; the K ranges of a column tile form a thread-block
cluster, as many as the card holds at once (``plan``, ``cluster_slots``),
whose ranks add their sums in rank order through distributed shared
memory. vd gives each warp two tiles of 16 vocab rows, loads two 16-byte
pieces of a row a lane straight into registers and maps the fragment's k
slots 2t, 2t+1, 2t+8, 2t+9 to the lane's four consecutive d's, reading h
(staged once a block, ``vd_row_stride``) in the same order.

Numbers: products are exact in fp32 (bf16 x is exact in bf16, fp32 x goes
in as three bf16 terms); the tensor cores add at most one 32-row stage,
group or chunk, and fp32 adds carry the sum; the kernel rounds once to the
output dtype. The JAX formula in bf16 rounds ``x @ q`` to bf16 and then
multiplies by a bf16 scale, so the two differ by up to about 2 bf16 ulps;
in fp32 they agree to fp32 rounding. A grouped kernel multiplies each
group's sums by the group's scale before adding them, as the JAX grouped
formula does.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tts_max_tpu_torch.ops import cuda_build
from tts_max_tpu_torch.ops.flash_decode import sm_count

R_MAX = 16  # most token rows a launch takes
TILE_ROWS = 8  # token rows of an n8 tile of the tensor cores
TILE_BYTES = (128, 64)  # bytes of every level row a kn block covers: 4 or 2 warps along N
STAGE_ROWS = 32  # K rows of a stage of the kn ring
STAGES = 8  # stages of the kn ring (7 in flight)
KN_WARPS = 4  # warps of a kn block: 32 bytes of a tile each, along N, then along K
CLUSTERS = (1, 2, 4, 8, 16)  # K splits of a column tile: its cluster's blocks
TARGET_BLOCKS = 528  # kn blocks resident at once when the card is not asked (4 an SM, 132 SMs)
NARROW_BLOCKS = 132  # fewer kn blocks than SMs on 128-byte tiles: take 64-byte ones
VD_WARPS = 8
VD_TILES = 2  # A tiles of 16 vocab rows a vd warp takes
VD_PIECES = 2  # consecutive 16-byte pieces of a row a vd lane loads a chunk
VD_SMEM_MAX = 200 * 1024  # h staged in shared memory as x's dtype, padded
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The kernel against its plain version computed in fp32 on the same inputs,
# by the kernel's output dtype: |out - ref| <= rtol |ref| + atol max|ref|.
# bf16: one ulp for the kernel's single rounding; fp32: the products are
# added in another order, and an output that cancels keeps the rounding of
# its large terms.
KERNEL_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -7, 1e-5)}


# --- quantized leaves -----------------------------------------------------------


def is_quantized(p) -> bool:
    return isinstance(p, dict) and "scale" in p and ("q" in p or "q4" in p)


def is_packed4(p) -> bool:
    return isinstance(p, dict) and "q4" in p


def is_grouped(p) -> bool:
    """Grouped int4 kernel: scale [..., G, N] has the same ndim as the
    unpacked weight [..., K, N] (per-channel scales have one fewer)."""
    if not (isinstance(p, dict) and "scale" in p):
        return False
    q = p.get("q4", p.get("q"))
    return q is not None and p["scale"].ndim == q.ndim


def unpack_q4(q4: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Nibble-packed uint8 [..., X/2] -> values [..., X] in ``dtype``: the
    low nibble of each byte first, each a two's-complement int4."""
    v = q4.to(torch.int32)
    lo, hi = v & 15, (v >> 4) & 15
    lo, hi = lo - ((lo & 8) << 1), hi - ((hi & 8) << 1)
    return torch.stack([lo, hi], dim=-1).reshape(*q4.shape[:-1], -1).to(dtype)


def dequantize(p: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """The weight of a quantized leaf in ``dtype``: levels x scale in fp32,
    rounded once."""
    scale = p["scale"].float()
    q = unpack_q4(p["q4"], torch.float32) if "q4" in p else p["q"].float()
    if is_grouped(p):  # scale [..., G, N] over weight [..., K, N]
        g, (k, n) = scale.shape[-2], q.shape[-2:]
        qg = q.reshape(*q.shape[:-2], g, k // g, n)
        return (qg * scale[..., :, None, :]).reshape(q.shape).to(dtype)
    # the channel is last for kernels, first for embeddings
    if q.shape[-1] == scale.shape[-1]:
        return (q * scale).to(dtype)
    return (q * scale[..., None]).to(dtype)


# --- plain versions (the JAX package's formulas) --------------------------------


def matmul_plain(x: torch.Tensor, p: dict) -> torch.Tensor:
    """x @ kernel for a quantized kernel, as the JAX package's ``matmul``
    computes it in x's dtype: the levels cast to x's dtype, the product,
    then x the scale in x's dtype; grouped, each group's product times its
    scale row, summed over the groups."""
    dtype = x.dtype
    w = unpack_q4(p["q4"], dtype) if "q4" in p else p["q"].to(dtype)
    scale = p["scale"]
    if scale.ndim == w.ndim:  # grouped: w [K, N], scale [G, N]
        if w.ndim != 2:
            raise ValueError("grouped matmul expects a per-layer [K, N] kernel")
        k, n = w.shape
        g = scale.shape[-2]
        xg = x.reshape(*x.shape[:-1], g, k // g)
        yg = torch.einsum("...gk,gkn->...gn", xg, w.reshape(g, k // g, n))
        return torch.einsum("...gn,gn->...n", yg, scale.to(dtype)).contiguous()
    return (x @ w) * scale.to(dtype)


def tied_logits_plain(h: torch.Tensor, emb: dict) -> torch.Tensor:
    """h @ embedding.T for a quantized embedding (row scales become output
    scales), as the JAX package's ``tied_logits``: in h's dtype, then fp32."""
    w = unpack_q4(emb["q4"], h.dtype) if "q4" in emb else emb["q"].to(h.dtype)
    return ((h @ w.T) * emb["scale"].to(h.dtype)).float()


# --- the launch rule ------------------------------------------------------------


def row_tiles(m: int) -> int:
    """n8 tiles of the tensor cores that hold ``m`` token rows (1 <= m <=
    R_MAX): 1 up to 8 rows, 2 up to 16."""
    if not 1 <= m <= R_MAX:
        raise ValueError(f"{m} rows: a launch takes 1..R_MAX = {R_MAX} rows")
    return -(-m // TILE_ROWS)


def plan(m: int, k: int, n: int, bits: int, group: int | None = None,
         slots=None) -> tuple[int, int, int, int]:
    """(nt, cs, tiles, tile) of a kn launch.

    A block covers ``tile`` bytes of every level row (``tiles`` blocks along
    N) over a K range of ``k / cs`` rows, a whole number of 32-row stages
    (and of groups, grouped); the ``cs`` K ranges of a column tile are one
    thread-block cluster, whose ranks add their sums in rank order. The rule
    takes the most K splits (at most 16) whose clusters the card holds all
    at once, so that the grid is one wave and every SM keeps as many ring
    stages in flight as it can hold; where 128-byte tiles still give fewer
    blocks than the card has SMs (``NARROW_BLOCKS``: a narrow N), it takes
    64-byte tiles, two warps along N and two along K, for twice the blocks. ``slots(nt, tile,
    cs)`` is how many clusters of ``cs`` blocks the card holds at once (the
    wrapper asks the card, ``cluster_slots``); by default
    ``TARGET_BLOCKS // cs``.
    """
    nt = row_tiles(m)
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if k % STAGE_ROWS or (group is not None and group % STAGE_ROWS):
        raise ValueError(f"K = {k} (group {group}): the kernel takes K and groups in "
                         f"multiples of {STAGE_ROWS} rows")
    splits = [c for c in CLUSTERS
              if k % (c * STAGE_ROWS) == 0 and (group is None or (k // c) % group == 0)]
    for tile in TILE_BYTES:
        tiles = -(-(n * bits // 8) // tile)
        fits = [c for c in splits
                if tiles <= (slots(nt, tile, c) if slots is not None else TARGET_BLOCKS // c)]
        cs = max(fits or [1])
        if tiles * cs >= NARROW_BLOCKS:
            break
    return nt, cs, tiles, tile


@functools.lru_cache(maxsize=None)
def cluster_slots(index: int, bits: int, grouped: bool, x_dtype: int, nt: int, tile: int,
                  cs: int) -> int:
    """Clusters of ``cs`` kn blocks that CUDA device ``index`` holds at once
    (``cudaOccupancyMaxActiveClusters``), asked once."""
    lib, got = _lib(), ctypes.c_int(0)
    with torch.cuda.device(index):
        err = lib.quant_matmul_kn_clusters(bits, int(grouped), x_dtype, nt, tile // 32, cs,
                                           ctypes.byref(got))
    cuda_build.check(lib, err, "quant_matmul_kn_clusters")
    return got.value


def _hpos(d: int) -> int:
    """Where element d of a staged row of h lies (``hpos``): 8 elements of
    padding after every 64."""
    return d + 8 * (d // 64)


@functools.lru_cache(maxsize=None)
def vd_row_stride(d: int, bits: int, elem: int) -> int:
    """Elements of a row of h staged for vd: D rounded up to whole chunks,
    8 elements of padding after every 64, then the least further pad that
    spreads the 16-byte reads of a phase (the 8 lanes g = 0, 1; t = 0..3)
    over the most groups of 4 banks at every read of a chunk."""
    lane_d = 128 * VD_PIECES // bits
    chunk_d = 4 * lane_d
    dc = -(-d // chunk_d) * chunk_d
    base = _hpos(dc)
    per = 16 // elem  # elements of a 16-byte read

    def spread(hs: int) -> int:
        return min(len({(g * hs + _hpos(lane_d * t + j)) * elem // 16 % 8
                        for g in (0, 1) for t in range(4)})
                   for j in range(0, lane_d, per))

    return max(range(base, base + 128 // elem, per), key=lambda hs: (spread(hs), -hs))


def vd_smem(nt: int, d: int, bits: int, elem: int) -> int:
    """Shared memory of a vd launch: 8 nt staged rows of h."""
    return TILE_ROWS * nt * vd_row_stride(d, bits, elem) * elem


def vd_blocks(v: int, smem: int, index: int) -> int:
    """Blocks of a vd launch: as many as fit on the card at once (two a SM
    at most; h's shared memory decides), each warp walking tasks of
    ``VD_TILES`` x 16 vocab rows."""
    per_sm = max(1, min(2, (228 * 1024) // (smem + 1024)))
    tasks = -(-v // (16 * VD_TILES))
    return max(1, min(-(-tasks // VD_WARPS), per_sm * sm_count(index)))


# --- the wrappers ---------------------------------------------------------------


def _check_cuda(x: torch.Tensor, tensors) -> None:
    if any(t.device != x.device for t in tensors):
        raise ValueError("x and the quantized leaf must share one CUDA device")
    if x.dtype not in _X_DTYPES:
        raise ValueError(f"x dtype {x.dtype} not in {list(_X_DTYPES)}")


def _aligned_rows(x: torch.Tensor, m: int, k: int) -> torch.Tensor:
    """x as [m, k] contiguous rows on a 16-byte boundary (copied only when
    the view starts elsewhere)."""
    x2 = x.reshape(m, k).contiguous()
    return x2 if x2.data_ptr() % 16 == 0 else x2.clone()


def _vec(*values: int) -> int:
    """The widest piece (16, 8 or 4 bytes) that divides every value, else 0."""
    return next((v for v in (16, 8, 4) if all(a % v == 0 for a in values)), 0)


def quant_matmul(x: torch.Tensor, p: dict) -> torch.Tensor:
    """x [..., K] @ a quantized kernel -> [..., N] in x's dtype.

    On a CPU tensor: the plain version. On a CUDA tensor with at most
    ``R_MAX`` rows (the product of x's leading dims): the kn kernel, which
    needs a levels tensor whose rows are 4-byte aligned with unit column
    stride (a column window of a wider kernel is taken as it is, through
    its row stride; 16-byte aligned rows load 16 bytes a lane), K a
    multiple of 32 (and of the group, grouped; groups of a multiple of 32
    rows), and fp32 scales, contiguous. With more rows: ``torch.matmul`` on
    the weight dequantized to x's dtype."""
    if not is_quantized(p):
        raise ValueError("quant_matmul takes a quantized kernel {'q' or 'q4', 'scale'}")
    if x.device.type == "cpu":
        return matmul_plain(x, p)
    packed = "q4" in p
    q, scale = (p["q4"] if packed else p["q"]), p["scale"]
    if q.ndim != 2:
        raise ValueError(f"quant_matmul takes a per-layer [K, N] kernel, not {tuple(q.shape)}")
    k = q.shape[0]
    n = q.shape[1] * (2 if packed else 1)
    if x.shape[-1] != k:
        raise ValueError(f"x {tuple(x.shape)} does not fit the kernel [{k}, {n}]")
    lead = x.shape[:-1]
    m = x.numel() // k
    if m > R_MAX:
        return x @ dequantize(p, x.dtype)
    _check_cuda(x, (q, scale))
    if q.dtype != (torch.uint8 if packed else torch.int8):
        raise ValueError(f"levels dtype {q.dtype}, need {'uint8' if packed else 'int8'}")
    grouped = scale.ndim == 2
    group = None
    if grouped:
        if not packed or k % scale.shape[0] or scale.shape[1] != n:
            raise ValueError(f"grouped scales {tuple(scale.shape)} do not fit an int4 "
                             f"[{k}, {n}] kernel")
        group = k // scale.shape[0]
    elif scale.shape != (n,):
        raise ValueError(f"scales {tuple(scale.shape)} do not fit N = {n}")
    if scale.dtype != torch.float32 or not scale.is_contiguous():
        raise ValueError("scales must be contiguous float32")
    ldq = q.stride(0)
    vec = _vec(ldq, q.data_ptr())
    if q.stride(1) != 1 or not vec:
        raise ValueError("the levels' rows must be 4-byte aligned with unit column stride")
    bits, xd = 4 if packed else 8, _X_DTYPES[x.dtype]
    nt, cs, tiles, tile = plan(m, k, n, bits, group, functools.partial(
        cluster_slots, x.device.index, bits, group is not None, xd))
    x2 = _aligned_rows(x, m, k)
    y = torch.empty(m, n, dtype=x.dtype, device=x.device)
    lib = _lib()
    err = lib.quant_matmul_kn(
        x2.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(), m, k, n, ldq, bits,
        group or 0, nt, tile // 32, cs, tiles, vec.bit_length() - 1,
        16 if _vec(n * 4, scale.data_ptr()) == 16 else 4, xd,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, err, "quant_matmul_kn")
    quant_matmul.launches += 1
    return y.reshape(*lead, n)


quant_matmul.launches = 0


def quant_tied_logits(h: torch.Tensor, emb: dict) -> torch.Tensor:
    """fp32 logits h [..., D] . E^T x row scales for a quantized embedding
    (window) {"q": int8 [V, D]} or {"q4": uint8 [V, D/2]} with fp32 scales
    [V]. Launches count on ``quant_matmul.launches`` (one kernel, two
    entries).

    On a CPU tensor: the plain version. On a CUDA tensor with at most
    ``R_MAX`` rows: the vd kernel, which reads each embedding row in 16-byte
    pieces (rows of a multiple of 16 bytes, 16-byte aligned, contiguous;
    D a multiple of 32, and the rows of h in its shared memory: 16 bf16
    rows up to D = 5632, fp32 ones up to D = 2816; Llama-3.2-1B's 2048).
    With more rows: ``torch.matmul`` on the dequantized embedding."""
    if not is_quantized(emb):
        raise ValueError("quant_tied_logits takes a quantized embedding")
    if h.device.type == "cpu":
        return tied_logits_plain(h, emb)
    packed = "q4" in emb
    q, scale = (emb["q4"] if packed else emb["q"]), emb["scale"]
    v = q.shape[0]
    d = q.shape[1] * (2 if packed else 1)
    if q.ndim != 2 or h.shape[-1] != d or scale.shape != (v,):
        raise ValueError(f"h {tuple(h.shape)} does not fit the embedding [{v}, {d}]")
    lead = h.shape[:-1]
    m = h.numel() // d
    if m > R_MAX:
        return (h @ dequantize(emb, h.dtype).T).float()
    _check_cuda(h, (q, scale))
    if q.dtype != (torch.uint8 if packed else torch.int8):
        raise ValueError(f"levels dtype {q.dtype}, need {'uint8' if packed else 'int8'}")
    if scale.dtype != torch.float32 or not scale.is_contiguous():
        raise ValueError("scales must be contiguous float32")
    if not q.is_contiguous() or q.shape[1] % 16 or q.data_ptr() % 16 or d % 32:
        raise ValueError("the embedding's rows must be contiguous, a multiple of 16 bytes "
                         "and 16-byte aligned (the kernel loads 16-byte pieces), D a "
                         "multiple of 32")
    bits, nt, elem = 4 if packed else 8, row_tiles(m), h.element_size()
    smem = vd_smem(nt, d, bits, elem)
    if smem > VD_SMEM_MAX:
        raise ValueError(f"{m} rows of h at D = {d} do not fit the kernel's shared memory")
    h2 = _aligned_rows(h, m, d)
    out = torch.empty(m, v, dtype=torch.float32, device=h.device)
    lib = _lib()
    err = lib.quant_matmul_vd(
        h2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), m, d, v, bits, nt,
        vd_row_stride(d, bits, elem), vd_blocks(v, smem, h.device.index), _X_DTYPES[h.dtype],
        torch.cuda.current_stream(h.device).cuda_stream)
    cuda_build.check(lib, err, "quant_matmul_vd")
    quant_matmul.launches += 1
    return out.reshape(*lead, v)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("quant_matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.quant_matmul_kn.argtypes = [p, p, p, p] + [i] * 13 + [p]
    lib.quant_matmul_kn.restype = i
    lib.quant_matmul_vd.argtypes = [p, p, p, p] + [i] * 8 + [p]
    lib.quant_matmul_vd.restype = i
    lib.quant_matmul_kn_clusters.argtypes = [i] * 6 + [ctypes.POINTER(i)]
    lib.quant_matmul_kn_clusters.restype = i
    return lib
