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

Numbers: the kernel sums in fp32 and rounds once to the output dtype. The
JAX formula in bf16 rounds ``x @ q`` to bf16 and then multiplies by a bf16
scale, so the two differ by up to about 2 bf16 ulps; in fp32 they agree to
fp32 rounding. A grouped kernel multiplies each group's partial sums by the
group's scale before adding them, as the JAX grouped formula does.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tts_max_tpu_torch.ops import cuda_build

R_MAX = 16  # most token rows a launch takes
M_BUCKETS = (1, 2, 4, 8, 16)  # compiled row counts (csrc/quant_matmul.cu)
WARPS = 4  # warps of a kn block; each sums one run of K rows
RUNS = (128, 64, 32, 16, 8)  # K rows a warp may sum (multiples of UNROLL)
UNROLL = 8  # K rows a thread loads before it multiplies
RED_WARPS = 8  # warps of the second kernel's block, each over every 8th split
TARGET_BLOCKS = 528  # four blocks for each of the H100's 132 SMs
VD_WARPS = 8
VD_SMEM_MAX = 200 * 1024  # h staged in shared memory as fp32, 4 floats padding a 32
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


def m_bucket(m: int) -> int:
    """The compiled row count that holds ``m`` rows (1 <= m <= R_MAX)."""
    for b in M_BUCKETS:
        if m <= b:
            return b
    raise ValueError(f"{m} rows > R_MAX = {R_MAX}")


def plan(m: int, k: int, n: int, bits: int, group: int | None = None
         ) -> tuple[int, int, int, int]:
    """(m_bucket, run, splits, tiles) of a kn launch.

    A thread owns one 32-bit word of a K row: 4 int8 or 8 int4 columns, so
    a warp reads 128 consecutive bytes of the row and a block of ``WARPS``
    warps covers 32 words (``tiles`` blocks along N). Each warp sums
    ``run`` consecutive K rows, so a block covers ``WARPS * run`` rows
    (``splits`` blocks along K, summed by the second kernel). A grouped
    kernel's run divides the group size, so that a run lies in one group.
    The rule takes the longest run (fewest partial sums) whose grid reaches
    ``TARGET_BLOCKS``, shortening it no further once the fp32 partials
    (written and read back) would move more bytes than the weight.
    """
    mb = m_bucket(m)
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    words = -(-n // (32 // bits))
    tiles = -(-words // 32)
    runs = [r for r in RUNS
            if k % (WARPS * r) == 0 and (group is None or group % r == 0)]
    if not runs:
        raise ValueError(f"K = {k} (group {group}) has no run of {RUNS} that divides it "
                         f"in {WARPS} warps")
    weight_bytes_per_col = k * bits / 8
    run = runs[0]
    for r in runs[1:]:
        if tiles * (k // (WARPS * run)) >= TARGET_BLOCKS:
            break
        if 8 * (k // (WARPS * r)) * mb > weight_bytes_per_col:
            break
        run = r
    return mb, run, k // (WARPS * run), tiles


def vd_smem(mb: int, d: int) -> int:
    """Shared memory of a vd launch: h as fp32 [mb, D + D/8] (padded)."""
    return mb * (d + d // 8) * 4


# --- the wrappers ---------------------------------------------------------------


def _check_cuda(x: torch.Tensor, tensors) -> None:
    if any(t.device != x.device for t in tensors):
        raise ValueError("x and the quantized leaf must share one CUDA device")
    if x.dtype not in _X_DTYPES:
        raise ValueError(f"x dtype {x.dtype} not in {list(_X_DTYPES)}")


def quant_matmul(x: torch.Tensor, p: dict) -> torch.Tensor:
    """x [..., K] @ a quantized kernel -> [..., N] in x's dtype.

    On a CPU tensor: the plain version. On a CUDA tensor with at most
    ``R_MAX`` rows (the product of x's leading dims): the kn kernel, which
    needs a levels tensor whose rows are 4-byte aligned with unit column
    stride (a column window of a wider kernel is taken as it is, through
    its row stride), K a multiple of 32 (of the group, grouped), and fp32
    scales, contiguous. With more rows: ``torch.matmul`` on the weight
    dequantized to x's dtype."""
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
    if q.stride(1) != 1 or ldq % 4 or q.data_ptr() % 4:
        raise ValueError("the levels' rows must be 4-byte aligned with unit column stride")
    mb, run, splits, tiles = plan(m, k, n, 4 if packed else 8, group)
    x2 = x.reshape(m, k).contiguous()
    part = torch.empty(splits, m, n, dtype=torch.float32, device=x.device)
    y = torch.empty(m, n, dtype=x.dtype, device=x.device)
    lib = _lib()
    err = lib.quant_matmul_kn(
        x2.data_ptr(), q.data_ptr(), scale.data_ptr(), part.data_ptr(), y.data_ptr(),
        m, k, n, ldq, 4 if packed else 8, group or 0, mb, run, splits, tiles,
        _X_DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
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
    D a multiple of 32, and the rows of h in its shared memory: 16 rows
    up to D = 2816, Llama-3.2-1B's 2048).
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
    mb = m_bucket(m)
    if vd_smem(mb, d) > VD_SMEM_MAX:
        raise ValueError(f"{m} rows of h at D = {d} do not fit the kernel's shared memory")
    h2 = h.reshape(m, d).contiguous()
    out = torch.empty(m, v, dtype=torch.float32, device=h.device)
    lib = _lib()
    err = lib.quant_matmul_vd(
        h2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), m, d, v,
        4 if packed else 8, mb, vd_blocks(v, mb, d, h.device), _X_DTYPES[h.dtype],
        torch.cuda.current_stream(h.device).cuda_stream)
    cuda_build.check(lib, err, "quant_matmul_vd")
    quant_matmul.launches += 1
    return out.reshape(*lead, v)


def vd_blocks(v: int, mb: int, d: int, device: torch.device) -> int:
    """Blocks of a vd launch: as many as fit on the card at once (h's
    shared memory decides), each walking vocab rows a warp at a time."""
    from tts_max_tpu_torch.ops.flash_decode import sm_count

    smem = vd_smem(mb, d)
    per_sm = max(1, min(2048 // (32 * VD_WARPS), (228 * 1024) // (smem + 1024)))
    return max(1, min(-(-v // VD_WARPS), per_sm * sm_count(device.index)))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("quant_matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.quant_matmul_kn.argtypes = [p, p, p, p, p] + [i] * 11 + [p]
    lib.quant_matmul_kn.restype = i
    lib.quant_matmul_vd.argtypes = [p, p, p, p] + [i] * 7 + [p]
    lib.quant_matmul_vd.restype = i
    return lib
