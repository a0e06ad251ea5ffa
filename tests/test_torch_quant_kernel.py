"""A CPU model of the quantized product's kernel (``csrc/quant_matmul.cu``)
and its launch rule (``ops/quant_matmul.plan``).

The kernel runs only on the card; this file walks its schedule lane by
lane in numpy on the CPU, with the kernel's own bit operations on 32-bit
words, and holds the result against the plain version (``matmul_plain``,
``tied_logits_plain``) under ``quant_matmul.KERNEL_TOL``:

- kn: each stage's levels copied in the pieces the wrapper picks (16 bytes
  where the row stride allows) through the row stride, zeros past the row;
  ``ldmatrix.trans`` of each warp's 32 bytes of 16 k rows; the int8 pairs
  along k (the 2^23 + (x + 128) trick, then bf16) or the int4 nibbles as
  the bf16 136 + level minus 136; the A fragment's rows as columns 2g, 2g+1
  (int8) or 4g..4g+3 (int4) of each 16-byte piece, k in order; x's B
  fragment by ``ldmatrix`` from the staged bf16 rows, or fp32 x split in
  three bf16 terms; each mma's 16 exact products added to the fragment
  with one rounding; a stage's fragment added to the sum in fp32 (grouped:
  a group's fragment times the group's scale by fmaf); the sums written by
  lane to the block's columns, the cluster's ranks added in rank order,
  the column scale, one rounding;
- vd: lane (g, t)'s 16 bytes of vocab rows g and g + 8 a chunk; the
  fragment's k slots 2t, 2t+1, 2t+8, 2t+9 as the lane's four consecutive
  d's of a k-step, h read in the same order; a chunk's fragment added in
  fp32, x the row scale.

A model with a wrong k-slot mapping or a swapped nibble fails the same
check. The launch rule is held to cover every layer kernel of Llama-3.2-1B
and Llama-3.1-8B, the untied head window and every row count up to
``R_MAX``.
"""

import numpy as np
import pytest
import torch

from _torch_fixtures import one_torch_thread  # noqa: F401
from tts_max_tpu_torch.models import llama
from tts_max_tpu_torch.models import quantization as tq
from tts_max_tpu_torch.ops import quant_matmul as qm

FORMS = {"int8": dict(bits=8), "int4": dict(bits=4), "int4-g64": dict(bits=4, group_size=64),
         "int4-g128": dict(bits=4, group_size=128)}
SHAPES_1B = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]
SHAPES_8B = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
WINDOW = (262, 65542)  # the byte tokenizer's speech window

U32 = np.uint32
LANE = np.arange(32)
G, T = LANE // 4, LANE % 4  # lane = 4 g + t


# --- the kernel's word operations ---------------------------------------------------


def _bf16(f) -> np.ndarray:
    """fp32 -> bf16 bits (round to nearest even), as __floats2bfloat162_rn."""
    u = np.ascontiguousarray(f, np.float32).view(U32)
    return ((u + U32(0x7FFF) + ((u >> U32(16)) & U32(1))) >> U32(16)) & U32(0xFFFF)


def _pack(lo, hi) -> np.ndarray:
    return _bf16(lo) | (_bf16(hi) << U32(16))


def _halves(w) -> tuple[np.ndarray, np.ndarray]:
    """The two bf16 values of a bf16x2 word, low half first, as fp32."""
    w = np.asarray(w, U32)
    return (((w & U32(0xFFFF)) << U32(16)).view(np.float32),
            (w & U32(0xFFFF0000)).view(np.float32))


def _byte_perm(x, y, s: int) -> np.ndarray:
    """__byte_perm(x, y, s): byte i of the result is byte (s >> 4i) & 7 of
    the pair (x, y), x's bytes first."""
    x, y = np.asarray(x, U32), np.asarray(y, U32)
    out = np.zeros(np.broadcast(x, y).shape, U32)
    for i in range(4):
        sel = (s >> (4 * i)) & 7
        src = x if sel < 4 else y
        out |= ((src >> U32(8 * (sel & 3))) & U32(0xFF)) << U32(8 * i)
    return out


def _i8(u, i: int) -> np.ndarray:
    """Level i of u = word ^ 0x80808080: 2^23 + (level + 128), minus 2^23 + 128."""
    return _byte_perm(u, 0x4B000000, 0x7440 + i).view(np.float32) - np.float32(8388736.0)


def _int8_kpairs(w) -> tuple[np.ndarray, np.ndarray]:
    """kn: the bf16 pairs along k of columns c and c + 1 of an ldmatrix.trans word."""
    u = np.asarray(w, U32) ^ U32(0x80808080)
    return _pack(_i8(u, 0), _i8(u, 2)), _pack(_i8(u, 1), _i8(u, 3))


def _int8x4(w) -> tuple[np.ndarray, np.ndarray]:
    """vd (mma::int8x4_to_bf16): bytes (0, 1) and (2, 3) as bf16 pairs."""
    u = np.asarray(w, U32) ^ U32(0x80808080)
    return _pack(_i8(u, 0), _i8(u, 1)), _pack(_i8(u, 2), _i8(u, 3))


def _int4_pair(w) -> np.ndarray:
    """The nibbles at bits 0-3 and 16-19: 0x4300 | (nibble ^ 8) = 136 + level
    in bf16, minus 136 (exact)."""
    lo, hi = _halves((np.asarray(w, U32) & U32(0x000F000F)) ^ U32(0x43084308))
    return _pack(lo - np.float32(136), hi - np.float32(136))


def _split3(f) -> list[np.ndarray]:
    """fp32 -> three bf16 terms (as fp32 values) summing to it exactly."""
    f = np.asarray(f, np.float32)
    hi = _halves(_bf16(f))[0]
    mid = _halves(_bf16(f - hi))[0]
    return [hi, mid, _halves(_bf16(f - hi - mid))[0]]


# --- mma.m16n8k16 -----------------------------------------------------------------


def _a_matrix(a) -> np.ndarray:
    """A fragments [..., 32, 4] (bf16x2) -> A [..., 16, 16]: a[0] row g, k
    2t..2t+1; a[1] row g+8; a[2] row g, k 2t+8..; a[3] row g+8, k 2t+8.."""
    out = np.zeros(a.shape[:-2] + (16, 16))
    for r, (ro, ko) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        lo, hi = _halves(a[..., r])
        out[..., G + ro, 2 * T + ko] = lo
        out[..., G + ro, 2 * T + ko + 1] = hi
    return out


def _b_matrix(b) -> np.ndarray:
    """B fragments [..., 32, 2] -> B [..., 16, 8]: b0 k 2t..2t+1, b1 k
    2t+8..2t+9, column g."""
    out = np.zeros(b.shape[:-2] + (16, 8))
    for r, ko in enumerate((0, 8)):
        lo, hi = _halves(b[..., r])
        out[..., 2 * T + ko, G] = lo
        out[..., 2 * T + ko + 1, G] = hi
    return out


def _c_lanes(c) -> np.ndarray:
    """C [..., 16, 8] -> per lane [..., 32, 4]: (g, 2t), (g, 2t+1), (g+8, 2t),
    (g+8, 2t+1)."""
    return np.stack([c[..., G, 2 * T], c[..., G, 2 * T + 1], c[..., G + 8, 2 * T],
                     c[..., G + 8, 2 * T + 1]], -1)


def _mma_into(frag, a_mat, b_mat, spec: str) -> np.ndarray:
    """frag (fp32 lanes) + the 16 exact products of each element, one
    rounding (the tensor cores' fused sum)."""
    return (frag.astype(np.float64) + _c_lanes(np.einsum(spec, a_mat, b_mat))).astype(np.float32)


def _b_frags(rows: np.ndarray, k0) -> np.ndarray:
    """B fragments of staged rows [8, ...] (bf16 values) at k columns k0 +
    (2t, 2t+1), (2t+8, 2t+9): ldmatrix of [row g][k0 .. k0 + 15]."""
    b0 = _pack(rows[G, k0 + 2 * T], rows[G, k0 + 2 * T + 1])
    b1 = _pack(rows[G, k0 + 2 * T + 8], rows[G, k0 + 2 * T + 9])
    return np.stack([b0, b1], -1)


def _terms(x: torch.Tensor, rows: int, width: int) -> list[np.ndarray]:
    """x staged as ``rows`` rows (zeros past x's) of ``width`` elements (zeros
    past x's): bf16 x as it is, fp32 x as its three bf16 terms."""
    xf = np.zeros((rows, width), np.float32)
    xf[:x.shape[0], :x.shape[1]] = x.float().numpy()
    return [xf] if x.dtype == torch.bfloat16 else _split3(xf)


# --- kn -----------------------------------------------------------------------------


def _kn_columns(bits: int, wn: int) -> np.ndarray:
    """[warp piece, A tile, 16 A rows] -> the tile's column: the kernel's
    ``col`` of lane (g, t) for rows g (c[0..1]) and + 1 for rows g + 8."""
    mc = 2 if bits == 8 else 4
    out = np.zeros((wn, mc, 16), np.int64)
    for w in range(wn):
        for i in range(mc):
            col = (32 * w + 16 * i + 2 * np.arange(8) if bits == 8
                   else 64 * w + 32 * (i >> 1) + 4 * np.arange(8) + 2 * (i & 1))
            out[w, i, :8], out[w, i, 8:] = col, col + 1
    return out


def kn_model(x: torch.Tensor, p: dict, faults=()) -> torch.Tensor:
    """The kn kernel's walk for x [M, K] (M <= R_MAX). ``faults``: "kslot"
    swaps the B fragment's two k halves, "nibble" the int4 nibbles."""
    packed = "q4" in p
    bits = 4 if packed else 8
    q, scale = (p["q4"] if packed else p["q"]), p["scale"].float().numpy()
    k, n = q.shape[0], q.shape[1] * (2 if packed else 1)
    group = k // scale.shape[0] if scale.ndim == 2 else None
    m = x.shape[0]
    nt, cs, tiles, tile = qm.plan(m, k, n, bits, group)
    wn = tile // 32  # warps along N; kw along K share a stage's two k-steps
    kw = qm.KN_WARPS // wn
    ldq, row_bytes = q.stride(0), n * bits // 8
    vec = qm._vec(ldq, q.data_ptr())
    # the stages' copies: vec-byte pieces through the row stride, zeros past the row
    buf = torch.as_strided(q.view(torch.uint8), (k, ldq), (ldq, 1)).numpy()
    cols = np.arange(tiles * tile)
    live = cols // vec * vec < row_bytes
    lv = np.zeros((k, cols.size), np.uint32)
    lv[:, live] = buf[:, cols[live]]
    terms = _terms(x, 8 * nt, k)

    steps = k // 16
    tl, w, j = np.arange(tiles), np.arange(wn), np.arange(2)
    byte = (tile * tl[:, None, None, None] + 32 * w[None, :, None, None]
            + 16 * j[None, None, :, None] + 2 * G)  # [tile, warp piece, 16-byte piece, lane]
    colmap = _kn_columns(bits, wn)
    mc = colmap.shape[1]
    per_rank = steps // cs
    tile_cols = tile * 8 // bits
    acc = part = None
    ranks = []
    for s in range(steps):
        if s % per_rank == 0:
            acc = np.zeros((kw, tiles, wn, mc, nt, 32, 4), np.float32)
            part = np.zeros_like(acc)
        kb = 16 * s
        wk = s % 2 if kw == 2 else 0  # the warps of the piece that take this k-step
        # ldmatrix.trans: k rows kb + 2t, 2t+1 (and + 8), bytes 2g, 2g+1 of the piece

        def word(k2):
            return (lv[k2, byte] | lv[k2, byte + 1] << U32(8) | lv[k2 + 1, byte] << U32(16)
                    | lv[k2 + 1, byte + 1] << U32(24))
        lo, hi = word(kb + 2 * T), word(kb + 8 + 2 * T)
        if bits == 8:
            (l0, l1), (h0, h1) = _int8_kpairs(lo), _int8_kpairs(hi)
            a = np.stack([l0, l1, h0, h1], -1)  # [tile, warp piece, A tile, lane, 4]
        else:
            sh = (4, 0, 12, 8) if "nibble" in faults else (0, 4, 8, 12)
            alpha = np.stack([_int4_pair(lo >> U32(sh[0])), _int4_pair(lo >> U32(sh[1])),
                              _int4_pair(hi >> U32(sh[0])), _int4_pair(hi >> U32(sh[1]))], -1)
            beta = np.stack([_int4_pair(lo >> U32(sh[2])), _int4_pair(lo >> U32(sh[3])),
                             _int4_pair(hi >> U32(sh[2])), _int4_pair(hi >> U32(sh[3]))], -1)
            a = np.stack([alpha, beta], 3).reshape(tiles, wn, 4, 32, 4)
        a_mat = _a_matrix(a)
        for tm in terms:
            b = np.stack([_b_frags(tm[8 * i:8 * i + 8], kb) for i in range(nt)])
            if "kslot" in faults:
                b = b[..., ::-1]
            part[wk] = _mma_into(part[wk], a_mat[:, :, :, None], _b_matrix(b)[None, None, None],
                                 "...rk,...kc->...rc")
        kend = kb + 16
        if group is None and kend % qm.STAGE_ROWS == 0:  # a stage's fragments, in fp32
            acc, part = (acc + part).astype(np.float32), np.zeros_like(part)
        elif group is not None and kend % group == 0:  # a group's, x its scales (fmaf)
            sv = scale[kend // group - 1]
            col = tile_cols * tl[:, None, None, None] + colmap[None]  # [tile, w, mc, 16]
            s_rows = np.where(col < n, sv[np.minimum(col, n - 1)], 0.0)
            s_lanes = np.stack([s_rows[..., G], s_rows[..., G], s_rows[..., G + 8],
                                s_rows[..., G + 8]], -1)[:, :, :, None]
            acc = (part.astype(np.float64) * s_lanes + acc).astype(np.float32)
            part = np.zeros_like(part)
        if (s + 1) % per_rank == 0:  # the block's sums: the k warps in order, by lane
            total = acc[0]
            for i in range(1, kw):
                total = (total + acc[i]).astype(np.float32)
            red = np.zeros((tiles, 8 * nt, tile_cols), np.float32)
            for i in range(nt):
                tok = 8 * i + 2 * T
                for r, (dt, dc) in enumerate(((0, 0), (1, 0), (0, 1), (1, 1))):
                    col = colmap[:, :, :8][..., G] + dc  # [w, mc, lane]
                    red[:, tok + dt, col] = total[:, :, :, i, :, r]
            ranks.append(red)
    total = np.zeros_like(ranks[0])
    for red in ranks:  # the cluster's ranks in rank order
        total = (total + red).astype(np.float32)
    out = total.transpose(1, 0, 2).reshape(8 * nt, -1)[:m, :n]
    if group is None:
        out = (out * scale).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(out)).to(x.dtype)


# --- vd -----------------------------------------------------------------------------


def vd_model(h: torch.Tensor, emb: dict, faults=()) -> torch.Tensor:
    """The vd kernel's walk: fp32 logits [M, V]. ``faults`` as kn_model."""
    packed = "q4" in emb
    bits = 4 if packed else 8
    q = (emb["q4"] if packed else emb["q"]).view(torch.uint8).numpy()
    v, row_bytes = q.shape
    d = row_bytes * 8 // bits
    nt = qm.row_tiles(h.shape[0])
    pieces = qm.VD_PIECES
    chunk = 64 * pieces  # bytes of a row a chunk
    lane_d = 128 * pieces // bits
    chunk_d, steps = 4 * lane_d, lane_d // 4
    nch = -(-row_bytes // chunk)
    terms = _terms(h, 8 * nt, nch * chunk_d)
    tiles = -(-v // 16)
    rows = np.minimum(16 * np.arange(tiles)[:, None] + np.arange(16), v - 1)  # clamped
    lv = np.zeros((tiles, 16, nch * chunk), np.uint32)
    lv[..., :row_bytes] = q[rows]
    acc = np.zeros((tiles, nt, 32, 4), np.float32)
    for c in range(nch):
        # lane (g, t): its 16-byte pieces of rows g and g + 8 at byte chunk c + 16
        # pieces t, as 32-bit words (k-step s: word s (int8), bytes 2s, 2s+1 (int4))
        byte = chunk * c + 16 * pieces * T[:, None] + np.arange(16 * pieces)  # [lane, bytes]
        piece = [lv[:, G + 8 * hh][:, np.arange(32)[:, None], byte] for hh in (0, 1)]
        words = [(pc[..., 0::4] | pc[..., 1::4] << U32(8) | pc[..., 2::4] << U32(16)
                  | pc[..., 3::4] << U32(24)) for pc in piece]  # [tile, lane, 4]
        part = np.zeros_like(acc)
        for s in range(steps):
            pairs = []
            for wd in words:  # row g, then row g + 8
                if bits == 8:
                    pairs.append(_int8x4(wd[..., s]))
                else:
                    w0 = wd[..., s >> 1]
                    w4 = w0 >> U32(4)
                    b = 2 * (s & 1)
                    a, bb = (w4, w0) if "nibble" in faults else (w0, w4)
                    pairs.append(tuple(_int4_pair(_byte_perm(
                        a, bb, e | (e << 4) | ((4 + e) << 8) | ((4 + e) << 12)))
                        for e in (b, b + 1)))
            a_mat = _a_matrix(np.stack([pairs[0][0], pairs[1][0], pairs[0][1], pairs[1][1]], -1))
            d0 = c * chunk_d + lane_d * T + 4 * s  # the lane's four d's
            for tm in terms:
                b = []
                for i in range(nt):
                    rw = tm[8 * i + G]
                    b0 = _pack(rw[LANE, d0], rw[LANE, d0 + 1])
                    b1 = _pack(rw[LANE, d0 + 2], rw[LANE, d0 + 3])
                    b.append(np.stack([b1, b0] if "kslot" in faults else [b0, b1], -1))
                part = _mma_into(part, a_mat[:, None], _b_matrix(np.stack(b))[None],
                                 "...rk,...kc->...rc")
        acc = (acc + part).astype(np.float32)
    logits = np.zeros((8 * nt, tiles * 16), np.float32)
    for i in range(nt):
        tok = 8 * i + 2 * T
        for r, (dt, dr) in enumerate(((0, 0), (1, 0), (0, 8), (1, 8))):
            logits[tok + dt, 16 * np.arange(tiles)[:, None] + G + dr] = acc[:, i, :, r]
    assert d == h.shape[1]
    out = logits[:h.shape[0], :v] * emb["scale"].float().numpy()
    return torch.from_numpy(np.ascontiguousarray(out, np.float32))


# --- checks -------------------------------------------------------------------------


def _kernel(rng, k, n, form) -> dict:
    """A quantized [K, N] kernel whose columns differ (a swapped nibble pair
    would not pass)."""
    w = rng.standard_normal((k, n)) * rng.uniform(0.1, 2.0, n)
    return tq.quantize_tensor(torch.from_numpy(w.astype(np.float32)), 0, **FORMS[form])


def _emb(rng, v, d, bits) -> dict:
    e = rng.standard_normal((v, d)) * rng.uniform(0.1, 2.0, (v, 1))
    return tq.quantize_tensor(torch.from_numpy(e.astype(np.float32)), 1, bits=bits)


def _within(out: torch.Tensor, ref: torch.Tensor) -> bool:
    """|out - ref| <= rtol |ref| + atol max|ref| (``KERNEL_TOL`` by out's dtype)."""
    rtol, atol = qm.KERNEL_TOL[out.dtype]
    err = (out.float() - ref).abs()
    return bool(torch.isfinite(out).all()) and bool(
        (err <= rtol * ref.abs() + atol * ref.abs().max()).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("m", [1, 3, 9, 16])
def test_kn_walk_matches_the_plain_version(form, m, dtype, monkeypatch):
    """256 x 384 at 64-byte tiles (two warps along K), then at 128-byte ones
    (the rule's choice for wider kernels): N past the last tile's columns."""
    rng = np.random.default_rng(m)
    p = _kernel(rng, 256, 384, form)
    x = torch.from_numpy(rng.standard_normal((m, 256)).astype(np.float32)).to(dtype)
    assert qm.plan(m, 256, 384, FORMS[form]["bits"], FORMS[form].get("group_size"))[3] == 64
    assert _within(kn_model(x, p), qm.matmul_plain(x.float(), p))
    monkeypatch.setattr(qm, "NARROW_BLOCKS", 0)
    assert qm.plan(m, 256, 384, FORMS[form]["bits"], FORMS[form].get("group_size"))[3] == 128
    assert _within(kn_model(x, p), qm.matmul_plain(x.float(), p))


@pytest.mark.parametrize("bits", [8, 4])
def test_kn_walk_reads_a_column_window_through_its_row_stride(bits):
    """The untied head window: a column slice of a wider kernel, copied once
    into rows padded to 16 bytes (``llama._column_window``), N not a
    multiple of a tile's columns: 16-byte pieces through the row stride."""
    rng = np.random.default_rng(bits)
    full = tq.quantize_tensor(torch.from_numpy(rng.standard_normal((128, 400)).astype(
        np.float32)), 0, bits=bits)
    lo, size = 14, 250  # 250 % 8 != 0; even, as int4 needs
    key = "q4" if bits == 4 else "q"
    a, b = (lo // 2, (lo + size) // 2) if bits == 4 else (lo, lo + size)
    win = {key: llama._column_window(full[key], a, b), "scale": full["scale"][lo:lo + size]}
    assert win[key].stride(0) % 16 == 0 and not win[key].is_contiguous()
    assert qm._vec(win[key].stride(0), win[key].data_ptr()) == 16
    x = torch.from_numpy(rng.standard_normal((4, 128)).astype(np.float32))
    assert _within(kn_model(x, win), qm.matmul_plain(x, win))
    dense = {key: win[key].contiguous(), "scale": win["scale"]}
    torch.testing.assert_close(qm.matmul_plain(x, win), qm.matmul_plain(x, dense))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [1, 5, 16])
def test_vd_walk_matches_the_plain_version(bits, m, dtype):
    """48 vocab rows (three A tiles, the last task's second tile clamped)
    over D = 320: five int8 chunks, the last int4 chunk half past the row."""
    rng = np.random.default_rng(bits + m)
    emb = _emb(rng, 40, 320, bits)
    h = torch.from_numpy(rng.standard_normal((m, 320)).astype(np.float32)).to(dtype)
    assert _within(vd_model(h, emb), qm.tied_logits_plain(h.float(), emb))


@pytest.mark.parametrize("case", ["kn kslot", "kn nibble", "vd kslot", "vd nibble"])
def test_a_wrong_fragment_mapping_fails_the_model(case):
    """The model's check has teeth: B's k halves swapped against A's, or the
    low and high nibble of a byte swapped, leaves the plain version."""
    entry, fault = case.split()
    rng = np.random.default_rng(7)
    if entry == "kn":
        p = _kernel(rng, 256, 384, "int4-g64")
        x = torch.from_numpy(rng.standard_normal((3, 256)).astype(np.float32))
        assert _within(kn_model(x, p), qm.matmul_plain(x, p))
        assert not _within(kn_model(x, p, faults=(fault,)), qm.matmul_plain(x, p))
    else:
        emb = _emb(rng, 32, 256, 4)
        h = torch.from_numpy(rng.standard_normal((3, 256)).astype(np.float32))
        assert _within(vd_model(h, emb), qm.tied_logits_plain(h, emb))
        assert not _within(vd_model(h, emb, faults=(fault,)), qm.tied_logits_plain(h, emb))


def test_level_words_widen_exactly():
    """Every int8 byte and int4 nibble becomes its level in bf16, exactly,
    through the kernel's word operations."""
    b = np.arange(256, dtype=U32)
    c0, c1 = _int8_kpairs(b | (b << U32(8)) << U32(8))  # bytes (b, 0, b, 0): (k, c), (k+1, c)
    lvl = (b.astype(np.int64) ^ 128) - 128
    assert np.array_equal(_halves(c0)[0], lvl) and np.array_equal(_halves(c0)[1], lvl)
    assert np.array_equal(_halves(c1)[0], 0 * lvl)
    lo, hi = _int8x4(b | b << U32(24))
    assert np.array_equal(_halves(lo)[0], lvl) and np.array_equal(_halves(hi)[1], lvl)
    nib = np.arange(16, dtype=U32)
    pair = _halves(_int4_pair(nib | (15 - nib) << U32(16)))
    assert np.array_equal(pair[0], (nib.astype(np.int64) ^ 8) - 8)
    assert np.array_equal(pair[1], ((15 - nib).astype(np.int64) ^ 8) - 8)
    f = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    hi3, mid3, lo3 = _split3(f)
    assert np.array_equal((hi3.astype(np.float64) + mid3 + lo3).astype(np.float32), f)


def _layer_shapes():
    for k, n in SHAPES_1B + SHAPES_8B:
        for form in FORMS:
            yield k, n, form
    yield 4096, WINDOW[1], "int8"  # an untied int8 head window (8B)


@pytest.mark.parametrize("k,n,form", list(_layer_shapes()))
def test_launch_rule_covers_every_shape_and_row_count(k, n, form):
    bits, group = FORMS[form]["bits"], FORMS[form].get("group_size")
    for m in range(1, qm.R_MAX + 1):
        nt, cs, tiles, tile = qm.plan(m, k, n, bits, group)
        assert nt == (1 if m <= 8 else 2) and m <= qm.TILE_ROWS * nt
        assert tile in qm.TILE_BYTES and cs in qm.CLUSTERS and k % (cs * qm.STAGE_ROWS) == 0
        assert group is None or (k // cs) % group == 0  # every group ends in its block
        assert tiles * tile >= n * bits // 8 > (tiles - 1) * tile
        # the most K splits whose clusters fit at once (by default TARGET_BLOCKS)
        ok = [c for c in qm.CLUSTERS if k % (c * qm.STAGE_ROWS) == 0
              and (group is None or (k // c) % group == 0)]
        assert cs == max([c for c in ok if tiles * c <= qm.TARGET_BLOCKS] or [1])
        # 64-byte tiles only where 128-byte ones give fewer than NARROW_BLOCKS blocks
        wide = -(-(n * bits // 8) // 128)
        wide_cs = max([c for c in ok if wide * c <= qm.TARGET_BLOCKS] or [1])
        assert (tile == 64) == (wide * wide_cs < qm.NARROW_BLOCKS)
    # the main shapes keep every SM busy: at least 2 blocks an SM, or every split taken
    nt, cs, tiles, tile = qm.plan(1, k, n, bits, group)
    assert tiles * cs >= qm.NARROW_BLOCKS or cs == max(qm.CLUSTERS) or tile == 64


# Clusters of cs kn blocks an H100 80GB HBM3 holds at once
# (``cudaOccupancyMaxActiveClusters``, bf16 x), by (bits, grouped, nt, tile)
# for cs = 1, 2, 4, 8, 16
H100_SLOTS = {(8, False, 1, 128): (660, 330, 154, 77, 35),
              (8, False, 1, 64): (1056, 528, 248, 124, 58),
              (8, False, 2, 128): (528, 264, 124, 62, 28),
              (4, False, 1, 128): (660, 330, 154, 77, 35),
              (4, False, 1, 64): (924, 462, 216, 107, 49),
              (4, True, 1, 128): (528, 264, 124, 62, 28),
              (4, True, 1, 64): (792, 396, 186, 92, 42)}


@pytest.mark.parametrize("k,n,form,m,want", [
    (2048, 8192, "int8", 1, (8, 128)),       # 64 tiles: 77 clusters of 8 fit, 35 of 16 do not
    (2048, 8192, "int8", 16, (4, 128)),      # two n8 tiles: 62 clusters of 8 < 64
    (4096, 4096, "int8", 1, (16, 128)),      # 32 tiles <= 35
    (4096, 14336, "int8", 1, (4, 128)),      # 112 tiles: 154 clusters of 4
    (2048, 8192, "int4-g128", 1, (8, 128)),  # 32 tiles > 28 clusters of 16
    (14336, 4096, "int4-g128", 1, (16, 128)),
    (8192, 2048, "int8", 1, (16, 128)),      # 16 tiles x 16: 256 blocks
    (8192, 2048, "int4-g128", 1, (16, 64)),  # 8 x 16 = 128 blocks < 132 SMs: 64-byte tiles
    (2048, 512, "int4", 1, (16, 64)),
])
def test_launch_rule_takes_the_most_splits_the_card_holds_at_once(k, n, form, m, want):
    """With the card's own cluster occupancy, the rule picks these K splits
    and tiles; each timed within 4% of the fastest split and tile at its
    shape on that card (``tools/bench_quant.py --splits``)."""
    bits, group = FORMS[form]["bits"], FORMS[form].get("group_size")

    def slots(nt, tile, c):
        return H100_SLOTS[(bits, group is not None, nt, tile)][qm.CLUSTERS.index(c)]
    assert qm.plan(m, k, n, bits, group, slots)[1::2] == want


@pytest.mark.parametrize("bits", [8, 4])
def test_vd_row_stride_spreads_a_phase_over_the_banks(bits):
    """The 16-byte reads of h by the 8 lanes of a phase (rows g, g + 1; t =
    0..3 along d) fall in 8 different groups of 4 banks, at every read of a
    chunk, with bf16 h."""
    hs = qm.vd_row_stride(2048, bits, 2)
    lane_d = 128 * qm.VD_PIECES // bits
    for c in (0, 1, 5):
        for j in range(lane_d // 8):
            groups = set()
            for g in (0, 1):
                for t in range(4):
                    d = 4 * lane_d * c + lane_d * t + 8 * j
                    elem = g * hs + d + 8 * (d // 64)
                    groups.add(elem // 2 // 4 % 8)
            assert len(groups) == 8


def test_vd_shared_memory_holds_the_tied_head_rows():
    """16 rows of h at Llama-3.2-1B's width fit one vd launch in bf16 and in
    fp32; a width whose rows do not fit is refused by the wrapper, not
    launched."""
    assert qm.vd_smem(2, 2048, 8, 4) <= qm.VD_SMEM_MAX and qm.vd_smem(2, 2048, 4, 2) <= \
        qm.VD_SMEM_MAX
    assert qm.vd_smem(2, 2816, 8, 4) <= qm.VD_SMEM_MAX < qm.vd_smem(2, 3072, 8, 4)
    assert qm.vd_smem(2, 5632, 8, 2) <= qm.VD_SMEM_MAX < qm.vd_smem(2, 6144, 8, 2)


def test_wrappers_take_the_plain_version_on_the_cpu_only():
    rng = np.random.default_rng(0)
    p = _kernel(rng, 64, 32, "int4-g64")
    x = torch.from_numpy(rng.standard_normal((40, 64)).astype(np.float32))
    before = qm.quant_matmul.launches
    # more rows than R_MAX too: on the CPU every product is the plain version
    torch.testing.assert_close(qm.quant_matmul(x, p), qm.matmul_plain(x, p))
    assert qm.quant_matmul.launches == before
    with pytest.raises(ValueError, match="quantized"):
        qm.quant_matmul(x, {"kernel": x})
    with pytest.raises(ValueError, match="rows"):
        qm.row_tiles(qm.R_MAX + 1)
    with pytest.raises(ValueError, match="multiples of 32"):
        qm.plan(1, 48, 64, 8)
