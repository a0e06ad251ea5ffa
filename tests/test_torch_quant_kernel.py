"""A CPU model of the quantized product's kernel (``csrc/quant_matmul.cu``)
and its launch rule (``ops/quant_matmul.plan``).

The kernel runs only on the card; this file walks its schedule in torch on
the CPU and holds the result against the plain version
(``matmul_plain``, ``tied_logits_plain``):

- kn: the levels read as little-endian 32-bit words of each row (through
  the row stride, as the kernel reads a column window), each value
  sign-extended from its bit field (low nibble first), every warp's run of
  K rows summed in fp32, a grouped run's sums times its group's scale, the
  four warps added in order, the splits added by the second kernel's
  eight warps (each its every eighth split in order, then the warps in
  order), the per-column scale, one rounding;
- vd: each lane's 16-byte pieces of a vocab row, its float4 reads of h in
  order, the shuffle reduction's butterfly, x the row scale.

fp32 results agree with the plain version within 1e-5 (|ref| + max|ref|):
the two add the same products in another order, and an output that
cancels keeps the rounding of the large terms; a bf16 result is within one
bf16 ulp of the plain version computed in fp32 (the kernel rounds once). The launch rule is held to cover every layer kernel
of Llama-3.2-1B and Llama-3.1-8B, the untied head window and every row
count up to ``R_MAX``.
"""

import numpy as np
import pytest
import torch

from tts_max_tpu_torch.models import llama
from tts_max_tpu_torch.models import quantization as tq
from tts_max_tpu_torch.ops import quant_matmul as qm

FORMS = {"int8": dict(bits=8), "int4": dict(bits=4), "int4-g64": dict(bits=4, group_size=64),
         "int4-g128": dict(bits=4, group_size=128)}
SHAPES_1B = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]
SHAPES_8B = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
WINDOW = (262, 65542)  # the byte tokenizer's speech window


def _words(levels: torch.Tensor) -> torch.Tensor:
    """[K, X] uint8/int8 levels with a row stride of a multiple of 4 bytes
    -> int64 [K, ldq / 4]: the 32-bit words the kernel loads, as unsigned
    values (bytes past the view's columns are the buffer's)."""
    k, ldq = levels.shape[0], levels.stride(0)
    base = torch.as_strided(levels.view(torch.uint8), (k, ldq), (ldq, 1))
    b = base.to(torch.int64).reshape(k, ldq // 4, 4)
    return b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24


def _level(words: torch.Tensor, c: int, bits: int) -> torch.Tensor:
    """Value c of each word: ``(int32)(w << (32 - bits (c + 1))) >> (32 - bits)``."""
    v = (words >> (bits * c)) & ((1 << bits) - 1)
    return (v - ((v >> (bits - 1)) << bits)).float()


def kn_model(x: torch.Tensor, p: dict) -> torch.Tensor:
    """The kn kernel's walk for x [M, K] (M <= R_MAX)."""
    packed = "q4" in p
    bits = 4 if packed else 8
    q, scale = (p["q4"] if packed else p["q"]), p["scale"].float()
    k, n = q.shape[0], q.shape[1] * (2 if packed else 1)
    group = k // scale.shape[0] if scale.ndim == 2 else None
    m = x.shape[0]
    mb, run, splits, tiles = qm.plan(m, k, n, bits, group)
    cols = 32 // bits
    words = _words(q)  # [K, ldq / 4]
    lv = torch.stack([_level(words, c, bits) for c in range(cols)], -1).reshape(k, -1)
    assert lv.shape[1] >= n and tiles * 32 * cols >= n
    lv = lv[:, :n]  # columns past N are computed by live lanes, never stored
    x32 = torch.zeros(mb, k)
    x32[:m] = x.float()  # rows >= M are zero in shared memory
    parts = []
    for s in range(splits):
        warp_sums = []
        for w in range(qm.WARPS):
            kw = (s * qm.WARPS + w) * run
            acc = torch.zeros(mb, n)
            for r in range(kw, kw + run):
                acc = acc + x32[:, r:r + 1] * lv[r]
            if group is not None:
                assert kw // group == (kw + run - 1) // group  # a run lies in one group
                acc = acc * scale[kw // group]
            warp_sums.append(acc)
        parts.append(((warp_sums[0] + warp_sums[1]) + warp_sums[2]) + warp_sums[3])
    # the second kernel: warp w adds splits w, w + RED_WARPS, ... in order,
    # then the warps' sums are added in warp order
    red = []
    for w in range(qm.RED_WARPS):
        acc = torch.zeros(mb, n)
        for s in range(w, splits, qm.RED_WARPS):
            acc = acc + parts[s]
        red.append(acc)
    out = red[0]
    for w in range(1, qm.RED_WARPS):
        out = out + red[w]
    if group is None:
        out = out * scale
    return out[:m].to(x.dtype)


def vd_model(h: torch.Tensor, emb: dict) -> torch.Tensor:
    """The vd kernel's walk: fp32 logits [M, V]."""
    packed = "q4" in emb
    bits = 4 if packed else 8
    q = emb["q4"] if packed else emb["q"]
    v, row_bytes = q.shape
    d = row_bytes * 8 // bits
    nf = 128 // bits // 4  # float4s of h under 16 bytes of levels
    words = _words(q).reshape(v, -1, 4)  # [V, row_bytes / 16 pieces, 4 words]
    hs = h.float()
    lanes = []
    for lane in range(32):
        acc = torch.zeros(h.shape[0], v)
        for piece in range(lane, row_bytes // 16, 32):
            d0 = piece * 16 * 8 // bits
            for f in range(nf):
                w = words[:, piece, (f * 4 * bits) >> 5] >> ((f * 4 * bits) & 31)
                for c in range(4):
                    acc = acc + hs[:, d0 + 4 * f + c:d0 + 4 * f + c + 1] * _level(w, c, bits)
        lanes.append(acc)
    for o in (16, 8, 4, 2, 1):  # the xor butterfly: every lane ends with the sum
        lanes = [lanes[i] + lanes[i ^ o] for i in range(32)]
    assert d == h.shape[1]
    return lanes[0] * emb["scale"].float()


def _kernel(rng, k, n, form) -> dict:
    """A quantized [K, N] kernel whose columns differ (a swapped nibble pair
    would not pass)."""
    w = rng.standard_normal((k, n)) * rng.uniform(0.1, 2.0, n)
    return tq.quantize_tensor(torch.from_numpy(w.astype(np.float32)), 0, **FORMS[form])


def _close_f32(out: torch.Tensor, ref: torch.Tensor) -> None:
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))


def _check(out: torch.Tensor, x: torch.Tensor, ref_fn) -> None:
    ref = ref_fn(x.float())
    if out.dtype == torch.float32:
        _close_f32(out, ref)
    else:  # one rounding of the fp32 sum: within one bf16 ulp
        err = (out.float() - ref).abs()
        assert (err <= 2.0 ** -7 * ref.abs() + 1e-6).all(), float(err.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("m", [1, 3, 16])
def test_kn_walk_matches_the_plain_version(form, m, dtype):
    rng = np.random.default_rng(m)
    p = _kernel(rng, 256, 384, form)
    x = torch.from_numpy(rng.standard_normal((m, 256)).astype(np.float32)).to(dtype)
    _check(kn_model(x, p), x, lambda xf: qm.matmul_plain(xf, p))


@pytest.mark.parametrize("bits", [8, 4])
def test_kn_walk_reads_a_column_window_through_its_row_stride(bits):
    """The untied head window: a column slice of a wider kernel, copied once
    into rows padded to 16 bytes (``llama._column_window``), N not a
    multiple of a word's columns."""
    rng = np.random.default_rng(bits)
    full = tq.quantize_tensor(torch.from_numpy(rng.standard_normal((128, 400)).astype(
        np.float32)), 0, bits=bits)
    lo, size = 14, 250  # 250 % 8 != 0; even, as int4 needs
    key = "q4" if bits == 4 else "q"
    a, b = (lo // 2, (lo + size) // 2) if bits == 4 else (lo, lo + size)
    win = {key: llama._column_window(full[key], a, b), "scale": full["scale"][lo:lo + size]}
    assert win[key].stride(0) % 16 == 0 and not win[key].is_contiguous()
    x = torch.from_numpy(rng.standard_normal((4, 128)).astype(np.float32))
    _check(kn_model(x, win), x, lambda xf: qm.matmul_plain(xf, win))
    dense = {key: win[key].contiguous(), "scale": win["scale"]}
    torch.testing.assert_close(qm.matmul_plain(x, win), qm.matmul_plain(x, dense))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [1, 5])
def test_vd_walk_matches_the_plain_version(bits, m, dtype):
    rng = np.random.default_rng(bits + m)
    d = 1024  # two 16-byte pieces a lane at int8, one at int4
    e = rng.standard_normal((48, d)) * rng.uniform(0.1, 2.0, (48, 1))
    emb = tq.quantize_tensor(torch.from_numpy(e.astype(np.float32)), 1, bits=bits)
    h = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32)).to(dtype)
    _close_f32(vd_model(h, emb), qm.tied_logits_plain(h.float(), emb))


def _layer_shapes():
    for k, n in SHAPES_1B + SHAPES_8B:
        for form in FORMS:
            yield k, n, form
    yield 4096, WINDOW[1], "int8"  # an untied int8 head window (8B)


@pytest.mark.parametrize("k,n,form", list(_layer_shapes()))
def test_launch_rule_covers_every_shape_and_row_count(k, n, form):
    bits, group = FORMS[form]["bits"], FORMS[form].get("group_size")
    cols = 32 // bits
    for m in range(1, qm.R_MAX + 1):
        mb, run, splits, tiles = qm.plan(m, k, n, bits, group)
        assert mb in qm.M_BUCKETS and m <= mb < 2 * m
        assert run in qm.RUNS and run % qm.UNROLL == 0
        assert splits * qm.WARPS * run == k
        assert group is None or group % run == 0
        assert tiles * 32 * cols >= n > (tiles - 1) * 32 * cols
        assert mb * qm.WARPS * run * 4 <= 32 * 1024  # x's slice in shared memory
        # the longest run whose grid reaches TARGET_BLOCKS, shortened no
        # further once the partials (written and read) would outweigh the weight
        runs = [r for r in qm.RUNS if k % (qm.WARPS * r) == 0
                and (group is None or group % r == 0)]
        i = runs.index(run)
        assert all(tiles * (k // (qm.WARPS * r)) < qm.TARGET_BLOCKS for r in runs[:i])
        assert all(8 * (k // (qm.WARPS * r)) * mb <= k * bits / 8 for r in runs[1:i + 1])
        assert (i + 1 == len(runs) or tiles * splits >= qm.TARGET_BLOCKS
                or 8 * (k // (qm.WARPS * runs[i + 1])) * mb > k * bits / 8)


def test_vd_shared_memory_holds_the_tied_head_rows():
    """16 rows of h at Llama-3.2-1B's width fit one vd launch; a width whose
    rows do not fit is refused by the wrapper, not launched."""
    assert qm.vd_smem(16, 2048) <= qm.VD_SMEM_MAX < qm.vd_smem(16, 2880)
    assert qm.vd_smem(8, 4096) <= qm.VD_SMEM_MAX


def test_vd_padding_spreads_a_phase_over_the_banks():
    """The float4 reads of the 8 lanes of a phase (lane l at element 16 l or
    32 l) fall in 8 different groups of 4 banks once padded."""
    for step, nf in ((16, 4), (32, 8)):  # int8, int4: elements a lane, float4s a piece
        for f in range(nf):
            banks = {((d := 4 * f + step * lane) + 4 * (d >> 5)) % 32 // 4
                     for lane in range(8)}
            assert len(banks) == 8


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
        qm.m_bucket(qm.R_MAX + 1)
