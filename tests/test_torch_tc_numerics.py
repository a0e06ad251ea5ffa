"""The tensor-core kernels' arithmetic, emulated on the CPU.

Kernel A's bf16 path (``csrc/flash_attention.cu``) and the decode body of
``csrc/decode_tc.cuh`` (kernels B and C and the paged kernel, bf16 and
int8) run only on the card, but their rounding can be reproduced here: bf16
operands, fp32 products per tile, the score scaled after the product
(kernel A), an online softmax per 64-key tile (per 32-row chunk for the
decode body: of one page for the paged kernel, of one split for B and C)
and the probability split into bf16 hi + lo before it meets V. The
emulation lies within ``KERNEL_TOL`` of the plain versions
(``causal_attention``, ``paged_decode_attention_xla``, ``decode_attention``,
``ragged_decode_attention_plain``), and the same emulation with P rounded
once to bf16 does not: that is why the kernels carry the split. Kernel C's
plain version keeps the scaled query in fp32, so C splits q into bf16 hi +
lo as well; with q rounded once, as B rounds it, a sharp softmax at D = 128
falls outside C's tolerance.

Kernel A''s bf16 path (``csrc/flash_attention_bwd.cu``) is emulated the
same way (``emulate_kernel_a_bwd``): bf16 operands, fp32 sums per 64-row
tile pair in the kernels' walk, P and dS rounded once to bf16 where they
enter the tensor cores, D = sum(dO * (O_hi + O_lo)) from kernel A's bf16
output and its rounding residual, each gradient rounded once. It lies
within ``GRAD_TOL`` of ``causal_attention_bwd``; with D from the bf16 O
alone (the first design's D) a sharp softmax puts dq outside it.
"""

import numpy as np
import pytest
import torch

from tts_max_tpu_torch.models.llama import _quantize_kv
from tts_max_tpu_torch.ops.attention import (
    KERNEL_TOL,
    NEG_INF,
    causal_attention,
    causal_attention_bwd,
    decode_attention,
    grad_tol_ratio,
    ragged_decode_attention_plain,
)
from tts_max_tpu_torch.ops.paged_attention import paged_decode_attention_xla


def _pv(p: torch.Tensor, v: torch.Tensor, eq: str, split: bool) -> torch.Tensor:
    """P . V as the tensor cores take it: bf16(p) . V, plus bf16(p - bf16(p)) . V
    with the split, all sums in fp32."""
    hi = p.bfloat16().float()
    out = torch.einsum(eq, hi, v)
    if split:
        out = out + torch.einsum(eq, (p - hi).bfloat16().float(), v)
    return out


def emulate_kernel_a(q, k, v, *, causal=True, kv_len=None, split=True, bk=64):
    """Kernel A's bf16 arithmetic: q, k, v [B, S, H, D] bf16 -> bf16."""
    b, s, hq, d = q.shape
    n_rep = hq // k.shape[2]
    kv_len = s if kv_len is None else kv_len
    qf = q.float()
    kf, vf = (x.repeat_interleave(n_rep, 2).float() for x in (k, v))
    m = torch.full((b, hq, s), NEG_INF)
    l = torch.zeros(b, hq, s)
    acc = torch.zeros(b, hq, s, d)
    pos = torch.arange(s)
    for k0 in range(0, kv_len, bk):
        kp = pos[k0:k0 + bk]
        sc = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, k0:k0 + bk]) * d ** -0.5
        ok = (kp < kv_len)[None, :]
        if causal:
            ok = ok & (kp[None, :] <= pos[:, None])
        sc = sc.masked_fill(~ok, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = alpha * l + p.sum(-1)
        m = m_new
        acc = alpha[..., None] * acc + _pv(p, vf[:, k0:k0 + bk], "bhqk,bkhd->bhqd", split)
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def emulate_paged(q, k_pool, v_pool, table, lengths, *, split=True):
    """The paged kernel's bf16/int8 arithmetic, one sequence and chunk at a
    time: q [B, Hq, D] bf16; pools [N, bs, Hkv, D] bf16 or int8 dicts."""
    quant = isinstance(k_pool, dict)
    kq, ks = (k_pool["q"], k_pool["scale"]) if quant else (k_pool, None)
    vq, vs = (v_pool["q"], v_pool["scale"]) if quant else (v_pool, None)
    b, hq, d = q.shape
    n, bs, hkv, _ = kq.shape
    chunk = 32
    qg = (q.float() * d ** -0.5).bfloat16().float().reshape(b, hkv, hq // hkv, d)
    out = torch.zeros(b, hkv, hq // hkv, d)
    for i in range(b):
        length = int(lengths[i])
        m = torch.full((hkv, hq // hkv), NEG_INF)
        l = torch.zeros(hkv, hq // hkv)
        acc = torch.zeros(hkv, hq // hkv, d)
        for page in range(-(-length // bs)):
            blk = int(table[i, page].clamp(0, n - 1))
            for r0 in range(0, bs, chunk):
                j = torch.arange(r0, r0 + chunk)
                ok = (j < bs) & (page * bs + j < length)
                rows = torch.where(ok, j, 0)
                kt = torch.where(ok[:, None, None], kq[blk, rows].float(), 0.0)
                vt = torch.where(ok[:, None, None], vq[blk, rows].float(), 0.0)
                sc = torch.einsum("grd,kgd->grk", qg[i], kt)
                if quant:
                    sc = sc * torch.where(ok[:, None], ks[blk, rows], 0.0).T[:, None, :]
                sc = torch.where(ok, sc, NEG_INF)
                m_new = torch.maximum(m, sc.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.where(ok, torch.exp(sc - m_new[..., None]), 0.0)
                l = alpha * l + p.sum(-1)
                m = m_new
                if quant:
                    p = torch.where(ok, p * torch.where(ok[:, None], vs[blk, rows], 0.0)
                                    .T[:, None, :], 0.0)
                acc = alpha[..., None] * acc + _pv(p, vt, "grk,kgd->grd", split)
        out[i] = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, hq, d).to(q.dtype)


def emulate_contiguous(q, k_cache, v_cache, lengths, *, q_split, split=True,
                       rows_per_split=64, chunk=32, warps=4):
    """The decode body's arithmetic over a contiguous cache (kernels B and
    C): q [B, Hq, D] bf16; caches [B, T, Hkv, D] bf16 or int8 dicts. Each
    split of ``rows_per_split`` rows (whole chunks) deals its 32-row chunks
    to ``warps`` warps, each with its own online softmax; the warps' states
    merge per split and the splits' in the combine. q is rounded to bf16
    after scaling (B) or, with ``q_split``, split into bf16 hi + lo whose
    products are summed in fp32 (C)."""
    quant = isinstance(k_cache, dict)
    kq, ks = (k_cache["q"], k_cache["scale"]) if quant else (k_cache, None)
    vq, vs = (v_cache["q"], v_cache["scale"]) if quant else (v_cache, None)
    b, t, hkv, d = kq.shape
    n_rep = q.shape[1] // hkv
    qs = (q.float() * d ** -0.5).reshape(b, hkv, n_rep, d)
    hi = qs.bfloat16().float()
    lo = (qs - hi).bfloat16().float()

    def merge(states):
        m = torch.stack([s[0] for s in states]).amax(0)
        f = [torch.exp(s[0] - m) for s in states]
        return (m, sum(s[1] * fi for s, fi in zip(states, f)),
                sum(s[2] * fi[..., None] for s, fi in zip(states, f)))

    out = torch.zeros(b, hkv, n_rep, d)
    for i in range(b):
        length = min(int(lengths[i]), t)
        parts = []
        for t_begin in range(0, length, rows_per_split):
            n_chunks = -(-(min(length, t_begin + rows_per_split) - t_begin) // chunk)
            states = []
            for w in range(warps):
                m = torch.full((hkv, n_rep), NEG_INF)
                l = torch.zeros(hkv, n_rep)
                acc = torch.zeros(hkv, n_rep, d)
                for c in range(w, n_chunks, warps):
                    j = t_begin + c * chunk + torch.arange(chunk)
                    ok = j < length
                    rows = torch.where(ok, j, 0)
                    kt = torch.where(ok[:, None, None], kq[i, rows].float(), 0.0)
                    vt = torch.where(ok[:, None, None], vq[i, rows].float(), 0.0)
                    sc = torch.einsum("grd,kgd->grk", hi[i], kt)
                    if q_split:
                        sc = sc + torch.einsum("grd,kgd->grk", lo[i], kt)
                    if quant:
                        sc = sc * torch.where(ok[:, None], ks[i, rows], 0.0).T[:, None, :]
                    sc = torch.where(ok, sc, NEG_INF)
                    m_new = torch.maximum(m, sc.amax(-1))
                    alpha = torch.exp(m - m_new)
                    p = torch.where(ok, torch.exp(sc - m_new[..., None]), 0.0)
                    l = alpha * l + p.sum(-1)
                    m = m_new
                    if quant:
                        p = torch.where(ok, p * torch.where(ok[:, None], vs[i, rows], 0.0)
                                        .T[:, None, :], 0.0)
                    acc = alpha[..., None] * acc + _pv(p, vt, "grk,kgd->grd", split)
                states.append((m, l, acc))
            parts.append(merge(states))
        if parts:
            _, l, acc = merge(parts)
            out[i] = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, hkv * n_rep, d).to(q.dtype)


def _ratio(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| / (atol + rtol |ref|): at most 1 within KERNEL_TOL."""
    rtol, atol = KERNEL_TOL[torch.bfloat16]
    err = (out.float() - ref.float()).abs()
    return float((err / (atol + rtol * ref.float().abs())).max())


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16()


@pytest.mark.parametrize("s,hq,hkv,causal,kv_len", [
    (1024, 2, 1, True, None),
    (1024, 2, 2, True, None),
    (1000, 2, 1, False, 900),
])
def test_kernel_a_split_within_tol_bf16_p_outside(s, hq, hkv, causal, kv_len):
    rng = np.random.default_rng(s + hq + hkv)
    q, k, v = (_bf16(rng, 1, s, h, 64) for h in (hq, hkv, hkv))
    ref = causal_attention(q, k, v, causal=causal, kv_len=kv_len)
    split = emulate_kernel_a(q, k, v, causal=causal, kv_len=kv_len)
    once = emulate_kernel_a(q, k, v, causal=causal, kv_len=kv_len, split=False)
    assert torch.isfinite(split.float()).all()
    assert _ratio(split, ref) <= 1.0
    assert _ratio(once, ref) > 1.0


def _paged_inputs(rng, b, lens, quant, bs, p):
    """q [b, 32, 64] and pools [n, bs, 8, 64] with each sequence's pages
    shuffled through the pool, NaN in the sink block 0, in unowned pages and
    past every length (in the scales for int8), as chip_smoke plants them."""
    n = b * p + 12
    q = _bf16(rng, b, 32, 64)
    k, v = _bf16(rng, n, bs, 8, 64), _bf16(rng, n, bs, 8, 64)
    table = torch.from_numpy(rng.permutation(n - 1)[:b * p].reshape(b, p) + 1).int()
    lengths = torch.tensor(lens, dtype=torch.int32)
    live = torch.zeros(n, bs, dtype=torch.bool)
    rows = torch.arange(p * bs)
    for i in range(b):
        ok = rows < lengths[i]
        live[table[i].repeat_interleave(bs)[ok], (rows % bs)[ok]] = True
    if quant:
        k, v = _quantize_kv(k), _quantize_kv(v)
    for c in (k, v):
        (c["scale"] if quant else c)[~live] = float("nan")
    return q, k, v, table, lengths


@pytest.mark.parametrize("quant,bs", [(False, 64), (True, 64), (False, 48)])
def test_paged_split_within_tol_bf16_p_outside(quant, bs):
    rng = np.random.default_rng(7 + bs + quant)
    q, k, v, table, lengths = _paged_inputs(rng, 4, [300, 1900, 777, 1024], quant, bs,
                                            -(-1900 // bs))
    ref = paged_decode_attention_xla(q, k, v, table, lengths)
    split = emulate_paged(q, k, v, table, lengths)
    once = emulate_paged(q, k, v, table, lengths, split=False)
    assert torch.isfinite(split.float()).all()
    assert _ratio(split, ref) <= 1.0
    assert _ratio(once, ref) > 1.0


def _contiguous_inputs(rng, b, t, hq, hkv, d, lens, quant=False, sharp=1.0):
    """q [b, hq, d] (times ``sharp``) and caches [b, t, hkv, d] in bf16 (or
    int8 with scales), NaN past every length (in the scales for int8)."""
    q = (_bf16(rng, b, hq, d).float() * sharp).bfloat16()
    k, v = _bf16(rng, b, t, hkv, d), _bf16(rng, b, t, hkv, d)
    lengths = torch.tensor(lens, dtype=torch.int32)
    if quant:
        k, v = _quantize_kv(k), _quantize_kv(v)
    dead = torch.arange(t)[None, :] >= lengths[:, None]
    for c in (k, v):
        (c["scale"] if quant else c)[dead] = float("nan")
    return q, k, v, lengths


@pytest.mark.parametrize("d,quant", [(64, False), (64, True), (128, False), (128, True)])
def test_contiguous_kernel_b_within_tol(d, quant):
    """Kernel B on the decode body (q rounded, as its plain version rounds
    it): lengths 0, 1, 31, 32, 33 and T = 200 (not a multiple of 32), NaN
    past each, n_rep 4, splits of 64 rows; within ``KERNEL_TOL`` of
    ``decode_attention``, and outside it with P rounded once to bf16."""
    rng = np.random.default_rng(d + quant)
    lens = [0, 1, 31, 32, 33, 200, 137]
    q, k, v, lengths = _contiguous_inputs(rng, len(lens), 200, 32, 8, d, lens, quant)
    ref = decode_attention(q, k, v, lengths)
    got = emulate_contiguous(q, k, v, lengths, q_split=False)
    once = emulate_contiguous(q, k, v, lengths, q_split=False, split=False)
    assert torch.isfinite(got.float()).all() and (got[0] == 0).all()
    assert _ratio(got, ref) <= 1.0
    assert _ratio(once, ref) > 1.0


@pytest.mark.parametrize("d,hq,rows_per_split", [(64, 32, 64), (128, 32, 128), (64, 64, 416)])
def test_contiguous_kernel_c_within_tol(d, hq, rows_per_split):
    """Kernel C on the decode body (q split into bf16 hi + lo): lengths 0,
    1, 31, 32, 33 and T = 200, NaN past each, n_rep 4 and 8; within
    ``KERNEL_TOL`` of ``ragged_decode_attention_plain``, zeros at length 0."""
    rng = np.random.default_rng(3 * d + hq)
    lens = [0, 1, 31, 32, 33, 200, 137]
    q, k, v, lengths = _contiguous_inputs(rng, len(lens), 200, hq, 8, d, lens)
    ref = ragged_decode_attention_plain(q, k, v, lengths)
    got = emulate_contiguous(q, k, v, lengths, q_split=True,
                             rows_per_split=rows_per_split)
    assert torch.isfinite(got.float()).all() and (got[0] == 0).all()
    assert _ratio(got, ref) <= 1.0


def test_kernel_c_needs_the_q_split():
    """At D = 128 (scale 128^-1/2, not a power of two) with a sharp softmax
    (q x 4), C's emulation with the scaled query rounded once to bf16, as B
    rounds it, falls outside C's ``KERNEL_TOL``; with the hi/lo split it
    lies inside."""
    rng = np.random.default_rng(11)
    q, k, v, lengths = _contiguous_inputs(rng, 2, 256, 8, 2, 128, [256, 200], sharp=4.0)
    ref = ragged_decode_attention_plain(q, k, v, lengths)
    assert _ratio(emulate_contiguous(q, k, v, lengths, q_split=True), ref) <= 1.0
    assert _ratio(emulate_contiguous(q, k, v, lengths, q_split=False), ref) > 1.0


# --- kernel A' (attention's backward) on the tensor cores ----------------------

LOG2E = 1.4426950408889634


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def emulate_kernel_a_bwd(q, k, v, g, *, kv_len=None, o_residual=True, tile=64):
    """Kernel A''s bf16 arithmetic: dq, dk, dv (bf16) of causal attention for
    the cotangent g; q, g [B, S, Hq, D] and k, v [B, S, Hkv, D] in bf16.

    Kernel A's fp32 output O gives the bf16 output O_hi and, with
    ``o_residual``, its residual O_lo = bf16(O - O_hi); D = sum(dO * (O_hi +
    O_lo)), or sum(dO * O_hi) without. Rows at or past kv_len are zero, as
    the kernels' copies fill them. For each (key tile, query tile) pair on or
    below the diagonal: S and dP as fp32 products of bf16 operands, P =
    exp2(log2(e) D^-1/2 S - lse) from the base-2 log-sum-exp, dS = P (dP -
    D); P and dS rounded once to bf16 before dV += P^T dO, dK += dS^T Q and
    dQ += dS K, summed in fp32; the group's heads summed into dK and dV; each
    gradient scaled and rounded once."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    n_rep, scale = hq // hkv, d ** -0.5
    n = s if kv_len is None else kv_len
    pos = torch.arange(s)
    live = (pos < n)[:, None]
    qf, gf = (torch.where(live, x.float().transpose(1, 2), 0.0) for x in (q, g))
    kf, vf = (torch.where(live, x.float().repeat_interleave(n_rep, 2).transpose(1, 2), 0.0)
              for x in (k, v))  # [B, Hq, S, D]
    ok = (pos[None, :] <= pos[:, None]) & (pos[None, :] < n)
    sc = (qf @ kf.transpose(-1, -2) * scale).masked_fill(~ok, NEG_INF)
    lse2 = torch.logsumexp(sc, -1) * LOG2E
    o = torch.softmax(sc, -1) @ vf
    o_hi = o.bfloat16().float()
    o_used = o_hi + (o - o_hi).bfloat16().float() if o_residual else o_hi
    delta = (gf * o_used).sum(-1) * live[:, 0]
    dq, dk, dv = torch.zeros_like(qf), torch.zeros_like(kf), torch.zeros_like(vf)
    for k0 in range(0, n, tile):
        kt, vt = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        for q0 in range(k0, n, tile):
            qt, gt = qf[:, :, q0:q0 + tile], gf[:, :, q0:q0 + tile]
            qp, kp = pos[q0:q0 + tile, None], pos[None, k0:k0 + tile]
            sc = torch.exp2(qt @ kt.transpose(-1, -2) * (scale * LOG2E)
                            - lse2[:, :, q0:q0 + tile, None])
            p = torch.where((kp <= qp) & (qp < n), sc, 0.0)
            ds = p * (gt @ vt.transpose(-1, -2) - delta[:, :, q0:q0 + tile, None])
            p, ds = p.bfloat16().float(), ds.bfloat16().float()
            dv[:, :, k0:k0 + tile] += p.transpose(-1, -2) @ gt
            dk[:, :, k0:k0 + tile] += ds.transpose(-1, -2) @ qt
            dq[:, :, q0:q0 + tile] += ds @ kt
    dk, dv = (x.reshape(b, hkv, n_rep, s, d).sum(2) for x in (dk, dv))
    return tuple((x * f).transpose(1, 2).to(q.dtype)
                 for x, f in ((dq, scale), (dk, scale), (dv, 1.0)))


def _bwd_inputs(b, s, hq, hkv, d, seed, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q = (_bf16(rng, b, s, hq, d).float() * q_scale).bfloat16()
    k, v = _bf16(rng, b, s, hkv, d), _bf16(rng, b, s, hkv, d)
    return q, k, v, _bf16(rng, b, s, hq, d)


@pytest.mark.parametrize("b,s,hq,hkv,d,kv_len,q_scale", [
    (2, 256, 4, 1, 64, None, 1.0),     # S a multiple of 64, n_rep 4
    (1, 200, 4, 4, 64, 150, 1.0),      # S not a multiple of 64, kv_len < S, n_rep 1
    (1, 130, 8, 2, 64, 97, 1.0),       # partial tiles on both sides of kv_len
    (1, 192, 4, 1, 128, None, 1.0),    # D = 128
    (1, 333, 8, 2, 128, 301, 4.0),     # D = 128, sharp, kv_len < S
])
def test_kernel_a_bwd_within_grad_tol(one_torch_thread, b, s, hq, hkv, d, kv_len, q_scale):
    q, k, v, g = _bwd_inputs(b, s, hq, hkv, d, seed=s + d, q_scale=q_scale)
    ref = causal_attention_bwd(q, k, v, g, kv_len=kv_len)
    got = emulate_kernel_a_bwd(q, k, v, g, kv_len=kv_len)
    for name, x, r in zip(("dq", "dk", "dv"), got, ref):
        assert torch.isfinite(x.float()).all(), name
        assert grad_tol_ratio(x, r) <= 1.0, (name, grad_tol_ratio(x, r))
    if kv_len is not None:
        assert not got[0][:, kv_len:].any() and not got[1][:, kv_len:].any()


def test_kernel_a_bwd_needs_the_unrounded_o(one_torch_thread):
    """A sharp softmax (q x 4) at S = 1024, Hq 8, Hkv 2, D 64: with D from
    kernel A's bf16 output alone, dq lies outside GRAD_TOL (1.63x here; over
    seeds 0-5 of this shape 0.90-1.63x, outside at five of six), as the first
    design computed D; with D from O_hi + O_lo all three grads lie inside
    (0.44-0.87x over the same seeds). P and dS in bf16 are the same in both."""
    q, k, v, g = _bwd_inputs(1, 1024, 8, 2, 64, seed=5, q_scale=4.0)
    ref = causal_attention_bwd(q, k, v, g)
    got = emulate_kernel_a_bwd(q, k, v, g)
    assert max(grad_tol_ratio(x, r) for x, r in zip(got, ref)) <= 1.0
    rounded = emulate_kernel_a_bwd(q, k, v, g, o_residual=False)
    assert grad_tol_ratio(rounded[0], ref[0]) > 1.0
