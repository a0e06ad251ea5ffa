"""The gradient of the port's ``flash_attention`` (a ``torch.autograd.Function``)
against JAX's: the Function's CPU path (the plain backward,
``ops.attention.causal_attention_bwd``) against ``jax.grad`` through the JAX
package's Pallas ``flash_attention`` in interpret mode, and the ``kv_len``
rule against its ``custom_vjp`` (``_flash_attention_bh``) called directly. A
CPU model of kernel A''s tiled walk (``csrc/flash_attention_bwd.cu``: tile
loops with the causal trip counts, P recomputed from the base-2
log-sum-exp, D = sum(dO * O)) is held against the plain backward, and
``GRAD_TOL`` is shown to reject a dropped key row and a dropped query row.

Every comparison uses ``grad_tol_ratio`` under ``GRAD_TOL`` (fp32: |g - ref|
<= 1e-4 |ref| + 1e-5 max|ref|; the rationale is beside it in
``ops/attention.py``). Inputs are seeded numpy arrays handed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import one_torch_thread  # noqa: F401
from tts_max_tpu.ops.pallas_attention import _flash_attention_bh
from tts_max_tpu.ops.pallas_attention import flash_attention as jax_flash
from tts_max_tpu_torch.ops.attention import (
    GRAD_TOL,
    causal_attention,
    causal_attention_bwd,
    grad_tol_ratio,
)
from tts_max_tpu_torch.ops.flash_attention import flash_attention

LOG2E = 1.4426950408889634


def _inputs(b, s, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for h in (hq, hkv, hkv))
    g = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    return q, k, v, g


def _port_grads(q, k, v, g, kv_len=None):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = flash_attention(qt, kt, vt, causal=True, kv_len=kv_len)
    assert out.grad_fn is not None
    (out * torch.tensor(g)).sum().backward()
    return out.detach(), (qt.grad, kt.grad, vt.grad)


def _assert_grads(got, want, what):
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        ratio = grad_tol_ratio(torch.as_tensor(np.array(a)), torch.as_tensor(np.array(r)))
        assert ratio <= 1.0, f"{what} {name}: {ratio:.2f}x GRAD_TOL"


@pytest.mark.parametrize("s,hq,hkv,d", [(16, 4, 2, 64), (40, 4, 4, 64), (128, 4, 2, 64),
                                        (16, 4, 2, 128)])
def test_flash_attention_grad_matches_jax(s, hq, hkv, d):
    q, k, v, g = _inputs(2, s, hq, hkv, d, seed=s + hkv + d)

    def loss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, causal=True, block_q=16, block_k=16) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    out, got = _port_grads(q, k, v, g)
    ref_out = jax_flash(q, k, v, causal=True, block_q=16, block_k=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=1e-5, atol=1e-5)
    _assert_grads(got, want, f"S={s} Hq={hq} Hkv={hkv} D={d}")


def test_kv_len_rule_matches_jax_custom_vjp():
    """kv_len < S: queries at or past kv_len get dq = 0 and add nothing to dk
    and dv (JAX's _bwd cuts to kv_len and pads back with zeros), though
    their forward outputs are not zero."""
    s, h, d, kv_len = 48, 2, 64, 37
    q, k, v, g = _inputs(1, s, h, h, d, seed=7)

    def bh(x):  # [1, S, H, D] -> [H, S, D]
        return jnp.asarray(x[0].transpose(1, 0, 2))

    def loss(qb, kb, vb):
        out = _flash_attention_bh(qb, kb, vb, 16, 16, True, True, kv_len)
        return jnp.sum(out * bh(g))

    want = [np.asarray(x).transpose(1, 0, 2)[None]
            for x in jax.grad(loss, argnums=(0, 1, 2))(bh(q), bh(k), bh(v))]
    out, got = _port_grads(q, k, v, g, kv_len=kv_len)
    _assert_grads(got, want, "kv_len 37 of 48")
    assert not got[0][:, kv_len:].any() and not got[1][:, kv_len:].any()
    assert out[:, kv_len:].abs().max() > 0
    # plain autograd over the whole sequence counts the rows past kv_len
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    (causal_attention(qt, kt, vt, kv_len=kv_len) * torch.tensor(g)).sum().backward()
    assert grad_tol_ratio(kt.grad, got[1]) > 1.0


# --- a CPU model of kernel A''s tiled walk ------------------------------------


def _lse2(q, k, kv_len):
    """Kernel A's base-2 log-sum-exp [B, Hq, S] of the scaled causal scores."""
    b, s, hq, d = q.shape
    kk = k.repeat_interleave(hq // k.shape[2], dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q * d ** -0.5, kk)
    pos = torch.arange(s)
    ok = (pos[None, :] <= pos[:, None]) & (pos[None, :] < kv_len)
    return torch.logsumexp(sc.masked_fill(~ok, -1e30), -1) * LOG2E


def tiled_bwd(q, k, v, out, g, kv_len, bq, bk):
    """dq, dk, dv as flash_attention_bwd.cu computes them, tile by tile:
    bwd_delta, then the dK/dV kernel (a key tile holds dK, dV and walks the
    group's heads and the query tiles from the diagonal to kv_len), then the
    dQ kernel (a query tile walks the key tiles up to the diagonal). Both
    paths walk so; the bf16 kernels cut a tile pair into passes of 32 or 64
    columns, which orders the sums inside a pair only, and their rounding is
    emulated in test_torch_tc_numerics.py."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    n_rep, scale = hq // hkv, d ** -0.5
    lse = _lse2(q, k, kv_len)
    delta = (g * out).sum(-1).transpose(1, 2)  # [B, Hq, S]
    delta[:, :, kv_len:] = 0
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)

    def probs(q0, k0, qt, kt, vt, gt, lse_t, dl_t):
        sc = qt @ kt.T
        dp = gt @ vt.T
        qp = q0 + torch.arange(qt.shape[0])[:, None]
        kp = k0 + torch.arange(kt.shape[0])[None, :]
        ok = (qp < kv_len) & (kp <= qp)
        p = torch.where(ok, torch.exp2(sc * scale * LOG2E - lse_t[:, None]), 0.0)
        return p, p * (dp - dl_t[:, None])

    for bi in range(b):
        for hk in range(hkv):
            for k0 in range(0, s, bk):
                kt, vt = k[bi, k0:k0 + bk, hk], v[bi, k0:k0 + bk, hk]
                kt = torch.where(torch.arange(k0, k0 + kt.shape[0])[:, None] < kv_len, kt, 0)
                vt = torch.where(torch.arange(k0, k0 + vt.shape[0])[:, None] < kv_len, vt, 0)
                acc_k, acc_v = torch.zeros_like(kt), torch.zeros_like(vt)
                for h in range(hk * n_rep, (hk + 1) * n_rep):
                    for q0 in range((k0 // bq) * bq, -(-kv_len // bq) * bq, bq):
                        rows = torch.arange(q0, min(q0 + bq, s))
                        live = (rows < kv_len)[:, None]
                        qt = torch.where(live, q[bi, rows, h], 0)
                        gt = torch.where(live, g[bi, rows, h], 0)
                        p, ds = probs(q0, k0, qt, kt, vt, gt, lse[bi, h, rows],
                                      delta[bi, h, rows])
                        acc_v += p.T @ gt
                        acc_k += ds.T @ qt
                dk[bi, k0:k0 + bk, hk] = acc_k * scale
                dv[bi, k0:k0 + bk, hk] = acc_v
        for h in range(hq):
            hk = h // n_rep
            for q0 in range(0, s, bq):
                rows = torch.arange(q0, min(q0 + bq, s))
                live = (rows < kv_len)[:, None]
                qt = torch.where(live, q[bi, rows, h], 0)
                gt = torch.where(live, g[bi, rows, h], 0)
                acc = torch.zeros_like(qt)
                last = min(q0 + bq, kv_len) if q0 < kv_len else 0
                for k0 in range(0, -(-last // bk) * bk, bk):
                    keys = torch.arange(k0, min(k0 + bk, s))
                    kt = torch.where((keys < kv_len)[:, None], k[bi, keys, hk], 0)
                    vt = torch.where((keys < kv_len)[:, None], v[bi, keys, hk], 0)
                    _, ds = probs(q0, k0, qt, kt, vt, gt, lse[bi, h, rows], delta[bi, h, rows])
                    acc += ds @ kt
                dq[bi, rows, h] = acc * scale
    return dq, dk, dv


@pytest.mark.parametrize("s,hq,hkv,d,kv_len,tiles", [
    (40, 4, 2, 64, None, (16, 16)),
    (128, 4, 2, 64, None, (64, 64)),
    (100, 8, 2, 64, 77, (16, 32)),
    (70, 4, 4, 128, 70, (64, 64)),
])
def test_tiled_model_matches_plain_backward(s, hq, hkv, d, kv_len, tiles):
    q, k, v, g = (torch.tensor(x) for x in _inputs(1, s, hq, hkv, d, seed=s + d))
    n = kv_len or s
    out = causal_attention(q, k, v, kv_len=n)
    got = tiled_bwd(q, k, v, out, g, n, *tiles)
    _assert_grads(got, causal_attention_bwd(q, k, v, g, kv_len=n), f"tiles {tiles}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grad_tol_rejects_a_dropped_row(dtype):
    """At S = 128, Hq 4, Hkv 2, D 64: the plain backward moved by one bf16
    ulp passes GRAD_TOL, but zeroing one key row's dk and dv, or dropping
    one query row's contribution (its cotangent), does not."""
    q, k, v, g = (torch.tensor(x).to(dtype) for x in _inputs(1, 128, 4, 2, 64, seed=3))
    ref = causal_attention_bwd(q, k, v, g)
    if dtype == torch.bfloat16:
        ulp = [x + (x.float().abs() * 2 ** -8).to(dtype) for x in ref]
        assert all(grad_tol_ratio(a, r) <= 1.0 for a, r in zip(ulp, ref))
    for row in (5, 64, 127):
        dk, dv = ref[1].clone(), ref[2].clone()
        dk[:, row], dv[:, row] = 0, 0
        assert grad_tol_ratio(dk, ref[1]) > 1.0 or grad_tol_ratio(dv, ref[2]) > 1.0
        g2 = g.clone()
        g2[:, row] = 0
        drop = causal_attention_bwd(q, k, v, g2)
        assert grad_tol_ratio(drop[2], ref[2]) > 1.0, row
    assert GRAD_TOL[dtype][0] <= 2 ** -7
