"""The port's two attention kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX kernels run
in interpret mode, as tests/test_pallas_*.py run them. The CUDA kernels
themselves are held against the plain versions on the card by
tests/test_torch_gpu.py and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import one_torch_thread  # noqa: F401
from tts_max_tpu.ops.pallas_attention import flash_attention as jax_flash
from tts_max_tpu.ops.pallas_decode import flash_decode_attention as jax_decode
from tts_max_tpu_torch.models.llama import _quantize_kv
from tts_max_tpu_torch.ops.attention import KERNEL_TOL, decode_attention
from tts_max_tpu_torch.ops.flash_attention import flash_attention
from tts_max_tpu_torch.ops.flash_decode import flash_decode_attention


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize(
    "s,hq,hkv,causal",
    [(64, 4, 4, True), (200, 4, 2, True), (96, 8, 2, False), (37, 4, 1, True)],
)
def test_flash_attention_matches_jax(s, hq, hkv, causal):
    """fp32, causal and not, GQA, S not a multiple of the block: atol 1e-5
    (fp32 sum order only)."""
    rng = np.random.default_rng(s)
    q, k, v = (_randn(rng, 2, s, h, 16) for h in (hq, hkv, hkv))
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                    block_q=32, block_k=32, interpret=True)
    ours = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_flash_attention_kv_len_masks_padded_keys():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(_randn(rng, 1, 48, h, 16)) for h in (4, 2, 2))
    out = flash_attention(q, k, v, causal=False, kv_len=30)
    # keys >= kv_len are masked: the same as attending to the first 30 only
    np.testing.assert_allclose(out.numpy(), _noncausal(q, k[:, :30], v[:, :30]),
                               atol=1e-5)


def _noncausal(q, k, v):
    n_rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(n_rep, 2)
    v = v.repeat_interleave(n_rep, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v).numpy()


def _decode_case(seed, b, t, hq, hkv, d, lengths):
    rng = np.random.default_rng(seed)
    q = _randn(rng, b, hq, d)
    k = _randn(rng, b, t, hkv, d)
    v = _randn(rng, b, t, hkv, d)
    # garbage beyond each length: the kernels must never let it through
    for i, n in enumerate(lengths):
        k[i, n:] = 1e4
        v[i, n:] = -1e4
    return q, k, v, np.asarray(lengths, np.int32)


def _jax_cache(x, quant, dtype):
    x = jnp.asarray(x, dtype)
    if not quant:
        return x
    from tts_max_tpu.models.llama import _quantize_kv as jq

    return jq(x)


def _torch_cache(x, quant, dtype):
    x = torch.from_numpy(np.asarray(jnp.asarray(x, dtype).astype(jnp.float32)))
    x = x.to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    return _quantize_kv(x) if quant else x


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_decode_matches_jax(quant, dtype):
    """Contiguous cache, ragged lengths incl. 1 and T, garbage beyond the
    length. fp32 caches: atol 1e-5; bf16 caches (q, K, V rounded to bf16,
    fp32 math, output rounded to bf16): 1e-2, one bf16 ulp."""
    b, t, hq, hkv, d = 3, 64, 8, 2, 16
    q, k, v, lengths = _decode_case(1, b, t, hq, hkv, d, [1, 64, 23])
    ref = jax_decode(jnp.asarray(q, dtype), _jax_cache(k, quant, dtype),
                     _jax_cache(v, quant, dtype), jnp.asarray(lengths),
                     chunk=32, interpret=True)
    qt = torch.from_numpy(q).to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    ours = flash_decode_attention(qt, _torch_cache(k, quant, dtype),
                                  _torch_cache(v, quant, dtype),
                                  torch.from_numpy(lengths))
    tol = 1e-5 if dtype == jnp.float32 else 1e-2
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), atol=tol, rtol=0)
    assert np.isfinite(ours.float().numpy()).all()


@pytest.mark.parametrize("quant", [False, True])
def test_flash_decode_matches_jax_stacked_layer(quant):
    """The JAX kernel's stacked [L, B, T, Hkv, D] form with ``layer=`` against
    the port's contiguous ``cache[layer]`` view, which is how the port's
    decode_step calls kernel B."""
    L, b, t, hq, hkv, d = 3, 2, 32, 4, 2, 16
    rng = np.random.default_rng(2)
    q = _randn(rng, b, hq, d)
    k = _randn(rng, L, b, t, hkv, d)
    v = _randn(rng, L, b, t, hkv, d)
    lengths = np.asarray([5, 32], np.int32)
    for layer in (0, 2):
        ref = jax_decode(jnp.asarray(q), _jax_cache(k, quant, jnp.float32),
                         _jax_cache(v, quant, jnp.float32), jnp.asarray(lengths),
                         layer=jnp.int32(layer), chunk=16, interpret=True)
        kc = _torch_cache(k, quant, jnp.float32)
        vc = _torch_cache(v, quant, jnp.float32)
        kl = {n: x[layer] for n, x in kc.items()} if quant else kc[layer]
        vl = {n: x[layer] for n, x in vc.items()} if quant else vc[layer]
        ours = flash_decode_attention(torch.from_numpy(q), kl, vl,
                                      torch.from_numpy(lengths))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_decode_plain_ignores_nan_beyond_length():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_randn(rng, 2, 4, 16))
    k = torch.from_numpy(_randn(rng, 2, 16, 2, 16))
    v = torch.from_numpy(_randn(rng, 2, 16, 2, 16))
    lengths = torch.tensor([3, 16], dtype=torch.int32)
    clean = decode_attention(q, k, v, lengths)
    k[0, 3:], v[0, 3:] = float("nan"), float("nan")
    np.testing.assert_array_equal(decode_attention(q, k, v, lengths).numpy(),
                                  clean.numpy())


@pytest.mark.parametrize("drop", [0, 64, 1357])
def test_kernel_tol_rejects_a_dropped_row(drop):
    """At kernel B's main-path shape (Llama-3.2-1B, request (c) of
    chip_smoke.py: T 1536, length 1358, splits of 128 rows) the tolerance a
    kernel is held to accepts the plain output moved by one bf16 ulp either
    way and rejects it with one live row left out."""
    rng = np.random.default_rng(drop)
    t, n = 1536, 1358
    q = torch.from_numpy(_randn(rng, 1, 32, 64)).bfloat16()
    k, v = (torch.from_numpy(_randn(rng, 1, t, 8, 64)).bfloat16() for _ in range(2))
    lengths = torch.tensor([n], dtype=torch.int32)
    ref = decode_attention(q, k, v, lengths)
    rtol, atol = KERNEL_TOL[torch.bfloat16]
    limit = atol + rtol * ref.float().abs()
    for step in (1, -1):
        moved = (ref.view(torch.int16) + step).view(torch.bfloat16)
        assert ((moved.float() - ref.float()).abs() <= limit).all()
    keep = [i for i in range(t) if i != drop]
    dropped = decode_attention(q, k[:, keep], v[:, keep], lengths - 1)
    assert not ((dropped.float() - ref.float()).abs() <= limit).all()


def test_wrappers_reject_bad_shapes():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 8, 1, 16), torch.zeros(1, 8, 1, 16), kv_len=9)
    with pytest.raises(ValueError):
        flash_decode_attention(torch.zeros(2, 4, 16), torch.zeros(2, 8, 2, 16),
                               torch.zeros(2, 8, 2, 16), torch.ones(3, dtype=torch.int32))
