"""Kernel C, the ragged decode attention, against the JAX package's Pallas
``ragged_decode_attention`` in interpret mode, on the CPU (where the port's
wrapper runs its plain version). Inputs are drawn with numpy from one seed
and handed to both. The CUDA kernel itself is held against the plain
version on the card by tests/test_torch_gpu.py and ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import one_torch_thread  # noqa: F401
from tts_max_tpu.ops.pallas_decode import ragged_decode_attention as jax_ragged
from tts_max_tpu_torch.ops.attention import KERNEL_TOL, decode_attention
from tts_max_tpu_torch.ops.ragged_decode import ragged_decode_attention


def _case(seed, b, t, hq, hkv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, t, hkv, d)).astype(np.float32) for _ in range(2))
    return q, k, v


def _jax(q, k, v, lengths, dtype=jnp.float32):
    out = jax_ragged(jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
                     jnp.asarray(lengths, jnp.int32), block_k=128, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _ours(q, k, v, lengths, dtype=torch.float32):
    return ragged_decode_attention(
        torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
        torch.from_numpy(v).to(dtype), torch.tensor(lengths, dtype=torch.int32))


@pytest.mark.parametrize("max_len", [128, 200, 384])
def test_ragged_matches_jax_fp32(max_len):
    """fp32, GQA (n_rep 4), T a multiple of 128 and not, lengths 1, 17, T/2
    and T: within 2e-5 (fp32 sum order only)."""
    q, k, v = _case(max_len, 4, max_len, 8, 2, 32)
    lengths = [1, 17, max_len // 2, max_len]
    ours = _ours(q, k, v, lengths)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), _jax(q, k, v, lengths), atol=2e-5, rtol=0)


@pytest.mark.parametrize("n_rep", [1, 4, 8])
def test_ragged_matches_jax_bf16(n_rep):
    """bf16 inputs, fp32 math, one rounding to bf16 at the end: within the
    bf16 ``KERNEL_TOL`` (1e-5 + 2^-7 |ref|, one bf16 ulp)."""
    q, k, v = _case(10 + n_rep, 3, 256, 2 * n_rep, 2, 64)
    lengths = [30, 256, 129]
    ours = _ours(q, k, v, lengths, torch.bfloat16)
    ref = _jax(q, k, v, lengths, jnp.bfloat16)
    assert ours.dtype == torch.bfloat16
    rtol, atol = KERNEL_TOL[torch.bfloat16]
    np.testing.assert_allclose(ours.float().numpy(), ref, atol=atol, rtol=rtol)


def test_ragged_length_zero_gives_zeros():
    q, k, v = _case(3, 2, 200, 4, 2, 16)
    ours = _ours(q, k, v, [0, 50])
    ref = _jax(q, k, v, [0, 50])
    assert (ours[0] == 0).all() and (ref[0] == 0).all()
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-5, rtol=0)


def test_ragged_ignores_garbage_beyond_length():
    """Rows past each length poisoned with +-1e4 leave both results as they
    were (as tests/test_pallas_decode.py checks JAX's); NaN there leaves the
    port's unchanged too (JAX multiplies p = 0 by such rows, the port never
    reads them)."""
    q, k, v = _case(4, 2, 200, 4, 2, 16)
    lengths = [10, 131]
    clean_ours, clean_ref = _ours(q, k, v, lengths), _jax(q, k, v, lengths)
    k2, v2 = k.copy(), v.copy()
    for i, n in enumerate(lengths):
        k2[i, n:], v2[i, n:] = 1e4, -1e4
    np.testing.assert_allclose(_ours(q, k2, v2, lengths).numpy(), clean_ours.numpy(),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(_jax(q, k2, v2, lengths), clean_ref, atol=1e-6, rtol=0)
    for i, n in enumerate(lengths):
        k2[i, n:], v2[i, n:] = np.nan, np.nan
    np.testing.assert_array_equal(_ours(q, k2, v2, lengths).numpy(), clean_ours.numpy())


def test_ragged_bf16_differs_from_kernel_b_where_q_rounding_matters():
    """C keeps the scaled query in fp32; B rounds it to bf16 first. With a
    head_dim whose scale is not a power of two (D = 48: 48^-1/2), the two
    bf16 results differ by more than C's own tolerance somewhere, so the two
    plain versions must stay apart; C's agrees with JAX's ragged kernel."""
    q, k, v = _case(5, 2, 256, 8, 2, 48)
    q *= 4.0  # sharp softmax: the query's rounding moves the result
    lengths = [256, 200]
    ours = _ours(q, k, v, lengths, torch.bfloat16)
    b_plain = decode_attention(torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16(),
                               torch.from_numpy(v).bfloat16(),
                               torch.tensor(lengths, dtype=torch.int32))
    rtol, atol = KERNEL_TOL[torch.bfloat16]
    ref = _jax(q, k, v, lengths, jnp.bfloat16)
    np.testing.assert_allclose(ours.float().numpy(), ref, atol=atol, rtol=rtol)
    limit = atol + rtol * np.abs(ref)
    assert (np.abs(b_plain.float().numpy() - ref) > limit).any()


def test_ragged_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(2, 8, 64)
    k = torch.zeros(2, 16, 2, 64)
    lengths = torch.ones(2, dtype=torch.int32)
    int8 = {"q": torch.zeros(2, 16, 2, 64, dtype=torch.int8), "scale": torch.ones(2, 16, 2)}
    with pytest.raises(ValueError, match="int8"):
        ragged_decode_attention(q, int8, int8, lengths)
    with pytest.raises(ValueError, match="block_k"):
        ragged_decode_attention(q, k, k, lengths, block_k=0)
    # block_k is the JAX kernel's TPU tile: any positive value is the same function
    torch.testing.assert_close(ragged_decode_attention(q, k, k, lengths, block_k=64),
                               ragged_decode_attention(q, k, k, lengths), rtol=0, atol=0)
    with pytest.raises(ValueError):
        ragged_decode_attention(q, k, k, torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        ragged_decode_attention(torch.zeros(2, 3, 64), k, k, lengths)
