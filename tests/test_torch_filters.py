"""The port's alias-free filters against the JAX package's, fp32, on the same
numpy inputs: kaiser taps, up/down-sampling, the plain version of kernel G
(``activation1d_fused``) against the Pallas kernel in interpret mode, and
the unfused composition against JAX's. Also: ``activation1d`` picks its
path by configuration, and a tensor that is neither on the CPU nor on a
CUDA card raises instead of falling back."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import one_torch_thread  # noqa: F401
from tts_max_tpu.models.codec import filters as jf
from tts_max_tpu.ops.pallas_act1d import activation1d_pallas
from tts_max_tpu_torch.models.codec import filters as tf
from tts_max_tpu_torch.ops.act1d import activation1d_fused, activation1d_kernel


def _inputs(b, t, c, seed=0, scale=0.3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    alpha = (rng.standard_normal(c) * scale).astype(np.float32)
    beta = (rng.standard_normal(c) * scale).astype(np.float32)
    return (x, {"alpha": jnp.asarray(alpha), "beta": jnp.asarray(beta)},
            {"alpha": torch.from_numpy(alpha), "beta": torch.from_numpy(beta)})


@pytest.mark.parametrize("cutoff,half_width,k", [(0.25, 0.3, 12), (0.5 / 3, 0.6 / 3, 18),
                                                 (0.5, 0.6, 7), (0.0, 0.3, 12)])
def test_kaiser_taps_equal_jax(cutoff, half_width, k):
    np.testing.assert_array_equal(tf.kaiser_sinc_filter1d(cutoff, half_width, k),
                                  jf.kaiser_sinc_filter1d(cutoff, half_width, k))


@pytest.mark.parametrize("b,t,c,tb", [(2, 64, 4, 32), (1, 100, 8, 32), (3, 513, 16, 128),
                                      (2, 31, 4, 32), (1, 8, 4, 32)])
def test_fused_matches_pallas_kernel(b, t, c, tb):
    """The shapes of tests/test_pallas_act1d.py."""
    x, jp, tp = _inputs(b, t, c)
    want = np.asarray(activation1d_pallas(jnp.asarray(x), jp, tb=tb, interpret=True))
    got = activation1d_fused(torch.from_numpy(x), tp).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)


@pytest.mark.parametrize("kw", [dict(fused=False), dict(up_kernel=8, down_kernel=8),
                                dict(up_ratio=3, down_ratio=3)])
def test_unfused_matches_jax(kw, monkeypatch):
    """Against JAX's dilated-conv upsample: its CPU-only polyphase branch
    (filters.py:94) is right for 12 taps only (see the next test)."""
    monkeypatch.setattr(jf.jax, "default_backend", lambda: "tpu")
    x, jp, tp = _inputs(2, 200, 8, seed=1, scale=0.2)
    want = np.asarray(jf.activation1d(jnp.asarray(x), jp, **kw))
    got = tf.activation1d(torch.from_numpy(x), tp, **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("ratio", [2, 3])
def test_up_and_downsample_match_jax(ratio):
    x = np.random.default_rng(2).standard_normal((2, 50, 3)).astype(np.float32)
    up = tf.upsample1d(torch.from_numpy(x), ratio).numpy()
    np.testing.assert_allclose(up, np.asarray(jf.upsample1d(jnp.asarray(x), ratio)), atol=1e-5)
    down = tf.downsample1d(torch.from_numpy(x), ratio).numpy()
    np.testing.assert_allclose(down, np.asarray(jf.downsample1d(jnp.asarray(x), ratio)),
                               atol=1e-5)


@pytest.mark.parametrize("k", [8, 12, 16])
def test_upsample_is_the_depthwise_conv_transpose(k):
    """The reference's UpSample1d: 2 x conv_transpose1d of the replicate-
    padded signal, cropped. JAX's CPU polyphase branch misses it by ~3.6
    at 8 and 16 taps; the port and JAX's dilated-conv path agree with it."""
    x = np.random.default_rng(5).standard_normal((2, 50, 3)).astype(np.float32)
    taps = torch.from_numpy(tf.kaiser_sinc_filter1d(0.25, 0.3, k).copy())
    pad = k // 2 - 1
    xp = torch.nn.functional.pad(torch.from_numpy(x).transpose(1, 2), (pad, pad),
                                 mode="replicate")
    ref = 2 * torch.nn.functional.conv_transpose1d(
        xp, taps.view(1, 1, -1).expand(3, -1, -1), stride=2, groups=3)
    ref = ref[..., 2 * pad + (k - 2) // 2: -(2 * pad + (k - 1) // 2)].transpose(1, 2)
    np.testing.assert_allclose(tf.upsample1d(torch.from_numpy(x), 2, k).numpy(),
                               ref.numpy(), atol=1e-5)


def test_snake_beta_matches_jax():
    x, jp, tp = _inputs(2, 9, 5, seed=3)
    x = x * 20  # arguments well past unit scale
    want = np.asarray(jf.snake_beta(jnp.asarray(x), jp["alpha"], jp["beta"]))
    got = tf.snake_beta(torch.from_numpy(x), tp["alpha"], tp["beta"]).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-6)
    np.testing.assert_allclose(tf.snake(torch.from_numpy(x), tp["alpha"]).numpy(),
                               np.asarray(jf.snake(jnp.asarray(x), jp["alpha"])),
                               atol=2e-5, rtol=1e-6)


def test_standard_configuration_runs_the_plain_version_of_g_on_cpu():
    x, _, tp = _inputs(1, 40, 4, seed=4)
    before = activation1d_kernel.launches
    got = tf.activation1d(torch.from_numpy(x), tp)
    torch.testing.assert_close(got, activation1d_fused(torch.from_numpy(x), tp),
                               rtol=0, atol=0)
    assert activation1d_kernel.launches == before  # the CPU path launches nothing


def test_kernel_wrapper_raises_instead_of_falling_back():
    x, _, tp = _inputs(1, 10, 4)
    meta = torch.empty(1, 10, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        activation1d_kernel(meta, {k: v.to("meta") for k, v in tp.items()})
    with pytest.raises(ValueError, match="need"):
        activation1d_kernel(torch.from_numpy(x), {"alpha": tp["alpha"][:3],
                                                  "beta": tp["beta"]})
