"""The port's sampling against the JAX package's on fixed logits and counts.
Sampled ids are never compared: the two random streams differ."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_max_tpu.ops import sampling as js
from tts_max_tpu_torch.ops import sampling as ts


def _case(seed, b=3, v=600):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    logits[0, :5] = logits[0, 5]  # ties at the top-k boundary survive in both
    counts = rng.integers(0, 3, (b, v)).astype(np.int32)
    gen = (counts * rng.integers(0, 2, (b, v))).astype(np.int32)
    return logits, counts, gen


@pytest.mark.parametrize(
    "params",
    [
        dict(),  # the InferenceSettings defaults: T 0.8, top-k 50, penalties
        dict(temperature=0.0),
        dict(temperature=1.3, top_k=0, top_p=0.9),
        dict(temperature=0.7, top_k=7, top_p=0.5, repetition_penalty=1.3,
             frequency_penalty=0.0),
    ],
)
def test_adjusted_logits_match_jax(params):
    logits, counts, gen = _case(0)
    ref = js.adjusted_logits(jnp.asarray(logits), js.SamplingParams(**params),
                             jnp.asarray(counts), jnp.asarray(gen))
    ours = ts.adjusted_logits(torch.from_numpy(logits), ts.SamplingParams(**params),
                              torch.from_numpy(counts), torch.from_numpy(gen))
    ref = np.asarray(ref)
    np.testing.assert_array_equal(np.isinf(ours.numpy()), np.isinf(ref))
    finite = np.isfinite(ref)
    np.testing.assert_allclose(ours.numpy()[finite], ref[finite], rtol=1e-6, atol=1e-6)


def test_windowed_counts_and_logits_match_jax():
    """Counts in vocab-window space drop ids outside the window; the
    adjusted window logits then agree as in the full vocab."""
    rng = np.random.default_rng(1)
    window = (100, 300)
    tokens = rng.integers(0, 600, (2, 50)).astype(np.int32)
    mask = np.arange(50)[None, :] < np.asarray([50, 31])[:, None]
    ref = js.counts_from_tokens_windowed(jnp.asarray(tokens), jnp.asarray(mask), window)
    ours = ts.counts_from_tokens_windowed(torch.from_numpy(tokens),
                                          torch.from_numpy(mask), window)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    full_ref = js.counts_from_tokens(jnp.asarray(tokens), jnp.asarray(mask), 600)
    full = ts.counts_from_tokens(torch.from_numpy(tokens), torch.from_numpy(mask), 600)
    np.testing.assert_array_equal(full.numpy(), np.asarray(full_ref))

    logits = rng.standard_normal((2, 300)).astype(np.float32)
    sp = dict(temperature=0.9, top_k=20)
    a = np.asarray(js.adjusted_logits(jnp.asarray(logits), js.SamplingParams(**sp),
                                      ref, jnp.zeros_like(ref)))
    b = ts.adjusted_logits(torch.from_numpy(logits), ts.SamplingParams(**sp),
                           ours, torch.zeros_like(ours)).numpy()
    np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
    np.testing.assert_allclose(b[np.isfinite(a)], a[np.isfinite(a)], rtol=1e-6, atol=1e-6)


def test_sample_token_stays_in_top_k():
    logits, counts, gen = _case(2)
    sp = ts.SamplingParams(temperature=1.0, top_k=5)
    allowed = ts.adjusted_logits(torch.from_numpy(logits), sp).isfinite()
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = ts.sample_token(g, torch.from_numpy(logits), sp)
        assert allowed[torch.arange(3), tok].all()
