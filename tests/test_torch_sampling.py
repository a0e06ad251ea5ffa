"""The port's sampling against the JAX package's on fixed logits and counts,
for one SamplingParams per batch and for the engine's rowwise path.
Sampled ids are never compared: the two random streams differ."""

import dataclasses

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


# --- the rowwise path of the serving engine -----------------------------------

ROWS = [
    dict(),  # the defaults: T 0.8, top-k 50, penalties
    dict(temperature=0.0),
    dict(temperature=1.3, top_k=0, top_p=0.9),
    dict(temperature=0.7, top_k=7, top_p=0.5, repetition_penalty=1.3,
         frequency_penalty=0.0),
    dict(temperature=1.0, top_k=200),  # clamps to max_top_k
]


def _batched(rows, use_top_p):
    jrows = [js.SamplingParams(**r) for r in rows]
    j = js.BatchedSamplingParams.broadcast(jrows[0], len(rows), max_top_k=64)
    t = ts.BatchedSamplingParams.broadcast(ts.SamplingParams(**rows[0]), len(rows),
                                           max_top_k=64, device="cpu")
    for i, r in enumerate(rows):
        j = j.set_row(i, jrows[i])
        t = t.set_row(i, ts.SamplingParams(**r))
    assert j.use_top_p == t.use_top_p == any(r.get("top_p", 1.0) < 1 for r in rows)
    return (dataclasses.replace(j, use_top_p=use_top_p),
            dataclasses.replace(t, use_top_p=use_top_p))


@pytest.mark.parametrize("use_top_p", [False, True])
@pytest.mark.parametrize("v", [300, 600, 5000])  # 600, 5000: the two-stage top-k
def test_batched_adjusted_logits_masks_and_greedy_match_jax(v, use_top_p):
    logits, counts, gen = _case(4, b=len(ROWS), v=v)
    jb, tb = _batched(ROWS, use_top_p)
    ref = np.asarray(js.adjusted_logits_batched(
        jnp.asarray(logits), jb, jnp.asarray(counts), jnp.asarray(gen)))
    ours = ts.adjusted_logits_batched(torch.from_numpy(logits), tb,
                                      torch.from_numpy(counts),
                                      torch.from_numpy(gen)).numpy()
    np.testing.assert_array_equal(np.isinf(ours), np.isinf(ref))
    finite = np.isfinite(ref)
    np.testing.assert_allclose(ours[finite], ref[finite], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ours.argmax(-1), ref.argmax(-1))
    k = jnp.asarray([r.get("top_k", 50) for r in ROWS], jnp.int32)
    p = np.asarray([r.get("top_p", 1.0) for r in ROWS], np.float32)
    jk = js.top_k_mask_rowwise(jnp.asarray(logits), k, 64)
    tk = ts.top_k_mask_rowwise(torch.from_numpy(logits), torch.from_numpy(np.asarray(k)), 64)
    np.testing.assert_array_equal(np.isinf(tk.numpy()), np.isinf(np.asarray(jk)))
    jp = js.top_p_mask_rowwise(jnp.asarray(logits), jnp.asarray(p))
    tp = ts.top_p_mask_rowwise(torch.from_numpy(logits), torch.from_numpy(p))
    np.testing.assert_array_equal(np.isinf(tp.numpy()), np.isinf(np.asarray(jp)))


def test_top_values_two_stage_is_exact():
    """V = 1000 (not a multiple of the 128-wide groups) with the largest
    values packed into few groups: the two-stage top-k equals a full sort,
    and JAX's."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 1000)).astype(np.float32)
    x[0, 100:140] += 10.0
    x[1, 990:] += 10.0
    for k in (1, 50, 64):
        ours = ts._top_values(torch.from_numpy(x), k).numpy()
        np.testing.assert_array_equal(ours, -np.sort(-x, axis=-1)[:, :k])
        np.testing.assert_array_equal(ours, np.asarray(js._top_values(jnp.asarray(x), k)))


def test_sample_token_batched_rows_are_independent():
    """Greedy rows take the argmax; a sampled row's draw is a function of
    its own key and logits only (slot isolation) and stays in its top-k."""
    logits, counts, gen = _case(5, b=len(ROWS), v=600)
    _, tb = _batched(ROWS, True)
    keys = torch.tensor([[7, 0], [1, 3], [9, 9], [2, 5], [4, 1]])
    lt = torch.from_numpy(logits)
    args = (tb, torch.from_numpy(counts), torch.from_numpy(gen))
    toks = ts.sample_token_batched(keys, lt, *args)
    al = ts.adjusted_logits_batched(lt, *args)
    assert toks[1] == al[1].argmax()
    assert al[torch.arange(len(ROWS)), toks].isfinite().all()
    other = lt.clone()
    other[1:] = torch.randn(len(ROWS) - 1, 600)
    other_keys = keys.clone()
    other_keys[1:, 0] += 100
    assert ts.sample_token_batched(other_keys, other, *args)[0] == toks[0]
    draws = {int(ts.sample_token_batched(torch.tensor([[7, c]] * len(ROWS)), lt, *args)[0])
             for c in range(40)}
    assert len(draws) > 3  # the counter moves the stream
    noise = ts.gumbel_noise(torch.tensor([[3, 1]]), 200_000)
    assert abs(float(noise.mean()) - 0.5772) < 0.02 and abs(float(noise.std()) - 1.2825) < 0.02


def test_sampling_from_overrides_matches_jax():
    d = dict(temperature=0.5)
    assert ts.sampling_from_overrides({}, ts.SamplingParams()) is None
    ours = ts.sampling_from_overrides({"top_p": 0.8, "text": "x"}, ts.SamplingParams(**d))
    ref = js.sampling_from_overrides({"top_p": 0.8, "text": "x"}, js.SamplingParams(**d))
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
