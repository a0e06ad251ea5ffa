"""The port's speculative decoding against the JAX package's, on the CPU.

Same converted fp32 weights (a target and a different draft, from the JAX
seeded init) and prompts. Greedy ids must equal JAX's
``speculative_generate`` and the port's own greedy ``generate`` on the
target, with and without penalties, with a vocab window, with int8 KV and
with int8 weights; a draft equal to the target accepts every candidate;
EOS stops a row. ``sampling_distribution`` is held to JAX's on fixed logits
within 1e-6. The random streams differ from JAX's, so the sampled mode is
checked by its distribution: the first speculative token against the first
token plain ``generate`` draws after the same seed token.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import one_torch_thread  # noqa: F401
from tts_max_tpu.inference import generate as jg
from tts_max_tpu.inference import speculative as jspec
from tts_max_tpu.models import llama as jl
from tts_max_tpu.models import quantization as jq
from tts_max_tpu.ops import sampling as js
from tts_max_tpu_torch import convert
from tts_max_tpu_torch.inference import generate as tg
from tts_max_tpu_torch.inference import speculative as tspec
from tts_max_tpu_torch.models import llama as tl
from tts_max_tpu_torch.models import quantization as tq
from tts_max_tpu_torch.ops import sampling as ts

VOCAB = 64
GREEDY = dict(temperature=0.0, repetition_penalty=1.0, frequency_penalty=0.0)
PENALTIES = dict(temperature=0.0, top_k=0, repetition_penalty=1.3, frequency_penalty=0.5)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jl.tiny_config(vocab_size=VOCAB, max_seq_len=256),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.tiny_config(vocab_size=VOCAB, max_seq_len=256),
                               dtype=torch.float32)
    jt = jl.init_params(jax.random.PRNGKey(0), jcfg)
    jd = jl.init_params(jax.random.PRNGKey(7), jcfg)

    def port(p):
        return convert.llama_from_numpy(jax.tree_util.tree_map(np.asarray, p), tcfg,
                                        device="cpu")

    return jcfg, jt, jd, tcfg, port(jt), port(jd)


def _prompt(seed, b, s, lengths=None):
    toks = np.random.default_rng(seed).integers(1, 60, (b, s)).astype(np.int32)
    return toks, np.asarray(lengths or [s] * b, np.int32)


def _jax_spec(jcfg, jt, jd, toks, lens, sp, **kw):
    res = jspec.speculative_generate(jt, jcfg, jd, jcfg, jnp.asarray(toks), jnp.asarray(lens),
                                     jax.random.PRNGKey(3), sp=js.SamplingParams(**sp), **kw)
    return np.asarray(res.tokens), np.asarray(res.num_generated), int(res.steps)


def _port_spec(tcfg, tt, td, toks, lens, sp, seed=0, **kw):
    res = tspec.speculative_generate(tt, tcfg, td, tcfg, toks, lens,
                                     torch.Generator().manual_seed(seed),
                                     sp=ts.SamplingParams(**sp), device="cpu", **kw)
    return res.tokens.numpy(), res.num_generated.numpy(), res.steps


def _port_generate(tcfg, tt, toks, lens, sp, **kw):
    kw.pop("gamma", None)
    res = tg.generate(tt, tcfg, toks, lens, None, sp=ts.SamplingParams(**sp), device="cpu",
                      **kw)
    return res.tokens.numpy(), res.num_generated.numpy()


@pytest.mark.parametrize("case", [
    dict(sp=GREEDY, gamma=3, lengths=[5, 8]),
    dict(sp=PENALTIES, gamma=4, lengths=[6, 4]),
    dict(sp=GREEDY, gamma=3, vocab_window=(0, VOCAB)),
    dict(sp=PENALTIES, gamma=3, vocab_window=(24, 16)),
    dict(sp=GREEDY, gamma=2, quantized_kv=True),
    dict(sp=PENALTIES, gamma=5, quantized_kv=True, vocab_window=(10, 40), lengths=[3, 8]),
], ids=["greedy", "penalties", "full_window", "narrow_window", "int8_kv", "int8_kv_window"])
def test_greedy_ids_match_jax_and_generate(models, case):
    jcfg, jt, jd, tcfg, tt, td = models
    case = dict(case)
    sp = case.pop("sp")
    toks, lens = _prompt(1, 2, 8, case.pop("lengths", None))
    kw = dict(max_new_tokens=16, eos_id=-1, cache_len=64, **case)
    want, want_n, _ = _jax_spec(jcfg, jt, jd, toks, lens, sp, **kw)
    got, got_n, steps = _port_spec(tcfg, tt, td, toks, lens, sp, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_n, want_n)
    gen, gen_n = _port_generate(tcfg, tt, toks, lens, sp, **kw)
    np.testing.assert_array_equal(got, gen)
    np.testing.assert_array_equal(got_n, gen_n)
    assert 1 <= steps <= 15
    if "vocab_window" in case:
        lo, size = case["vocab_window"]
        assert ((got >= lo) & (got < lo + size)).all()


@pytest.mark.parametrize("mode", ["int8", "int4-g64"])
def test_greedy_ids_match_jax_with_quantized_weights(models, mode):
    """Weights quantized by each package (bitwise-equal leaves): the
    quantized products run in both models and the ids still match."""
    jcfg, jt, jd, tcfg, tt, td = models
    form = dict(bits=8) if mode == "int8" else dict(bits=4, group_size=64)
    toks, lens = _prompt(2, 2, 8, [8, 6])
    kw = dict(max_new_tokens=12, eos_id=-1, gamma=3, cache_len=64)
    want, want_n, _ = _jax_spec(jcfg, jq.quantize_llama_params(jt, **form),
                                jq.quantize_llama_params(jd, **form), toks, lens, GREEDY, **kw)
    qt, qd = tq.quantize_llama_params(tt, **form), tq.quantize_llama_params(td, **form)
    got, got_n, _ = _port_spec(tcfg, qt, qd, toks, lens, GREEDY, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_n, want_n)
    np.testing.assert_array_equal(got, _port_generate(tcfg, qt, toks, lens, GREEDY, **kw)[0])


@pytest.mark.parametrize("n_new,gamma", [(20, 4), (17, 2), (9, 7)])
def test_identical_draft_accepts_everything(models, n_new, gamma):
    """Draft = target, greedy: every candidate is accepted, so one seed token
    and ceil((n - 1) / (gamma + 1)) rounds."""
    jcfg, jt, _, tcfg, tt, _ = models
    toks, lens = _prompt(3, 2, 8)
    kw = dict(max_new_tokens=n_new, eos_id=-1, gamma=gamma, cache_len=64)
    got, got_n, steps = _port_spec(tcfg, tt, tt, toks, lens, GREEDY, **kw)
    assert steps == -(-(n_new - 1) // (gamma + 1))
    np.testing.assert_array_equal(got, _port_generate(tcfg, tt, toks, lens, GREEDY, **kw)[0])
    want, _, want_steps = _jax_spec(jcfg, jt, jt, toks, lens, GREEDY, **kw)
    np.testing.assert_array_equal(got, want)
    assert steps == want_steps
    assert (got_n == n_new).all()


def test_eos_stops_a_row(models):
    """The 5th greedy token of row 0 becomes EOS: row 0 stops there (EOS
    included, pad after), row 1 runs on, as JAX's and generate do."""
    jcfg, jt, jd, tcfg, tt, td = models
    toks, lens = _prompt(4, 2, 6)
    free = _port_generate(tcfg, tt, toks, lens, GREEDY, max_new_tokens=12, eos_id=-1)[0]
    eos = int(free[0, 4])
    kw = dict(max_new_tokens=12, eos_id=eos, gamma=3, cache_len=64, pad_id=0)
    got, got_n, _ = _port_spec(tcfg, tt, td, toks, lens, GREEDY, **kw)
    want, want_n, _ = _jax_spec(jcfg, jt, jd, toks, lens, GREEDY, **kw)
    gen, gen_n = _port_generate(tcfg, tt, toks, lens, GREEDY, **kw)
    n = int(gen_n[0])
    assert n <= 5 and got[0, n - 1] == eos and (got[0, n:] == 0).all()
    np.testing.assert_array_equal(got_n, gen_n)
    np.testing.assert_array_equal(got_n, want_n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sp", [
    dict(temperature=0.0, top_k=0),
    dict(temperature=0.7, top_k=0),
    dict(temperature=1.3, top_k=5),
    dict(temperature=0.9, top_k=0, top_p=0.6),
    dict(temperature=0.8, top_k=10, top_p=0.9, repetition_penalty=1.4, frequency_penalty=0.6),
    dict(temperature=0.0, top_k=3, repetition_penalty=0.7, frequency_penalty=-0.4),
], ids=["greedy", "temperature", "top_k", "top_p", "all", "greedy_penalties"])
def test_sampling_distribution_matches_jax(sp):
    rng = np.random.default_rng(9)
    logits = (rng.standard_normal((4, 96)) * 3).astype(np.float32)
    counts = rng.integers(0, 3, (4, 96)).astype(np.int32)
    gen = rng.integers(0, 2, (4, 96)).astype(np.int32)
    sp = dict(dict(repetition_penalty=1.0, frequency_penalty=0.0), **sp)
    want = np.asarray(js.sampling_distribution(jnp.asarray(logits), js.SamplingParams(**sp),
                                               jnp.asarray(counts), jnp.asarray(gen)))
    got = ts.sampling_distribution(torch.from_numpy(logits), ts.SamplingParams(**sp),
                                   torch.from_numpy(counts), torch.from_numpy(gen)).numpy()
    assert got.dtype == np.float32 and got.shape == (4, 96)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_sampled_first_token_distribution(models):
    """Stochastic exactness: over 2000 independent rows (one prompt), the
    first speculative token after the seed token is distributed as the
    second token of plain ``generate`` on the target (total variation of
    the two empirical distributions, which concentrates near 0.06)."""
    _, _, _, tcfg, tt, td = models
    sp = dict(temperature=1.0, top_k=0, top_p=1.0, repetition_penalty=1.0,
              frequency_penalty=0.0)
    n = 2000
    toks, lens = _prompt(5, 1, 6)
    toks, lens = np.repeat(toks, n, axis=0), np.repeat(lens, n)
    got, _, steps = _port_spec(tcfg, tt, td, toks, lens, sp, seed=6, max_new_tokens=3,
                               eos_id=-1, gamma=2, cache_len=32)
    ref = tg.generate(tt, tcfg, toks, lens, torch.Generator().manual_seed(8),
                      sp=ts.SamplingParams(**sp), max_new_tokens=3, eos_id=-1,
                      device="cpu").tokens.numpy()
    h_got = np.bincount(got[:, 1], minlength=VOCAB) / n
    h_ref = np.bincount(ref[:, 1], minlength=VOCAB) / n
    tv = 0.5 * np.abs(h_got - h_ref).sum()
    assert tv < 0.15, tv
    assert steps >= 1 and len(np.unique(got[:, 1])) > 10


def test_narrow_window_sampled_stays_inside(models):
    _, _, _, tcfg, tt, td = models
    lo, size = 24, 16
    toks, lens = _prompt(6, 3, 6)
    got, got_n, _ = _port_spec(
        tcfg, tt, td, toks, lens,
        dict(temperature=0.9, top_k=8, repetition_penalty=1.2, frequency_penalty=0.4),
        max_new_tokens=12, eos_id=lo + 5, gamma=3, vocab_window=(lo, size))
    for row, k in zip(got, got_n):
        assert 1 <= k <= 12
        assert ((row[:k] >= lo) & (row[:k] < lo + size)).all(), row
        assert (row[k:] == 0).all()


def test_argument_checks(models):
    _, _, _, tcfg, tt, td = models
    toks, lens = _prompt(7, 1, 6)
    kw = dict(sp=ts.SamplingParams(**GREEDY), max_new_tokens=8, eos_id=-1)
    other = dataclasses.replace(tcfg, vocab_size=VOCAB + 1)
    with pytest.raises(ValueError, match="vocabulary"):
        tspec.speculative_generate(tt, tcfg, td, other, toks, lens, None, device="cpu", **kw)
    with pytest.raises(ValueError, match="cache_len"):
        tspec.speculative_generate(tt, tcfg, td, tcfg, toks, lens, None, device="cpu",
                                   cache_len=16, gamma=4, **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tspec.speculative_generate(tt, tcfg, td, tcfg, toks, lens, None, **kw)
    fn = tspec.make_speculative_generate_fn(tcfg, tcfg, ts.SamplingParams(**GREEDY), 8, -1,
                                            gamma=3, device="cpu")
    res = fn(tt, td, toks, lens, None)
    np.testing.assert_array_equal(
        res.tokens.numpy(), _port_generate(tcfg, tt, toks, lens, GREEDY, max_new_tokens=8,
                                           eos_id=-1)[0])
