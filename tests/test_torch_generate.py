"""Greedy generation through the port against the JAX package's generate.

With temperature 0 (the penalties still apply) the ids must be identical,
against the JAX loop both without and with its delta-KV stages
(``delta_k=32``), covering the vocab window, min_new_tokens and an early
EOS on one row.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import one_torch_thread  # noqa: F401
from tts_max_tpu.inference import generate as jg
from tts_max_tpu.models import llama as jl
from tts_max_tpu.ops import sampling as js
from tts_max_tpu_torch import convert
from tts_max_tpu_torch.inference import generate as tg
from tts_max_tpu_torch.models import llama as tl
from tts_max_tpu_torch.ops import sampling as ts

VOCAB = 320
WINDOW = (40, 250)
GREEDY = dict(temperature=0.0, repetition_penalty=1.3, frequency_penalty=0.4)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jl.tiny_config(vocab_size=VOCAB), dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.tiny_config(vocab_size=VOCAB), dtype=torch.float32)
    jp = jl.init_params(jax.random.PRNGKey(3), jcfg)
    tp = convert.llama_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                  device="cpu")
    toks = np.random.default_rng(0).integers(0, VOCAB, (2, 20)).astype(np.int32)
    lengths = np.asarray([20, 13], np.int32)
    return jcfg, jp, tcfg, tp, toks, lengths


def _jax(models, delta_k, **kw):
    jcfg, jp, _, _, toks, lengths = models
    res = jg.generate(jp, jcfg, jnp.asarray(toks), jnp.asarray(lengths),
                      jax.random.PRNGKey(0), sp=js.SamplingParams(**GREEDY),
                      delta_k=delta_k, **kw)
    return np.asarray(res.tokens), np.asarray(res.num_generated)


def _torch(models, **kw):
    _, _, tcfg, tp, toks, lengths = models
    res = tg.generate(tp, tcfg, toks, lengths, None, sp=ts.SamplingParams(**GREEDY),
                      device="cpu", **kw)
    return res.tokens.numpy(), res.num_generated.numpy(), res.steps


@pytest.mark.parametrize("quantized_kv", [False, True])
def test_greedy_ids_match_jax(models, quantized_kv):
    """Full vocab and the vocab window, no EOS: ids identical to JAX's
    conventional loop. (int8 KV against JAX without delta-KV: the delta
    path attends the current window unquantized.)"""
    for window in (None, WINDOW):
        kw = dict(max_new_tokens=12, eos_id=-1, vocab_window=window,
                  quantized_kv=quantized_kv)
        ref, ref_n = _jax(models, None, **kw)
        ours, n, steps = _torch(models, **kw)
        np.testing.assert_array_equal(ours, ref)
        np.testing.assert_array_equal(n, ref_n)
        assert steps == 12


def test_greedy_ids_match_jax_eos_min_tokens_delta(models):
    """Early EOS on one row, EOS banned for the first min_new_tokens, against
    JAX with and without delta-KV."""
    base = dict(max_new_tokens=40, vocab_window=WINDOW, cache_len=64)
    free, _ = _jax(models, None, eos_id=-1, **base)
    eos = int(free[0, 6])  # row 0 emits this id at step 6
    assert WINDOW[0] <= eos < WINDOW[0] + WINDOW[1]
    for min_new in (0, 9):
        kw = dict(eos_id=eos, min_new_tokens=min_new, **base)
        ours, n, steps = _torch(models, **kw)
        for delta_k in (None, 32):
            ref, ref_n = _jax(models, delta_k, **kw)
            np.testing.assert_array_equal(ours, ref, err_msg=f"delta_k={delta_k}")
            np.testing.assert_array_equal(n, ref_n)
        if min_new == 0:  # row 0 stops at its EOS, pads after it
            assert n[0] == 7 and ours[0, 6] == eos and (ours[0, 7:] == 0).all()
        else:  # EOS is banned while fewer than min_new tokens are out
            assert eos not in ours[0, :min_new]
        assert steps == n.max()


def test_make_generate_fn_is_generate(models):
    _, _, tcfg, tp, toks, lengths = models
    fn = tg.make_generate_fn(tcfg, ts.SamplingParams(**GREEDY), 5, -1, device="cpu")
    a = fn(tp, toks, lengths, None).tokens
    b = _torch(models, max_new_tokens=5, eos_id=-1)[0]
    np.testing.assert_array_equal(a.numpy(), b)
