"""The port's SpeechLM against the JAX package's, on the same converted
weights, in fp32 compute: forward and prefill logits, then 8 decode steps
(JAX ``decode_step(flash=True)``, the Pallas kernel in interpret mode) with
bf16 and int8 caches, all within rtol/atol 1e-4; and the int8 KV quantizer
bitwise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import one_torch_thread  # noqa: F401
from tts_max_tpu.models import llama as jl
from tts_max_tpu_torch import convert
from tts_max_tpu_torch.models import llama as tl

VOCAB = 300


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jl.tiny_config(vocab_size=VOCAB), dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.tiny_config(vocab_size=VOCAB), dtype=torch.float32)
    jp = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.llama_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                  device="cpu")
    return jcfg, jp, tcfg, tp


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, s)).astype(np.int32)


def test_forward_matches_jax(models):
    jcfg, jp, tcfg, tp = models
    toks = _tokens(2, 40)
    ref = np.asarray(jl.forward(jp, jcfg, jnp.asarray(toks)))
    ours = tl.forward(tp, tcfg, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("quantized", [False, True])
def test_prefill_and_decode_steps_match_jax(models, quantized):
    jcfg, jp, tcfg, tp = models
    b, s, t = 2, 24, 40
    toks = _tokens(b, s, seed=1)
    lengths = np.asarray([24, 17], np.int32)
    jcache = jl.init_kv_cache(jcfg, b, t, dtype=jnp.bfloat16, quantized=quantized)
    tcache = tl.init_kv_cache(tcfg, b, t, dtype=torch.bfloat16, quantized=quantized,
                              device="cpu")
    head = (10, 200)
    jl_logits, jcache = jl.prefill(jp, jcfg, jnp.asarray(toks), jnp.asarray(lengths),
                                   jcache, jl.slice_logits_head(jp, jcfg, *head))
    tl_logits, tcache = tl.prefill(tp, tcfg, torch.from_numpy(toks),
                                   torch.from_numpy(lengths), tcache,
                                   tl.slice_logits_head(tp, tcfg, *head))
    np.testing.assert_allclose(tl_logits.numpy(), np.asarray(jl_logits),
                               rtol=1e-4, atol=1e-4)
    jlen, tlen = jnp.asarray(lengths), torch.from_numpy(lengths.copy())
    step_toks = _tokens(8, b, seed=2)
    jstep = jax.jit(jl.decode_step, static_argnames=("cfg", "flash"))
    for i in range(8):
        jl_logits, jcache = jstep(jp, jcfg, jcache, jnp.asarray(step_toks[i]), jlen,
                                  flash=True)
        tl_logits, tcache = tl.decode_step(tp, tcfg, tcache,
                                           torch.from_numpy(step_toks[i]), tlen)
        np.testing.assert_allclose(tl_logits.numpy(), np.asarray(jl_logits),
                                   rtol=1e-4, atol=1e-4, err_msg=f"step {i}")
        jlen, tlen = jlen + 1, tlen + 1


def test_quantize_kv_bitwise():
    x = np.random.default_rng(3).standard_normal((2, 5, 3, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row takes the 1e-12 scale floor
    ref = jl._quantize_kv(jnp.asarray(x))
    ours = tl._quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(ours["q"].numpy(), np.asarray(ref["q"]))
    np.testing.assert_array_equal(ours["scale"].numpy(), np.asarray(ref["scale"]))


def test_untied_head_and_window(models):
    """8B-style untied LM head: the window slices kernel columns."""
    jcfg = dataclasses.replace(models[0], tie_embeddings=False)
    tcfg = dataclasses.replace(models[2], tie_embeddings=False)
    jp = jl.init_params(jax.random.PRNGKey(1), jcfg)
    tp = convert.llama_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                  device="cpu")
    toks = _tokens(1, 12, seed=4)
    lengths = np.asarray([12], np.int32)
    ref, _ = jl.prefill(jp, jcfg, jnp.asarray(toks), jnp.asarray(lengths),
                        jl.init_kv_cache(jcfg, 1, 16),
                        jl.slice_logits_head(jp, jcfg, 20, 100))
    ours, _ = tl.prefill(tp, tcfg, torch.from_numpy(toks), torch.from_numpy(lengths),
                         tl.init_kv_cache(tcfg, 1, 16, device="cpu"),
                         tl.slice_logits_head(tp, tcfg, 20, 100))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
