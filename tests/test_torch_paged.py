"""Paged decode attention and the paged model step, the port against the JAX
package on the CPU.

The plain paged version (what every entry point runs on a CPU tensor) is
held within 1e-5 in fp32 against JAX's gather oracle and against the D, E
and F Pallas kernels in interpret mode, on a shuffled pool with NaN planted
in every block no sequence reads (the sink block 0 among them). Then
``decode_step_paged`` against JAX's and against the port's contiguous
``decode_step``, the prefix-cache helpers, and ``window_attention`` and
``decode_window`` against JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import one_torch_thread  # noqa: F401
from tts_max_tpu.models import llama as jl
from tts_max_tpu.ops import attention as jatt
from tts_max_tpu.ops import paged_attention as jpa
from tts_max_tpu_torch import convert
from tts_max_tpu_torch.models import llama as tl
from tts_max_tpu_torch.ops import attention as tatt
from tts_max_tpu_torch.ops import paged_attention as tpa

TOL = dict(rtol=1e-5, atol=1e-5)
ENTRY_POINTS = [tpa.paged_decode_attention_dense, tpa.paged_decode_attention_dma,
                tpa.paged_decode_attention]


def _q8(x):
    """The int8 KV quantizer (llama._quantize_kv) in numpy."""
    scale = np.abs(x).max(axis=-1, keepdims=True) / 127.0 + 1e-12
    return {"q": np.clip(np.round(x / scale), -127, 127).astype(np.int8),
            "scale": scale[..., 0].astype(np.float32)}


def _case(seed, quantized, b=3, p=4, bs=16, hkv=2, n_rep=3, d=8, layers=0):
    """q, a shuffled pool (stacked over ``layers`` when > 0), its table
    (block 0, the sink, owned by no one), lengths, and the same pool with
    NaN in every block that no sequence reads below its length."""
    rng = np.random.default_rng(seed)
    n = b * p + 5
    lead = (layers,) if layers else ()
    q = rng.standard_normal((b, hkv * n_rep, d)).astype(np.float32)
    pools = [rng.standard_normal((*lead, n, bs, hkv, d)).astype(np.float32)
             for _ in range(2)]
    table = (rng.permutation(n - 1)[:b * p] + 1).reshape(b, p).astype(np.int32)
    lengths = rng.integers(1, p * bs + 1, b).astype(np.int32)
    lengths[0] = p * bs  # one sequence fills its table
    live = {int(table[i, j]) for i in range(b) for j in range(-(-lengths[i] // bs))}
    dead = np.asarray([blk not in live for blk in range(n)])
    if quantized:
        pools = [_q8(x) for x in pools]
    poisoned = []
    for pool in pools:
        if quantized:
            pool = {"q": pool["q"], "scale": pool["scale"].copy()}
            pool["scale"][..., dead, :, :] = np.nan  # scales [.., N, bs, Hkv]
        else:
            pool = pool.copy()
            pool[..., dead, :, :, :] = np.nan
        poisoned.append(pool)
    return q, pools, poisoned, table, lengths


def _jax(x):
    return jax.tree.map(jnp.asarray, x)


def _torch(x):
    return jax.tree.map(torch.from_numpy, x)


@pytest.mark.parametrize("pages_per_block", [1, 4])
@pytest.mark.parametrize("quantized", [False, True])
def test_plain_matches_jax_oracle_and_pallas_kernels(quantized, pages_per_block):
    q, (kp, vp), (kx, vx), table, lengths = _case(0, quantized)
    ref = np.asarray(jpa.paged_decode_attention_xla(
        _jax(q), _jax(kp), _jax(vp), _jax(table), _jax(lengths)))
    ours = [fn(*_torch((q, kx, vx, table, lengths))).numpy() for fn in ENTRY_POINTS]
    ours.append(tpa.paged_decode_attention_dense(
        *_torch((q, kx, vx, table, lengths)), pages_per_block=pages_per_block).numpy())
    for out in ours:
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, ref, **TOL)
    args = _jax((q, kx, vx, table, lengths))
    kernels = {
        "D": jpa.paged_decode_attention_dense(*args, pages_per_block=pages_per_block,
                                              interpret=True),
        "E": jpa.paged_decode_attention_dma(*args, interpret=True),
        "F": jpa.paged_decode_attention(*args, interpret=True),
    }
    for name, out in kernels.items():
        np.testing.assert_allclose(ours[0], np.asarray(out), **TOL, err_msg=name)


@pytest.mark.parametrize("quantized", [False, True])
def test_stacked_layer_form_matches_jax(quantized):
    """D's stacked form reads layer ``layer`` of [L, N, bs, Hkv, D] pools."""
    q, (kp, vp), (kx, vx), table, lengths = _case(1, quantized, layers=3)
    for layer in range(3):
        def at(x):
            return jax.tree.map(lambda a: a[layer], x)

        ref = np.asarray(jpa.paged_decode_attention_xla(
            _jax(q), _jax(at(kp)), _jax(at(vp)), _jax(table), _jax(lengths)))
        out, k_back, _ = tpa.paged_decode_attention_dense(
            *_torch((q, kx, vx, table, lengths)), layer=layer, alias_caches=True)
        np.testing.assert_allclose(out.numpy(), ref, **TOL)
        kern = jpa.paged_decode_attention_dense(
            *_jax((q, kx, vx, table, lengths)), layer=jnp.int32(layer), interpret=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(kern), **TOL)
        assert (k_back["q"] if quantized else k_back).shape[0] == 3


def test_entry_points_raise_off_the_cpu_and_count_only_kernel_launches():
    """A tensor on neither the CPU nor a card (here the meta device) raises;
    CPU calls run the plain version and count no launch."""
    q, (kp, vp), _, table, lengths = _case(2, False)
    before = [fn.launches for fn in ENTRY_POINTS]
    for fn in ENTRY_POINTS:
        fn(*_torch((q, kp, vp, table, lengths)))
        with pytest.raises(ValueError, match="CUDA"):
            fn(*[t.to("meta") for t in _torch((q, kp, vp, table, lengths))])
    assert [fn.launches for fn in ENTRY_POINTS] == before


@pytest.mark.parametrize("pages_per_block", [0, -1])
def test_dense_entry_rejects_pages_per_block_below_one(pages_per_block):
    """``pages_per_block`` is the JAX kernel's scheduling argument: any value
    >= 1 gives the same function (the test above), one below 1 is refused."""
    q, (kp, vp), _, table, lengths = _case(2, False)
    with pytest.raises(ValueError, match="pages_per_block"):
        tpa.paged_decode_attention_dense(*_torch((q, kp, vp, table, lengths)),
                                         pages_per_block=pages_per_block)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jl.tiny_config(vocab_size=96), dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.tiny_config(vocab_size=96), dtype=torch.float32)
    jp = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.llama_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                  device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("variant", ["dense", "dense2"])
@pytest.mark.parametrize("quantized", [False, True])
def test_decode_step_paged_matches_jax_and_contiguous(models, quantized, variant,
                                                      monkeypatch):
    """Prefill into a contiguous cache, scatter each sequence into shuffled
    pool blocks, then 6 steps: the port's paged step against JAX's (the
    gather variant) and against the port's contiguous step, logits within
    1e-4, greedy tokens fed back."""
    jcfg, jp, tcfg, tp = models
    b, bs, p, s = 2, 16, 4, 16
    rng = np.random.default_rng(3)
    toks = rng.integers(1, 90, (b, s)).astype(np.int32)
    lens = np.asarray([5, 9], np.int32)
    n = b * p + 3
    table = rng.permutation(n)[:b * p].reshape(b, p).astype(np.int32)
    tcache = tl.init_kv_cache(tcfg, b, p * bs, quantized=quantized, device="cpu")
    logits_c, tcache = tl.prefill(tp, tcfg, torch.from_numpy(toks),
                                  torch.from_numpy(lens), tcache)
    jcache = jl.init_kv_cache(jcfg, b, p * bs, quantized=quantized)
    _, jcache = jl.prefill(jp, jcfg, jnp.asarray(toks), jnp.asarray(lens), jcache)
    tpool = tl.init_paged_kv_cache(tcfg, n, bs, quantized=quantized, device="cpu")
    jpool = jl.init_paged_kv_cache(jcfg, n, bs, quantized=quantized)
    for i in range(b):
        blocks = table[i, :s // bs]
        tl.scatter_prefill_to_blocks(
            tpool, tl._map(lambda x: x[:, i:i + 1, :s], tcache), torch.from_numpy(blocks))
        jpool = jl.scatter_prefill_to_blocks(
            jpool, jax.tree.map(lambda x: x[:, i:i + 1, :s], jcache), jnp.asarray(blocks))
    monkeypatch.setenv("TTS_MAX_PAGED_ATTN", variant)
    jstep = jax.jit(jl.decode_step_paged, static_argnames=("cfg", "use_pallas"))
    tlen = torch.from_numpy(lens.copy())
    ttab = torch.from_numpy(table)
    for _ in range(6):
        tok = torch.argmax(logits_c, dim=-1).int()
        logits_p, tpool = tl.decode_step_paged(tp, tcfg, tpool, tok, tlen, ttab)
        jlog, jpool = jstep(jp, jcfg, jpool, jnp.asarray(tok.numpy()),
                            jnp.asarray(tlen.numpy()), jnp.asarray(table),
                            use_pallas=False)
        logits_c, tcache = tl.decode_step(tp, tcfg, tcache, tok, tlen)
        np.testing.assert_allclose(logits_p.numpy(), np.asarray(jlog), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(logits_p.numpy(), logits_c.numpy(), rtol=1e-4, atol=1e-4)
        tlen += 1


def test_xla_variant_takes_cpu_tensors_only(models, monkeypatch):
    """``"xla"`` (and ``use_pallas=False``) is the plain version: a tensor
    off the CPU raises before any work."""
    _, _, tcfg, tp = models
    pool = tl.init_paged_kv_cache(tcfg, 4, 16, device="meta")
    meta = dict(device="meta", dtype=torch.int32)
    args = (tp, tcfg, pool, torch.zeros(2, **meta), torch.zeros(2, **meta),
            torch.zeros(2, 3, **meta))
    with pytest.raises(ValueError, match="CPU tensors only"):
        tl.decode_step_paged(*args, use_pallas=False)
    monkeypatch.setenv("TTS_MAX_PAGED_ATTN", "xla")
    with pytest.raises(ValueError, match="CPU tensors only"):
        tl.decode_step_paged(*args)
    monkeypatch.setenv("TTS_MAX_PAGED_ATTN", "nope")
    with pytest.raises(ValueError, match="nope"):
        tl._paged_variant()


def test_block_gather_scatter_grow_match_jax(models):
    jcfg, _, tcfg, _ = models
    rng = np.random.default_rng(4)
    n, bs = 7, 16
    pool = rng.standard_normal((2, n, bs, 2, 16)).astype(np.float32)
    small = rng.standard_normal((2, 1, 64, 2, 16)).astype(np.float32)
    ids = np.asarray([5, 2, 6], np.int32)
    jpool = {"k": jnp.asarray(pool), "v": jnp.asarray(-pool)}
    tpool = {"k": torch.from_numpy(pool.copy()), "v": torch.from_numpy(-pool)}
    g = tl.gather_blocks_to_cache(tpool, torch.from_numpy(ids))
    np.testing.assert_array_equal(
        g["k"].numpy(), np.asarray(jl.gather_blocks_to_cache(jpool, jnp.asarray(ids))["k"]))
    grown = tl.grow_cache(g, 80)
    np.testing.assert_array_equal(grown["v"].numpy(),
                                  np.asarray(jl.grow_cache(jl.gather_blocks_to_cache(
                                      jpool, jnp.asarray(ids)), 80)["v"]))
    jsmall = {"k": jnp.asarray(small), "v": jnp.asarray(small)}
    tsmall = {"k": torch.from_numpy(small), "v": torch.from_numpy(small)}
    ref = jl.scatter_suffix_to_blocks(jpool, jsmall, jnp.asarray(ids[:2]), 32)
    tl.scatter_suffix_to_blocks(tpool, tsmall, torch.from_numpy(ids[:2]), 32)
    np.testing.assert_array_equal(tpool["k"].numpy(), np.asarray(ref["k"]))


@pytest.mark.parametrize("quantized", [False, True])
def test_window_attention_matches_jax(quantized):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 5, 6, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 24, 2, 16)).astype(np.float32) for _ in range(2))
    if quantized:
        k, v = _q8(k), _q8(v)
    lengths = np.asarray([3, 12], np.int32)
    ref = jatt.window_attention(*_jax((q, k, v, lengths)))
    out = tatt.window_attention(*_torch((q, k, v, lengths)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_decode_window_matches_jax(models):
    """A 7-token window after a prefill: logits at every window position
    and the cache rows it writes."""
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(6)
    toks = rng.integers(1, 90, (1, 32)).astype(np.int32)
    win = rng.integers(1, 90, (1, 7)).astype(np.int32)
    lens = np.asarray([32], np.int32)
    jcache = jl.init_kv_cache(jcfg, 1, 48)
    _, jcache = jl.prefill(jp, jcfg, jnp.asarray(toks), jnp.asarray(lens), jcache)
    tcache = tl.init_kv_cache(tcfg, 1, 48, device="cpu")
    _, tcache = tl.prefill(tp, tcfg, torch.from_numpy(toks), torch.from_numpy(lens), tcache)
    head = (10, 60)
    jlog, jcache = jl.decode_window(jp, jcfg, jcache, jnp.asarray(win), jnp.asarray(lens),
                                    jl.slice_logits_head(jp, jcfg, *head))
    tlog, tcache = tl.decode_window(tp, tcfg, tcache, torch.from_numpy(win),
                                    torch.from_numpy(lens),
                                    tl.slice_logits_head(tp, tcfg, *head))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tcache["k"].float().numpy()[:, :, :39],
                               np.asarray(jcache["k"], np.float32)[:, :, :39],
                               rtol=1e-4, atol=1e-4)
