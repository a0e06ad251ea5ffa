"""The port's LoRA adapters (``tts_max_tpu_torch/models/lora.py``) against
the JAX package's ``models/lora.py`` on the same tiny Llama: the same
targets and shapes, adapter files that load across the packages with equal
keys, ``merge`` equal within 1e-6 relative in fp32 and one bf16 ulp in
bf16, and ``lora_loss_fn``'s adapter gradients within ``GRAD_TOL`` of
``jax.grad``'s, the base frozen and gradless."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_max_tpu.models import llama as jllama
from tts_max_tpu.models import lora as jlora
from tts_max_tpu.training import train_step as jts
from tts_max_tpu_torch import convert
from tts_max_tpu_torch.models import llama, lora
from tts_max_tpu_torch.ops.attention import grad_tol_ratio
from tts_max_tpu_torch.training import train_step as ts

R, ALPHA = 4, 8.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jllama.tiny_config(vocab_size=128, max_seq_len=64),
                               dtype=jnp.float32)
    pcfg = dataclasses.replace(llama.tiny_config(vocab_size=128, max_seq_len=64),
                               dtype=torch.float32)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    pparams = convert.llama_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), pcfg,
                                       device="cpu")
    return jcfg, pcfg, jparams, pparams


def _jax_flat(tree):
    """{path_str: numpy} of a JAX adapter tree, None leaves dropped."""
    from tts_max_tpu.parallel.sharding import path_str

    return {path_str(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_flat(tree):
    return {k: t.detach().float().numpy() for k, t in lora.adapter_items(tree)}


def _random_adapters(jtemplate, seed, dtype=np.float32):
    """Non-zero a and b for every JAX target, as numpy by path."""
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(v.shape) * 0.1).astype(dtype)
            for k, v in _jax_flat(jtemplate).items()}


def _set(tree, flat, to_leaf, prefix=""):
    if isinstance(tree, dict):
        return {k: _set(v, flat, to_leaf, f"{prefix}{k}/") for k, v in tree.items()}
    return None if tree is None else to_leaf(flat[prefix[:-1]])


def test_init_targets_and_shapes_match_jax(setup):
    _, _, jparams, pparams = setup
    jl = jlora.init_lora(jax.random.PRNGKey(1), jparams, r=R)
    pl = lora.init_lora(pparams, r=R, seed=1)
    jflat, pflat = _jax_flat(jl), _port_flat(pl)
    assert jflat.keys() == pflat.keys()
    assert {k: v.shape for k, v in jflat.items()} == {k: v.shape for k, v in pflat.items()}
    assert "layers/attn/wq/kernel/a" in pflat and "layers/mlp/w_down/kernel/b" in pflat
    assert pl["embed"]["embedding"] is None and pl["norm"]["scale"] is None
    assert pl["layers"]["attn_norm"]["scale"] is None
    assert pflat["layers/attn/wq/kernel/a"].shape == (2, 64, R)
    assert pflat["layers/mlp/w_down/kernel/b"].shape == (2, R, 64)
    # a ~ normal / r, b = 0: the new adapter merges to the base exactly
    a = pflat["layers/mlp/w_gate/kernel/a"]
    assert 0.5 / R < a.std() < 1.5 / R
    assert all(not v.any() for k, v in pflat.items() if k.endswith("/b"))
    assert lora.trainable_count(pl) == sum(v.size for v in jflat.values())
    merged = lora.merge(pparams, pl, ALPHA, R)
    for k, v in _port_flat({"p": pparams}).items():
        np.testing.assert_array_equal(_port_flat({"p": merged})[k], v)


def test_adapter_files_load_across_packages(setup, tmp_path):
    _, _, jparams, pparams = setup
    jl = jlora.init_lora(jax.random.PRNGKey(1), jparams, r=R)
    pl = lora.init_lora(pparams, r=R, seed=1)
    flat = _random_adapters(jl, seed=2)
    jl = _set(jl, flat, jnp.asarray)
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jlora.save_adapter(jpath, jl)
    into_port = lora.load_adapter(jpath, pl)
    assert _port_flat(into_port).keys() == flat.keys()
    for k, v in _port_flat(into_port).items():
        np.testing.assert_array_equal(v, flat[k])
    lora.save_adapter(ppath, into_port)
    with np.load(jpath) as a, np.load(ppath) as b:
        assert sorted(a.files) == sorted(b.files)
    into_jax = jlora.load_adapter(ppath, jl)
    for k, v in _jax_flat(into_jax).items():
        np.testing.assert_array_equal(v, flat[k])


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_matches_jax(setup, dtype):
    jcfg, pcfg, jparams, pparams = setup
    jdt, pdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jp = jax.tree_util.tree_map(lambda x: x.astype(jdt), jparams)
    pp = llama._map(lambda t: t.to(pdt), pparams)
    jl = jlora.init_lora(jax.random.PRNGKey(1), jp, r=R, dtype=jdt)
    flat = _random_adapters(jl, seed=3)
    jl = _set(jl, flat, lambda a: jnp.asarray(a, jdt))
    pl = _set(lora.init_lora(pp, r=R, dtype=pdt), flat,
              lambda a: torch.from_numpy(a).to(pdt))
    ref = jax.tree_util.tree_map(lambda x: np.asarray(x.astype(jnp.float32)),
                                 jlora.merge(jp, jl, ALPHA, R))
    ours = lora.merge(pp, pl, ALPHA, R)
    got = _port_flat({"p": ours})
    for path, x in jax.tree_util.tree_flatten_with_path(ref)[0]:
        key = "p/" + "/".join(str(p.key) for p in path)
        if dtype == "float32":
            np.testing.assert_allclose(got[key], x, rtol=1e-6, atol=1e-6 * np.abs(x).max(),
                                       err_msg=key)
        else:  # one bf16 rounding of the same sum may land one ulp away
            assert (np.abs(got[key] - x) <= _bf16_ulp(x)).all(), key
    assert ours["layers"]["attn"]["wq"]["kernel"].dtype == pdt


def test_lora_loss_grads_match_jax(setup):
    """``jax.grad`` of JAX's ``lora_loss_fn`` around the chunked causal-LM
    loss against torch autograd through the port's, on the same non-zero
    adapters: every adapter gradient within GRAD_TOL; the base params keep
    their bytes and get no gradient."""
    jcfg, pcfg, jparams, pparams = setup
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 128, (2, 24)).astype(np.int32)
    labels = ids.copy()
    labels[:, :5] = -100
    jl = jlora.init_lora(jax.random.PRNGKey(1), jparams, r=R)
    flat = _random_adapters(jl, seed=5)
    jl = _set(jl, flat, jnp.asarray)
    jfn = jlora.lora_loss_fn(jparams, ALPHA, R,
                             lambda p, b: jts.loss_fn(p, jcfg, b, loss_chunk_size=8)[0])
    jloss, jgrads = jax.value_and_grad(jfn)(
        jl, {"input_ids": jnp.asarray(ids), "labels": jnp.asarray(labels)})

    before = {k: t.clone() for k, t in _port_items(pparams)}
    pl = _set(lora.init_lora(pparams, r=R), flat,
              lambda a: torch.from_numpy(a).requires_grad_(True))
    pfn = lora.lora_loss_fn(pparams, ALPHA, R,
                            lambda p, b: ts.loss_fn(p, pcfg, b, loss_chunk_size=8)[0])
    batch = ts.to_device_batch({"input_ids": ids, "labels": labels}, "cpu")
    loss = pfn(pl, batch)
    leaves = [t for _, t in lora.adapter_items(pl)]
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    jg = _jax_flat(jgrads)
    for (k, _), g in zip(lora.adapter_items(pl), grads):
        ratio = grad_tol_ratio(g, torch.from_numpy(np.array(jg[k])))
        assert ratio <= 1.0, f"{k}: {ratio:.2f}x GRAD_TOL"
        assert bool(torch.isfinite(g).all())
    for k, t in _port_items(pparams):
        assert not t.requires_grad and t.grad is None, k
        assert torch.equal(t, before[k]), k


def _port_items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _port_items(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v
