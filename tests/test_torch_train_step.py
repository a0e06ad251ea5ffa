"""The port's training step (``tts_max_tpu_torch/training``) against the JAX
package's (``tts_max_tpu/training``), on the CPU at a tiny size, mirroring
``tests/test_train_step.py``.

Weights are JAX's seeded ``init_params`` carried to the port as numpy
(``convert.llama_from_numpy``); batches are seeded numpy arrays handed to
both. The models compute in fp32 (``dtype=float32``) on both sides. Each
JAX step is compiled once per module.

Tolerances: losses rtol 1e-5 (fp32 sums in another order); grads per leaf
max|g - ref| <= 1e-4 max|ref| (the attention backward's GRAD_TOL is 1e-5 of
the max; the layers above it add fp32 reassociation); params after AdamW
steps atol 2e-6 (an update is lr * m / (sqrt(v) + eps) with lr 1e-3, so a
relative grad error of 1e-4 moves it by 1e-7; 2e-6 leaves room for the
smallest grads, whose ratio is the most sensitive).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_fixtures import one_torch_thread  # noqa: F401
from tts_max_tpu.models import llama as jllama
from tts_max_tpu.training import optim as joptim
from tts_max_tpu.training import train_step as jts
from tts_max_tpu_torch import convert
from tts_max_tpu_torch.models import llama
from tts_max_tpu_torch.training import optim, train_step as ts


def _configs(vocab=128, seq=64):
    jcfg = dataclasses.replace(jllama.tiny_config(vocab_size=vocab, max_seq_len=seq),
                               dtype=jnp.float32)
    pcfg = dataclasses.replace(llama.tiny_config(vocab_size=vocab, max_seq_len=seq),
                               dtype=torch.float32)
    return jcfg, pcfg


def _port_params(jparams, pcfg):
    return convert.llama_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), pcfg,
                                    device="cpu")


@pytest.fixture(scope="module")
def setup():
    jcfg, pcfg = _configs()
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, pcfg, jparams, _port_params(jparams, pcfg)


def _batch(vocab=128, accum=1, b=4, L=16, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (accum, b, L)).astype(np.int32)
    labels = ids.copy()
    labels[:, :, :4] = -100  # a masked prompt region
    return {"input_ids": ids, "labels": labels}


def _flat(tree, prefix=""):
    """{path: numpy array} of a JAX or port parameter tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v.detach() if torch.is_tensor(v) else v,
                                             dtype=np.float32)
    return out


def _assert_leaves(got, want, atol=None, rel=1e-4, what=""):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        if atol is None:
            err = np.abs(g[k] - w[k]).max() / max(np.abs(w[k]).max(), 1e-30)
            assert err <= rel, f"{what} {k}: {err:.2e} of max|ref|"
        else:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=atol, err_msg=f"{what} {k}")


def test_causal_lm_loss_masking_and_all_masked():
    logits = torch.zeros(1, 4, 8)  # uniform -> loss = log(8)
    labels = torch.tensor([[-100, 2, -100, 5]])
    loss, toks = ts.causal_lm_loss(logits, labels)
    jloss, jtoks = jts.causal_lm_loss(jnp.zeros((1, 4, 8)), jnp.asarray(labels.numpy()))
    assert int(toks) == int(jtoks) == 2
    np.testing.assert_allclose(float(loss), np.log(8), atol=1e-6)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    loss, toks = ts.causal_lm_loss(logits, torch.full((1, 4), -100))
    assert int(toks) == 0 and float(loss) == 0.0


def test_chunked_loss_matches_full_and_jax():
    """chunked == full in value and grads (chunks that divide T, do not, and
    exceed it), and equal to JAX's chunked loss."""
    jcfg, pcfg = _configs(vocab=96, seq=40)
    jparams = jllama.init_params(jax.random.PRNGKey(3), jcfg)
    params = _port_params(jparams, pcfg)
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, 96, (2, 40)).astype(np.int32),
             "labels": rng.integers(0, 96, (2, 40)).astype(np.int32)}
    batch["labels"][:, :5] = -100
    tb = ts.to_device_batch(batch, "cpu")
    l_full, n_full, g_full = ts._loss_and_grads(params, pcfg, tb, 0)
    for chunk in (8, 13, 64):
        l_chunk, n_chunk, g_chunk = ts._loss_and_grads(params, pcfg, tb, chunk)
        assert int(n_full) == int(n_chunk)
        np.testing.assert_allclose(float(l_chunk), float(l_full), rtol=1e-6)
        _assert_leaves(g_chunk, g_full, what=f"chunk {chunk}")
        jl, _ = jts.loss_fn(jparams, jcfg, batch, chunk)
        np.testing.assert_allclose(float(l_chunk), float(jl), rtol=1e-5)


@pytest.fixture(scope="module")
def two_steps(setup):
    """Two AdamW steps under a 1-step warmup (lr 0, then 1e-3) on each side,
    and each side's grads of the first batch."""
    jcfg, pcfg, jparams, params = setup
    sched_j = joptim.cosine_warmup_schedule(1e-3, 1, 10)
    tx_j = joptim.create_optimizer(sched_j)
    step_j = jax.jit(functools.partial(jts.train_step, cfg=jcfg, tx=tx_j))
    tx = optim.create_optimizer(optim.cosine_warmup_schedule(1e-3, 1, 10))
    batches = [_batch(seed=1), _batch(seed=2)]
    pj, oj, p, o = jparams, tx_j.init(jparams), params, tx.init(params)
    metrics = []
    for b in batches:
        pj, oj, mj = step_j(pj, oj, b)
        p, o, m = ts.train_step(p, o, b, cfg=pcfg, tx=tx)
        metrics.append((mj, m))
    micro = {k: v[0] for k, v in batches[0].items()}
    jgrads = jax.grad(lambda q: jts.loss_fn(q, jcfg, micro)[0])(jparams)
    _, _, grads = ts._loss_and_grads(params, pcfg, ts.to_device_batch(micro, "cpu"), 0)
    return metrics, (pj, oj), (p, o), jgrads, grads


def test_one_step_grads_match_jax(two_steps):
    metrics, _, _, jgrads, grads = two_steps
    _assert_leaves(grads, jgrads, what="grad")
    for mj, m in metrics:
        np.testing.assert_allclose(m.loss, float(mj.loss), rtol=1e-5)
        np.testing.assert_allclose(m.grad_norm, float(mj.grad_norm), rtol=1e-5)
        assert m.nonfinite == float(mj.nonfinite) == 0.0
        assert m.tokens == int(mj.tokens)


def test_two_adamw_steps_match_jax(two_steps, setup):
    """The first step runs at lr = schedule(0) = 0 (optax reads the schedule
    before it counts), so the params do not move; the second is a real step."""
    _, (pj, oj), (p, o), _, _ = two_steps
    _assert_leaves(p, pj, atol=2e-6, what="params")
    _assert_leaves(o["mu"], oj[0].mu, what="mu")
    _assert_leaves(o["nu"], oj[0].nu, rel=1e-3, what="nu")
    assert o["count"] == int(oj[0].count) == 2
    moved = _flat(p)["embed/embedding"] - _flat(setup[3])["embed/embedding"]
    assert np.abs(moved).max() > 1e-4


def test_first_warmup_step_does_not_move_params(setup):
    _, pcfg, _, params = setup
    tx = optim.create_optimizer(optim.cosine_warmup_schedule(1e-3, 2, 10))
    p, _, _ = ts.train_step(params, tx.init(params), _batch(seed=4), cfg=pcfg, tx=tx)
    _assert_leaves(p, params, atol=0.0)


class _SGD:
    """optax.sgd(lr) with the port's optimizer interface."""

    def __init__(self, lr):
        self.lr = lr

    def init(self, params):
        return {}

    def update(self, grads, state, params):
        return optim.tree_map(lambda g: -self.lr * g, grads), state


def test_gradient_accumulation_matches_jax(setup):
    """A = 2 over [b1; b2] gives the A = 1 step over the concatenated batch
    (equal token counts a micro-batch), and equals JAX's A = 2 step (SGD, so
    the param delta is the averaged grad)."""
    jcfg, pcfg, jparams, params = setup
    big = _batch(b=8, L=16, seed=3)
    split = {k: v.reshape(2, 4, 16) for k, v in big.items()}
    tx = _SGD(1e-2)
    p1, _, m1 = ts.train_step(params, {}, big, cfg=pcfg, tx=tx)
    p2, _, m2 = ts.train_step(params, {}, split, cfg=pcfg, tx=tx)
    np.testing.assert_allclose(m1.loss, m2.loss, rtol=1e-5)
    _assert_leaves(p2, p1, atol=2e-6, what="A=2 vs A=1")
    tx_j = optax.sgd(1e-2)
    pj, _, mj = jts.train_step(jparams, tx_j.init(jparams), split, cfg=jcfg, tx=tx_j)
    np.testing.assert_allclose(m2.loss, float(mj.loss), rtol=1e-5)
    _assert_leaves(p2, pj, atol=2e-6, what="A=2 vs JAX")


def test_nonfinite_guard_matches_jax(setup):
    """A NaN norm scale: nonfinite 1, params bitwise unchanged, the moments
    decayed one step with zero grads, as JAX's."""
    jcfg, pcfg, jparams, params = setup
    tx_j = joptim.create_optimizer(1e-3)
    tx = optim.create_optimizer(1e-3)
    pj, oj, _ = jts.train_step(jparams, tx_j.init(jparams), _batch(seed=5), cfg=jcfg, tx=tx_j)
    p, o, _ = ts.train_step(params, tx.init(params), _batch(seed=5), cfg=pcfg, tx=tx)
    bad_j = jax.tree_util.tree_map(lambda x: x, pj)
    bad_j["norm"]["scale"] = bad_j["norm"]["scale"] * jnp.nan
    bad = optim.tree_map(lambda x: x.clone(), p)
    bad["norm"]["scale"] = bad["norm"]["scale"] * float("nan")
    pj2, oj2, mj = jts.train_step(bad_j, oj, _batch(seed=6), cfg=jcfg, tx=tx_j)
    p2, o2, m = ts.train_step(bad, o, _batch(seed=6), cfg=pcfg, tx=tx)
    assert m.nonfinite == float(mj.nonfinite) == 1.0
    for k, v in _flat(bad).items():
        np.testing.assert_array_equal(_flat(p2)[k], v)
    _assert_leaves(o2["mu"], oj2[0].mu, what="mu after the skipped step")
    _assert_leaves(o2["nu"], oj2[0].nu, rel=1e-3, what="nu after the skipped step")


def test_cosine_schedule_matches_jax():
    for warm, decay in ((10, 110), (1, 8), (3, 20)):
        js = joptim.cosine_warmup_schedule(1e-3, warm, decay)
        ps = optim.cosine_warmup_schedule(1e-3, warm, decay)
        for step in range(decay + 12):
            np.testing.assert_allclose(ps(step), float(js(step)), rtol=1e-6, atol=1e-12)
    assert optim.cosine_warmup_schedule(1e-3, 10, 110)(0) == 0.0
    with pytest.raises(ValueError):
        optim.cosine_warmup_schedule(1e-3, 10, 10)


def test_remat_policies_match_no_remat(setup):
    """remat (full and dots) changes memory, not math."""
    _, pcfg, _, params = setup
    batch = _batch(b=4, L=32, seed=7)
    tx = optim.create_optimizer(1e-3)
    outs = {}
    for name, cfg in (("none", pcfg), ("full", dataclasses.replace(pcfg, remat=True)),
                      ("dots", dataclasses.replace(pcfg, remat=True, remat_policy="dots"))):
        p, _, m = ts.train_step(params, tx.init(params), batch, cfg=cfg, tx=tx)
        outs[name] = (m.loss, p)
    for name in ("full", "dots"):
        assert abs(outs[name][0] - outs["none"][0]) < 1e-6
        _assert_leaves(outs[name][1], outs["none"][1], atol=5e-6, what=name)


def test_bf16_adam_mu_dtype():
    """bf16 params with mu_dtype "bf16": bf16 first moments, second moments
    in the param dtype, as optax keeps them; a finite step."""
    jcfg = jllama.tiny_config(vocab_size=64, max_seq_len=32)
    pcfg = llama.tiny_config(vocab_size=64, max_seq_len=32)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.bfloat16)
    params = optim.tree_map(lambda t: t.to(torch.bfloat16), _port_params(jparams, pcfg))
    tx = optim.create_optimizer(1e-3, mu_dtype="bf16")
    st = tx.init(params)
    st_j = joptim.create_optimizer(1e-3, mu_dtype="bf16").init(jparams)
    assert {t.dtype for t in optim.tree_leaves(st["mu"])} == {torch.bfloat16}
    assert {t.dtype for t in optim.tree_leaves(st["nu"])} == {torch.bfloat16}
    assert {str(x.dtype) for x in jax.tree_util.tree_leaves(st_j[0].mu)} == {"bfloat16"}
    batch = {"input_ids": np.zeros((1, 2, 16), np.int32),
             "labels": np.zeros((1, 2, 16), np.int32)}
    p, st2, m = ts.train_step(params, st, batch, cfg=pcfg, tx=tx)
    assert np.isfinite(m.loss) and m.nonfinite == 0.0
    assert {t.dtype for t in optim.tree_leaves(p)} == {torch.bfloat16}
    assert {t.dtype for t in optim.tree_leaves(st2["mu"])} == {torch.bfloat16}


def test_train_step_after_inference_mode(setup):
    """Serving runs under torch.inference_mode and caches the rope table; a
    train step in the same process must still save it for its backward."""
    from tts_max_tpu_torch.ops.rope import _rope_table, rope_table

    _, pcfg, _, params = setup
    cfg = dataclasses.replace(pcfg, remat=True)
    batch = _batch(L=24, seed=8)
    _rope_table.cache_clear()
    with torch.inference_mode():
        cos, _ = rope_table(pcfg.head_dim, 24, pcfg.rope_theta, False, "cpu")
    assert not cos.is_inference()
    tx = optim.create_optimizer(1e-3)
    _, _, m = ts.train_step(params, tx.init(params), batch, cfg=cfg, tx=tx)
    assert np.isfinite(m.loss)

