"""The port's tensor parallelism over ``torch.distributed`` against the JAX
package's sharded programs, two gloo ranks on the CPU on a ``(1, 1, 2)``
mesh.

One module-level spawn of two ranks (``tests/_torch_tp_worker.py tp``,
which imports torch and the port only) runs every check while the JAX
references run in this process, on meshes of two of its virtual CPU
devices. Weights are JAX's seeded ``init_params`` handed over as numpy;
everything runs in fp32 (as JAX's own TP engine tests do: the split
reductions' order flips bf16 near-ties on a random model), greedy:

- (a) ``generate`` with this rank's blocks and ``mesh=``: the ids of
  JAX's ``test_tp_sharded_generate_matches_replicated`` setup on its mesh;
- (b) both engines with ``mesh=`` (contiguous, int8 KV, paged), K = 4, on
  the three prompts of ``test_tp_sharded_engine_matches_replicated_
  multistep`` (one of 67 tokens): ids and finish reasons equal to JAX's
  engines under its mesh; besides, the paged engine with the prefix cache,
  prefill-ahead and a cancel gives the ids it gives without a mesh;
- (c) ``n_kv_heads`` 1, where the heads do not divide: the attention runs
  whole (JAX's engine replicates the KV), the ids still JAX's;
- (d) two ``tp`` train steps (two micro-steps, the chunked loss, remat):
  loss and grad norm (rtol 1e-5), params (atol 2e-6, the second step's;
  the first runs at lr 0 under warmup), and each rank's tensor block of
  the params (JAX's shard on its device) and of Adam's moments (mu 1e-4,
  nu 1e-3 of each leaf's max): the tolerances of ``test_torch_train_step``
  and ``test_torch_distributed``; the norms' grads equal on both ranks;
  the collectives a step makes, by its structure;
- (e) one GAN step with a tensor axis against JAX's ``make_gan_step(mesh=
  ...)`` (losses 1e-5 of their magnitude, params atol 1e-5 max(|ref|, 1),
  as ``test_torch_distributed``);
- (f) two ``python -m tts_max_tpu_torch.training.main --device cpu`` ranks
  with ``strategy: tp`` against one process, and a one-process ``fsdp``
  resume from their checkpoint (bf16 compute: see the test).
"""

import dataclasses
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import _torch_dist_worker as dist_worker
from test_torch_distributed import (
    LR,
    _config,
    _final,
    _flat,
    _jax_paths,
    _leaf_close,
    _main,
    _records,
    _rows,
    _single,
    _spawn,
    _state_params,
    _wait,
)
from tts_max_tpu.core.config import CodecTrainingConfig as JCodecConfig, MeshConfig
from tts_max_tpu.inference.engine import InferenceEngine, PagedInferenceEngine
from tts_max_tpu.inference.generate import make_generate_fn
from tts_max_tpu.models import llama as jllama
from tts_max_tpu.models.codec import discriminator as jdisc, vocos as jvocos
from tts_max_tpu.ops.sampling import SamplingParams
from tts_max_tpu.parallel.mesh import build_mesh
from tts_max_tpu.parallel.sharding import params_shardings
from tts_max_tpu.training import optim as joptim
from tts_max_tpu.training import train_step as jts
from tts_max_tpu.training.codec import gan as jgan
from tts_max_tpu_torch.training import optim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_tp_worker.py")
GREEDY = SamplingParams(temperature=0.0, repetition_penalty=1.0, frequency_penalty=0.0)
PROMPTS = [np.array([5, 9, 42], np.int32), np.arange(3, 70, dtype=np.int32),
           np.array([7, 8], np.int32)]
KINDS = ("contiguous", "int8", "paged")
L = 2  # the tiny Llama's layers


def _tiny(vocab, max_seq, **over):
    return dataclasses.replace(jllama.tiny_config(vocab_size=vocab, max_seq_len=max_seq),
                               dtype=jnp.float32, **over)


def _mesh(n=2):
    return build_mesh(MeshConfig(data=1, fsdp=1, tensor=n), devices=jax.devices()[:n])


def _inputs():
    rng = np.random.default_rng(0)
    serve, kv1, train = _tiny(512, 128), _tiny(512, 128, n_kv_heads=1), _tiny(128, 64)
    models = {name: (cfg, jllama.init_params(jax.random.PRNGKey(0), cfg))
              for name, cfg in (("serve", serve), ("kv1", kv1), ("train", train))}
    out = {f"w_{name}/{k}": v for name, (_, p) in models.items()
           for k, v in _flat(p).items()}
    out["gen/toks"] = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 16), 3, 512),
                                 np.int32)
    out["gen/lens"] = np.full((2,), 16, np.int32)
    for k in (1, 2):  # [A = 2, B = 2, 24]: two micro-steps, pad tails and masked prompts
        micro = [_rows(rng, 2, 24, 3 + a, tail=4 * a) for a in range(2)]
        out[f"train/s{k}/input_ids"] = np.concatenate([x[0] for x in micro])
        out[f"train/s{k}/labels"] = np.concatenate([x[1] for x in micro])
    out["gan/audio_codes"] = rng.integers(0, 65536, (2, 8)).astype(np.int32)
    out["gan/wav"] = (0.1 * rng.standard_normal((2, 8 * 320))).astype(np.float32)
    return models, out


def _jax_serving(models, inputs):
    """JAX's generate and engines under its (1, 1, 2) mesh."""
    mesh, ref = _mesh(), {}
    for name in ("serve", "kv1"):
        cfg, params = models[name]
        sharded = jax.device_put(params, params_shardings(params, mesh))
        gen = make_generate_fn(cfg, GREEDY, max_new_tokens=8, eos_id=-1, cache_len=64)
        with mesh:
            ref[f"{name}/gen"] = np.asarray(gen(sharded, jnp.asarray(inputs["gen/toks"]),
                                                jnp.asarray(inputs["gen/lens"]),
                                                jax.random.PRNGKey(2)).tokens)
        kinds = KINDS if name == "serve" else ("contiguous",)
        for kind in kinds:
            kw = dict(max_batch=2, max_len=128, sp=GREEDY, steps_per_dispatch=4, mesh=mesh)
            with mesh:
                if kind == "paged":
                    eng = PagedInferenceEngine(sharded, cfg, block_size=32, **kw)
                else:
                    eng = InferenceEngine(sharded, cfg, quantized_kv=kind == "int8", **kw)
                ref[f"{name}/{kind}"] = eng.generate_all(PROMPTS, max_new_tokens=8, eos_id=-1)
    return ref


def _jax_train(models, inputs):
    """Two JAX steps on (1, 1, 2): [(metrics, params, opt_state)]."""
    cfg, params = models["train"]
    cfg = dataclasses.replace(cfg, remat=True)
    mesh = _mesh()
    tx = joptim.create_optimizer(joptim.cosine_warmup_schedule(1e-3, 1, 10))
    p_sh = jts.params_shardings(params, mesh)
    step = jts.make_train_step(mesh, cfg, tx, params, loss_chunk_size=16)
    p = jax.device_put(params, p_sh)
    o = jax.device_put(tx.init(params), jts._opt_state_shardings(tx, params, p_sh, mesh))
    out = []
    for k in (1, 2):
        batch = jax.device_put({f: inputs[f"train/s{k}/{f}"] for f in ("input_ids", "labels")},
                               {f: jts.data_sh_axis1(mesh) for f in ("input_ids", "labels")})
        p, o, m = step(p, o, batch)
        out.append((jax.tree_util.tree_map(np.asarray, m), p, o))
    return out


def _jax_gan(inputs):
    vcfg, mpd_cfg, msd_cfg, dp, gp = dist_worker.gan_setup()
    jdp = optim.tree_map(lambda t: jnp.asarray(t.numpy().transpose(2, 3, 1, 0) if t.ndim == 4
                                               else t.numpy()), dp)  # conv kernels as HWIO
    jgp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), gp)
    jcfg = JCodecConfig(generator_lr=dist_worker.GAN_LRS[0],
                        discriminator_lr=dist_worker.GAN_LRS[1])
    jtx = [optax.adamw(lr, b1=0.9, b2=0.95, eps=dist_worker.GAN_EPS, weight_decay=0.1)
           for lr in dist_worker.GAN_LRS]
    jt, jf = jgan.split_generator_params(jgp)
    step = jgan.make_gan_step(jvocos.tiny_vocos_config(), jdisc.tiny_mpd_config(),
                              jdisc.tiny_msd_config(), jcfg, jf, *jtx, mesh=_mesh())
    batch = {k: jnp.asarray(inputs[f"gan/{k}"]) for k in ("audio_codes", "wav")}
    return step(jt, jdp, jtx[0].init(jt), jtx[1].init(jdp), batch)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two ranks' results and the JAX references, computed meanwhile."""
    d = str(tmp_path_factory.mktemp("tp"))
    models, inputs = _inputs()
    np.savez(os.path.join(d, "inputs.npz"), **inputs)
    procs = _spawn([sys.executable, WORKER, "tp", d], 2)
    try:
        ref = {"serve": _jax_serving(models, inputs), "train": _jax_train(models, inputs),
               "gan": _jax_gan(inputs)}
    finally:
        _wait(procs)
    outs = [dict(np.load(os.path.join(d, f"out_{r}.npz"))) for r in range(2)]
    return outs, ref


def test_tp_generate_matches_jax(run):
    """(a): greedy ids of both ranks equal JAX's under its mesh."""
    outs, ref = run
    for r in range(2):
        np.testing.assert_array_equal(outs[r]["gen/tokens"], ref["serve"]["serve/gen"])


@pytest.mark.parametrize("kind", KINDS)
def test_tp_engines_match_jax(run, kind):
    """(b): each request's ids and finish reason, on both ranks; the cache
    holds one of the two KV heads a rank."""
    outs, ref = run
    want = ref["serve"][f"serve/{kind}"]
    for r in range(2):
        for i, c in enumerate(want):
            np.testing.assert_array_equal(outs[r][f"eng/{kind}/{i}"], c.tokens, err_msg=kind)
        assert list(outs[r][f"eng/{kind}/eos"]) == [c.finish_reason == "eos" for c in want]
        assert int(outs[r][f"eng/{kind}/kv_heads"]) == 1


def test_paged_features_under_the_mesh(run):
    """(b): the prefix cache (a hit on the first prompt's 64-token block),
    parked requests and a cancelled parked one give, under the mesh, the
    ids the same engine gives without it."""
    outs, _ = run
    for r in range(2):
        o = outs[r]
        mesh = sorted(k for k in o if k.startswith("same/mesh/") and k[10:].isdigit())
        assert len(mesh) == 5
        for k in mesh:
            np.testing.assert_array_equal(o[k], o[k.replace("/mesh/", "/alone/")], err_msg=k)
        np.testing.assert_array_equal(o["same/mesh/stats"], o["same/alone/stats"])
        hits, parked, done = o["same/mesh/stats"]
        assert hits > 0 and parked > 0 and done == 4


def test_heads_that_do_not_divide_run_whole(run):
    """(c): n_kv_heads 1 on two ranks: generate and the contiguous engine
    give JAX's ids, with the whole KV on every rank."""
    outs, ref = run
    for r in range(2):
        np.testing.assert_array_equal(outs[r]["kv1/gen"], ref["serve"]["kv1/gen"])
        for i, c in enumerate(ref["serve"]["kv1/contiguous"]):
            np.testing.assert_array_equal(outs[r][f"kv1/eng/{i}"], c.tokens)
        assert int(outs[r]["kv1/kv_heads"]) == 1


def _tensor_dim(path):
    """The dim the rules split over tensor, for the tiny Llama on 2 ranks."""
    return {"embed/embedding": 0, "layers/attn/wq/kernel": 2, "layers/attn/wk/kernel": 2,
            "layers/attn/wv/kernel": 2, "layers/attn/wo/kernel": 1,
            "layers/mlp/w_gate/kernel": 2, "layers/mlp/w_up/kernel": 2,
            "layers/mlp/w_down/kernel": 1}.get(path)


def _block(a, dim, r, n=2):
    if dim is None:
        return a
    b = a.shape[dim] // n
    return np.take(a, np.arange(r * b, (r + 1) * b), axis=dim)


def test_tp_train_steps_match_jax(run):
    """(d): loss, grad norm and tokens of both steps, the params after the
    second, and each rank's tensor blocks of the params (JAX's shard on its
    device) and of Adam's moments (JAX lays the moments out by shape, so
    they are held to the whole moment's block under the port's rule)."""
    outs, ref = run
    for k, (mj, _, _) in enumerate(ref["train"], 1):
        for r in range(2):
            loss, gnorm, nonfinite, tokens = outs[r][f"train/s{k}/metrics"]
            np.testing.assert_allclose(loss, float(mj.loss), rtol=1e-5)
            np.testing.assert_allclose(gnorm, float(mj.grad_norm), rtol=1e-5)
            assert nonfinite == float(mj.nonfinite) == 0.0 and tokens == int(mj.tokens)
    _, pj, oj = ref["train"][-1]
    devices = jax.devices()[:2]
    for key, arr in _jax_paths(pj):
        for r in range(2):
            _leaf_close(outs[r][f"train/params/{key}"], np.asarray(arr), atol=2e-6,
                        what=f"r{r} {key}")
            local = outs[r][f"train/local/params/{key}"]
            shard = next(s for s in arr.addressable_shards if s.device == devices[r])
            assert local.shape == np.asarray(shard.data).shape, key
            _leaf_close(local, np.asarray(shard.data), atol=2e-6, what=f"r{r} block {key}")
    for moment, rel in (("mu", 1e-4), ("nu", 1e-3)):
        for key, arr in _jax_paths(getattr(oj[0], moment)):
            full = np.asarray(arr)
            for r in range(2):
                want = _block(full, _tensor_dim(key), r)
                local = outs[r][f"train/local/{moment}/{key}"]
                assert local.shape == want.shape, (moment, key)
                _leaf_close(local, want, rel=rel, what=f"r{r} {moment} {key}")


def test_norm_grads_agree_across_tensor_ranks(run):
    """(d): the norms, whole on both ranks, get the same grad on each (the
    column-parallel entries sum their inputs' grads over the ranks)."""
    a, b = run[0]
    keys = [k for k in a if k.startswith("train/norm_grad/")]
    assert len(keys) == 3
    for k in keys:
        assert np.abs(a[k]).max() > 0
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-7, err_msg=k)


def test_tp_collectives_a_step(run):
    """(d): the second step's collectives (A = 2 micro-steps, L = 2 layers,
    remat, 23 shifted tokens in chunks of 16: C = 2 chunks a micro-step).
    A forward sums the embedding and each layer's two row-parallel
    products (1 + 2 L); remat's recompute sums each layer's attention
    product again (its recompute stops at the last saved tensor, before
    the MLP's sum): L more. The backward sums the grad of each
    column-parallel entry: two a layer and the head's one a chunk. The
    cross entropy reduces a chunk's max, exponential sum and target logit,
    in its forward and again in its recompute. Besides, the step's four
    all-reduces (token counts, loss terms, whole grads, the norm)."""
    outs, _ = run
    A, C = 2, 2
    names = ("all_reduce_sum", "all_gather", "reduce_scatter_sum", "barrier", "tensor_enter",
             "tensor_exit", "all_reduce_max", "broadcast")
    for r in range(2):
        got = dict(zip(names, outs[r]["train/calls"].tolist()))
        assert got == dict(all_reduce_sum=4 + A * C * 2 * 2, all_gather=0,
                           reduce_scatter_sum=0, barrier=0, tensor_enter=A * (2 * L + C),
                           tensor_exit=A * (1 + 2 * L + L), all_reduce_max=A * C * 2,
                           broadcast=0), got


def test_gan_step_on_a_tensor_mesh(run):
    """(e): the six losses and both sides' params after one step, the
    tensor peers holding the same rows and the params whole."""
    outs, ref = run
    jt, jdp, _, _, jm = ref["gan"]
    want = np.array([float(x) for x in jm])
    for r in range(2):
        got = outs[r]["gan/metrics"]
        for g, w, name in zip(got, want, jm._fields):
            assert abs(g - w) <= 1e-5 * abs(w), (r, name, g, w)
        for what, tree in (("gen", jt), ("disc", jdp)):
            for key, w in _flat(jax.tree_util.tree_map(np.asarray, tree)).items():
                np.testing.assert_allclose(outs[r][f"gan/{what}/{key}"], w, rtol=0,
                                           atol=1e-5 * max(np.abs(w).max(), 1),
                                           err_msg=f"r{r} {what} {key}")


def _strategy(path, strategy):
    with open(path) as f:
        cfg = json.load(f)
    cfg["training"]["strategy"] = strategy
    with open(path, "w") as f:
        json.dump(cfg, f)


def _close_losses(got, want, what):
    """The same sources logged in each record, their losses within rtol
    1e-4 (the one-device forward tolerance of ``test_torch_llama``)."""
    assert [[x is None for x in r] for r in got] == [[x is None for x in r] for r in want], what
    np.testing.assert_allclose([x for r in got for x in r if x is not None],
                               [x for r in want for x in r if x is not None],
                               rtol=1e-4, err_msg=what)


def _within_adam_bound(got, want, what, moving_steps):
    """Every element within ``test_torch_distributed``'s Adam allowance (2
    lr a moving step + 2e-6)."""
    assert got.keys() == want.keys()
    for key in want:
        err = np.abs(got[key].numpy() - want[key].numpy()).max()
        assert err <= 2 * LR * moving_steps + 2e-6, (what, key, err)


def test_two_rank_tp_entry_point_matches_one_process_and_resumes_under_fsdp(tmp_path):
    """(f): two ranks of ``training.main`` under ``strategy: tp`` (both hold
    the same rows of the global batch 4) against one process. The tiny
    architecture computes in bf16, and each rank rounds its partial
    ``wo``/``w_down`` product to bf16 before the sum, where one process
    rounds the whole product once (the JAX package's GSPMD sum does the
    same; its own bf16 sharded-forward test allows 5e-2 on the logits): the
    train losses of steps 1 and 2 and the step-0 val losses are held at
    the one-device forward tolerance (rtol 1e-4; measured 1.6e-5), the
    params of step 2 and of the end to the Adam allowance of every element
    (2 lr a moving step + 2e-6). Rank 0 writes each checkpoint once with
    whole leaves, so one process resumed under ``fsdp`` from the step-2
    checkpoint reads the tp ranks' step-2 params and logs their
    step-3 train losses within the same tolerance."""
    tmp = str(tmp_path)
    p2, out2 = _config(tmp, "two")
    _strategy(p2, "tp")
    p1, out1 = _config(tmp, "one")
    _wait(_spawn(_main(p2), 2) + [_single(_main(p1))])
    (l2, v2, _), (l1, v1, _) = _records(out2), _records(out1)
    assert len(l2) == len(l1) == 3 and len(v2) == len(v1) == 2
    _close_losses(l2[:2], l1[:2], "train losses by source, two tp ranks vs one process")
    _close_losses(v2[:1], v1[:1], "val losses of step 0")
    ckpts = os.path.join(out2, "checkpoints")
    assert sorted(os.listdir(ckpts)) == ["2", "3"]
    full = _final(out1)
    state = _state_params(os.path.join(ckpts, "2"))
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in full.items()}
    _within_adam_bound(state, _state_params(os.path.join(out1, "checkpoints", "2")),
                       "step 2, two tp ranks vs one process", moving_steps=1)
    f2 = _final(out2)
    _within_adam_bound(f2, full, "two tp ranks vs one process", moving_steps=2)

    p3, out3 = _config(tmp, "resumed")  # strategy fsdp, one process
    shutil.copytree(os.path.join(ckpts, "2"), os.path.join(out3, "checkpoints", "2"))
    _wait([_single(_main(p3))])
    l3, _, _ = _records(out3)
    _close_losses(l3, l2[2:], "resumed under fsdp on one process vs two tp ranks")
    _within_adam_bound(_final(out3), f2, "resumed under fsdp vs two tp ranks", moving_steps=1)
