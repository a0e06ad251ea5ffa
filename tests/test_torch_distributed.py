"""The port's data-parallel and FSDP training over ``torch.distributed``
against the JAX package's sharded steps, two gloo ranks on the CPU.

One module-level spawn of two ranks (``tests/_torch_dist_worker.py``, which
imports torch and the port only) runs every in-step check while the JAX
references compile in this process, on meshes of two of its virtual CPU
devices. The tiny Llama's weights are JAX's seeded ``init_params``, the
GAN's the port's seeded inits (as ``test_torch_gan.py`` draws them); every
batch is seeded numpy. Ranks hand their results back as ``.npz``:

- (a) two steps on ``(2, 1, 1)`` whose ranks hold different valid-token
  counts and pad lengths, against JAX's ``make_train_step`` on the global
  batch (each rank's rows padded to the longest);
- (b) FSDP on ``(1, 2, 1)`` with two accumulation micro-steps, the chunked
  loss and remat: the same, plus each rank's shards of the params (JAX's
  own shard on its device) and of Adam's moments, and the collectives a
  step makes;
- (c) one data-parallel GAN step against JAX's ``make_gan_step(mesh=...)``;
- (d) ``make_process_sum`` and ``barrier``; the statistics and eval
  metrics of ranks that saw different data sources, reduced over every
  dataset's name; the health statistics of fsdp shards; two steps of the GAN loop
  (``training.codec.gan_loop``) in the group: the ranks stay in step;
- (e) two ``python -m tts_max_tpu_torch.training.main --device cpu`` ranks
  under torchrun's variables against one process, and a one-process resume
  from the two ranks' checkpoint.

Tolerances are the one-device parity tests': losses and grad norms rtol
1e-5; params atol 2e-6 after the second step (the first runs at lr 0 under
warmup), mu 1e-4 and nu 1e-3 of each leaf's max (``test_torch_train_step``);
GAN losses 1e-5 of their magnitude and params atol 1e-5 max(|ref|, 1) at
Adam eps 1e-3 (``test_torch_gan``, which says why).
"""

import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_dist_worker as worker
from _torch_fixtures import one_torch_thread  # noqa: F401
from tts_max_tpu.core.config import CodecTrainingConfig as JCodecConfig, MeshConfig
from tts_max_tpu.models import llama as jllama
from tts_max_tpu.parallel.mesh import build_mesh
from tts_max_tpu.training import optim as joptim
from tts_max_tpu.training import train_step as jts
from tts_max_tpu.training.codec import gan as jgan
from tts_max_tpu.models.codec import discriminator as jdisc, vocos as jvocos
from test_torch_gan import _codec_dataset
from tts_max_tpu_torch.data import codes_io
from tts_max_tpu_torch.data.samples import Sample
from tts_max_tpu_torch.models import safetensors_io
from tts_max_tpu_torch.parallel import collectives
from tts_max_tpu_torch.training import optim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_dist_worker.py")
SPAWN_TIMEOUT = 180


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(argv, world, extra_env=None):
    """``world`` processes of ``argv`` under torchrun's variables."""
    port = _free_port()
    base = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    base.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", **(extra_env or {}))
    return [subprocess.Popen(
        argv, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**base, "RANK": str(r), "WORLD_SIZE": str(world), "LOCAL_RANK": str(r),
             "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
             "MASTER_PORT": str(port)}) for r in range(world)]


def _single(argv):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env)


def _wait(procs):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-4000:]
    return outs


def _rows(rng, b, L, masked, tail=0):
    """[1, b, L] ids and labels: the first ``masked`` labels and a pad tail
    of ``tail`` positions ignored (-100, pad id 0)."""
    ids = rng.integers(1, 128, (1, b, L)).astype(np.int32)
    labels = ids.copy()
    labels[:, :, :masked] = -100
    if tail:
        ids[:, :, L - tail:] = 0
        labels[:, :, L - tail:] = -100
    return ids, labels


def _pad(a, L, fill):
    out = np.full(a.shape[:-1] + (L,), fill, a.dtype)
    out[..., :a.shape[-1]] = a
    return out


def _inputs(jparams):
    """The workers' inputs: weights, per-rank batches of both steps of (a)
    and (b), and the GAN's global batch."""
    rng = np.random.default_rng(0)
    out = {f"llama/{k}": np.asarray(v) for k, v in _flat(jparams).items()}
    for k in (1, 2):
        # (a): rank 0 pads to 16 with 4 prompt labels masked; rank 1 to 24,
        # with a 6-token pad tail and 2 masked: other counts and lengths
        for r, rows in enumerate((_rows(rng, 2, 16, 4), _rows(rng, 2, 24, 2, tail=6))):
            out[f"dp/s{k}/input_ids/r{r}"], out[f"dp/s{k}/labels/r{r}"] = rows
        # (b): two micro-batches a rank, rank 0 at 32 and rank 1 at 20
        for r, (L, m) in enumerate(((32, 3), (20, 5))):
            micro = [_rows(rng, 2, L, m + a, tail=2 * a) for a in range(2)]
            out[f"fsdp/s{k}/input_ids/r{r}"] = np.concatenate([x[0] for x in micro])
            out[f"fsdp/s{k}/labels/r{r}"] = np.concatenate([x[1] for x in micro])
    out["gan/audio_codes"] = rng.integers(0, 65536, (4, 8)).astype(np.int32)
    out["gan/wav"] = (0.1 * rng.standard_normal((4, 8 * 320))).astype(np.float32)
    return out


def _global(inputs, name, k):
    """The global batch [A, 4, L_max] of step k: rank 0's rows, then rank 1's."""
    L = max(inputs[f"{name}/s{k}/input_ids/r{r}"].shape[-1] for r in range(2))
    return {f: np.concatenate([_pad(inputs[f"{name}/s{k}/{f}/r{r}"], L,
                                    0 if f == "input_ids" else -100) for r in range(2)],
                              axis=1) for f in ("input_ids", "labels")}


def _flat(tree, prefix=""):
    out = {}
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, dtype=np.float32)
    return out


def _jax_mesh(shape):
    return build_mesh(MeshConfig(data=shape[0], fsdp=shape[1], tensor=shape[2]),
                      devices=jax.devices()[:2])


def _jax_llama(jcfg, jparams, inputs, name, shape, chunk):
    """Two JAX sharded steps: [(metrics, params, opt_state)] after each."""
    mesh = _jax_mesh(shape)
    tx = joptim.create_optimizer(joptim.cosine_warmup_schedule(1e-3, 1, 10))
    p_sh = jts.params_shardings(jparams, mesh)
    step = jts.make_train_step(mesh, jcfg, tx, jparams, loss_chunk_size=chunk)
    p = jax.device_put(jparams, p_sh)
    o = jax.device_put(tx.init(jparams), jts._opt_state_shardings(tx, jparams, p_sh, mesh))
    out = []
    for k in (1, 2):
        batch = jax.device_put(_global(inputs, name, k),
                               {f: jts.data_sh_axis1(mesh) for f in ("input_ids", "labels")})
        p, o, m = step(p, o, batch)
        out.append((jax.tree_util.tree_map(np.asarray, m), p, o))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two ranks' results and the JAX references, computed meanwhile."""
    d = str(tmp_path_factory.mktemp("dist"))
    base = dataclasses.replace(jllama.tiny_config(vocab_size=128, max_seq_len=64),
                               dtype=jnp.float32)
    jparams = jllama.init_params(jax.random.PRNGKey(0), base)
    inputs = _inputs(jparams)
    np.savez(os.path.join(d, "inputs.npz"), **inputs)
    _codec_dataset(os.path.join(d, "codec"))
    with open(os.path.join(d, "gan_loop.json"), "w") as f:
        json.dump({"training": {"seed": 3, "logging_steps": 1, "batch_size": 4},
                   "checkpointing": {"save_steps": 2, "keep_only_last_n_checkpoints": 1},
                   "codec": {"code_window_size": 16},
                   "train_weighted_datasets": {os.path.join(d, "codec"): 1.0},
                   "output_dir": os.path.join(d, "gan_run")}, f)
    procs = _spawn([sys.executable, WORKER, d], 2)
    try:
        ref = {"dp": _jax_llama(base, jparams, inputs, "dp", (2, 1, 1), 0),
               "fsdp": _jax_llama(dataclasses.replace(base, remat=True), jparams, inputs,
                                  "fsdp", (1, 2, 1), 16),
               "gan": _jax_gan(inputs)}
    finally:
        _wait(procs)
    outs = [dict(np.load(os.path.join(d, f"out_{r}.npz"))) for r in range(2)]
    return outs, ref, inputs, d


def _leaf_close(got, want, atol=None, rel=None, what=""):
    if atol is not None:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)
    else:
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= rel, f"{what}: {err:.2e} of max|ref|"


@pytest.mark.parametrize("name", ["dp", "fsdp"])
def test_sharded_step_matches_jax(run, name):
    """(a) and (b): loss, grad norm and tokens of both steps, then the
    params and Adam's moments, on both ranks."""
    outs, ref, _, _ = run
    for k, (mj, pj, oj) in enumerate(ref[name], 1):
        for r in range(2):
            loss, gnorm, nonfinite, tokens = outs[r][f"{name}/s{k}/metrics"]
            np.testing.assert_allclose(loss, float(mj.loss), rtol=1e-5)
            np.testing.assert_allclose(gnorm, float(mj.grad_norm), rtol=1e-5)
            assert nonfinite == float(mj.nonfinite) == 0.0 and tokens == int(mj.tokens)
    _, pj, oj = ref[name][-1]
    for key, want in _flat(jax.tree_util.tree_map(np.asarray, pj)).items():
        for r in range(2):
            _leaf_close(outs[r][f"{name}/params/{key}"], want, atol=2e-6, what=f"r{r} {key}")
    for r in range(2):
        assert int(outs[r][f"{name}/count"]) == int(oj[0].count) == 2


def _fsdp_dim(path):
    """The dim the rule splits over fsdp, for the tiny Llama (every such
    dim divides by 2)."""
    rules = {"embed/embedding": 1, "layers/attn/wq/kernel": 1, "layers/attn/wk/kernel": 1,
             "layers/attn/wv/kernel": 1, "layers/attn/wo/kernel": 2,
             "layers/mlp/w_gate/kernel": 1, "layers/mlp/w_up/kernel": 1,
             "layers/mlp/w_down/kernel": 2}
    return rules.get(path)


def _slice(a, dim, r):
    if dim is None:
        return a
    b = a.shape[dim] // 2
    return np.take(a, np.arange(r * b, (r + 1) * b), axis=dim)


def test_fsdp_ranks_hold_the_jax_rule_shards(run):
    """(b): each rank keeps its shard of every split param and of its Adam
    moments, and the whole of every other leaf. The params' shard is the
    one JAX holds on the device at that fsdp index. JAX lays the moments out
    by shape (``_opt_state_shardings``): where two params share a shape but
    not a rule (wq and wo, both [L, 64, 64] here) a moment can take the
    other's layout; the port's moments follow their own param's rule."""
    outs, ref, _, _ = run
    _, pj, oj = ref["fsdp"][-1]
    devices = jax.devices()[:2]
    jp = dict(_jax_paths(pj))
    for key, arr in jp.items():
        dim = _fsdp_dim(key)
        for r in range(2):
            local = outs[r][f"fsdp/local/params/{key}"]
            shard = next(s for s in arr.addressable_shards if s.device == devices[r])
            assert local.shape == np.asarray(shard.data).shape == _slice(
                np.asarray(arr), dim, r).shape, key
            _leaf_close(local, np.asarray(shard.data), atol=2e-6, what=f"r{r} shard {key}")
    differs = []
    for moment, rel in (("mu", 1e-4), ("nu", 1e-3)):
        for key, arr in _jax_paths(getattr(oj[0], moment)):
            dim, full = _fsdp_dim(key), np.asarray(arr)
            jdim = next((i for i, a in enumerate(arr.sharding.spec) if a == "fsdp"), None)
            if jdim != dim:
                differs.append((moment, key))
            for r in range(2):
                local = outs[r][f"fsdp/local/{moment}/{key}"]
                assert local.shape == _slice(full, dim, r).shape, (moment, key)
                _leaf_close(local, _slice(full, dim, r), rel=rel,
                            what=f"r{r} {moment} {key}")
    assert sorted(differs) == [("mu", "layers/attn/wq/kernel"), ("nu", "layers/attn/wq/kernel")]


def _jax_paths(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _jax_paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_collectives_a_step(run):
    """(a), (b): the collectives of one step, by its structure. DP: the
    token counts, the loss terms and the whole grads, one all-reduce each.
    FSDP (A = 2 micro-steps, L = 2 layers, 7 split leaves a layer, remat):
    the embedding gathered once and each layer's leaves gathered twice a
    micro-step (forward and recompute); the layers' grads reduce-scattered
    once a micro-step and the embedding's once; a fourth all-reduce for the
    norm of the shards."""
    outs, _, _, _ = run
    names = [f.__name__ for f in collectives.COUNTED]
    A, L = 2, 2
    for r in range(2):
        assert dict(zip(names, outs[r]["dp/calls"])) == dict(
            all_reduce_sum=3, all_gather=0, reduce_scatter_sum=0, barrier=0)
        assert dict(zip(names, outs[r]["fsdp/calls"])) == dict(
            all_reduce_sum=4, all_gather=1 + A * 2 * 7 * L,
            reduce_scatter_sum=A * 7 * L + 1, barrier=0)
        assert int(outs[r]["gan/calls"]) == 3  # disc grads, gen grads, losses


def _jax_gan(inputs):
    vcfg, mpd_cfg, msd_cfg, dp, gp = worker.gan_setup()
    jdp = optim.tree_map(lambda t: jnp.asarray(t.numpy().transpose(2, 3, 1, 0) if t.ndim == 4
                                               else t.numpy()), dp)  # conv kernels as HWIO
    jgp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), gp)
    jcfg = JCodecConfig(generator_lr=worker.GAN_LRS[0], discriminator_lr=worker.GAN_LRS[1])
    jtx = [optax.adamw(lr, b1=0.9, b2=0.95, eps=worker.GAN_EPS, weight_decay=0.1)
           for lr in worker.GAN_LRS]
    jt, jf = jgan.split_generator_params(jgp)
    step = jgan.make_gan_step(jvocos.tiny_vocos_config(), jdisc.tiny_mpd_config(),
                              jdisc.tiny_msd_config(), jcfg, jf, *jtx,
                              mesh=_jax_mesh((2, 1, 1)))
    batch = {k: jnp.asarray(inputs[f"gan/{k}"]) for k in ("audio_codes", "wav")}
    return step(jt, jdp, jtx[0].init(jt), jtx[1].init(jdp), batch)


def test_gan_step_matches_jax(run):
    """(c): the six losses and both sides' params after one step."""
    outs, ref, _, _ = run
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


def test_process_sum_and_barrier(run):
    """(d): the statistics' sum over the ranks, and the rendezvous the
    workers read from torchrun's variables."""
    outs, _, _, _ = run
    for r in range(2):
        np.testing.assert_array_equal(outs[r]["sum"], [3.0, 30.0])
        assert int(outs[r]["barriers"]) == 1
        np.testing.assert_array_equal(outs[r]["env"], [r, r, 2, int(r == 0)])


def test_ranks_that_see_different_sources_sum_the_same_keys(run):
    """(d): rank 0 recorded losses for source a, rank 1 for a and b, of the
    datasets a, b and c. Each rank's vector carries every dataset's keys
    (zeros where it saw none), so the ranks sum the same keys: a's loss is
    the mean over both ranks, b's rank 1's, and c is not logged. The eval
    metrics likewise, rank 0's batch holding a, rank 1's b and c."""
    outs, _, _, _ = run
    for r in range(2):
        np.testing.assert_array_equal(outs[r]["sources/train"], [1.5, 2.5, 3.0, 2.0, 1.0, 0.0])
        np.testing.assert_array_equal(outs[r]["sources/val"], [1.5, 1.0, 2.0, 2.0])


def test_health_stats_read_whole_leaves(run):
    """(d): under fsdp the health statistics of a rank's shards are those
    of the whole params (JAX reads its global arrays), on both ranks."""
    outs, _, _, _ = run
    leaves = [v for k, v in outs[0].items() if k.startswith("fsdp/params/")]
    want = [max(np.abs(v).max() for v in leaves),
            sum(np.abs(v).astype(np.float64).sum() for v in leaves) / sum(v.size for v in leaves)]
    for r in range(2):
        np.testing.assert_allclose(outs[r]["fsdp/health"], want, rtol=1e-6)


def test_gan_loop_ranks_stay_in_step(run):
    """(d): the GAN loop in a group of two steps both ranks with the grads
    averaged over them (the JAX loop builds its step without the mesh, and
    its ranks would drift apart): the same losses and bitwise the same
    params on both, each rank on its own rows; rank 0 wrote the serving
    config, the checkpoint and the validation wavs."""
    outs, _, _, d = run
    a, b = outs
    keys = [k for k in a if k.startswith("loop/")]
    assert len(keys) > 3 and keys == [k for k in b if k.startswith("loop/")]
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert np.isfinite(a["loop/losses"]).all() and a["loop/losses"].shape[0] == 2
    run_dir = os.path.join(d, "gan_run")
    assert os.path.isfile(os.path.join(run_dir, "model_config.json"))
    assert sorted(os.listdir(os.path.join(run_dir, "checkpoints"))) == ["2"]
    assert len(os.listdir(os.path.join(run_dir, "quality", "step_2"))) == 8


# --- (e) the entry point ---------------------------------------------------

LR = 1e-4
MOVING_STEPS = 2  # of 3: the first runs at lr 0 under warmup


SOURCES = ("tiny_a", "tiny_b")  # the datasets' names: their directories'


def _dataset(path, seed):
    rng = np.random.default_rng(seed)
    for split, n in (("train", 8), ("val", 4)):
        lens = rng.integers(20, 40, n)
        codes = rng.integers(0, 65536, int(lens.sum())).astype(np.int32)
        index = np.concatenate([[0], np.cumsum(lens)[:-1]])
        samples = [Sample.from_json({"id": f"{split}{i}", "wav_path": f"{split}{i}.wav",
                                     "transcript": f"hello number {i}", "language": "en",
                                     "duration": 0.6, "sample_rate": 16000}, "tiny")
                   for i in range(n)]
        codes_io.write_shard(path, split, codes, index, samples)


def _config(tmp, out_name):
    """Seed 2 shuffles the rows so that at step 2 rank 0 holds tiny_a's
    only and rank 1 tiny_b's."""
    data = [os.path.join(tmp, name) for name in SOURCES]
    for seed, path in enumerate(data):
        if not os.path.isdir(path):
            _dataset(path, seed)
    cfg = {"training": {"batch_size": 4, "logging_steps": 1, "eval_steps": 2, "seed": 2,
                        "learning_rate": LR, "precision": "fp32", "gradient_checkpointing": True,
                        "loss_chunk_size": 16, "strategy": "fsdp"},
           "modeling": {"parameters": {"model_name": "from-scratch",
                                       "architecture": "llama-tiny", "max_seq_len": 128}},
           "checkpointing": {"save_steps": 2, "keep_only_last_n_checkpoints": 2},
           "train_weighted_datasets": dict.fromkeys(data, 1.0),
           "val_weighted_datasets": dict.fromkeys(data, 1.0),
           "output_dir": os.path.join(tmp, out_name)}
    path = os.path.join(tmp, f"{out_name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path, cfg["output_dir"]


def _main(path):
    return [sys.executable, "-m", "tts_max_tpu_torch.training.main", "--config_path", path,
            "--device", "cpu", "--total_steps", "3"]


def _records(out):
    """The train and val losses of each source ("total" first), and the
    train records."""
    with open(os.path.join(out, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    names = ("total", *SOURCES)
    return ([[r.get(f"loss/{s}") for s in names] for r in records if "loss/total" in r],
            [[r.get(f"val/loss/{s}") for s in names] for r in records if "val/loss/total" in r],
            [r for r in records if "loss/total" in r])


def _final(out):
    return safetensors_io.load_file(os.path.join(out, "final_model", "model.safetensors"))


def _assert_params(got, want, what, moving_steps=MOVING_STEPS):
    """Params within 2e-6, with ``test_torch_rlhf``'s Adam sign-noise
    allowance: a gradient near zero (the tied head's rows of the 65806
    tokens a batch never holds get softmax tails of ~1e-9) is divided by its
    own magnitude (lr g / (|g| + 1e-8)), so sums in another order (the tiny
    architecture computes in bf16, whose products on the CPU round
    differently for 2 rows and for 4) can move its weight by up to 2 lr a
    step. Such elements are held to that, and must be under 1% of all."""
    assert got.keys() == want.keys()
    noisy = total = 0
    for key in want:
        err = np.abs(got[key].numpy() - want[key].numpy())
        noisy, total = noisy + (err > 2e-6).sum(), total + err.size
        assert err.max() <= 2 * LR * moving_steps + 2e-6, (what, key, err.max())
    assert noisy < 0.01 * total, (what, noisy, total)


def _state_params(path):
    state = torch.load(os.path.join(path, "state.pt"), weights_only=True)
    return dict(optim.tree_items(state["params"]))


def _same_losses(got, want, what):
    """The same sources logged in each record, their losses within 1e-5."""
    assert [[x is None for x in r] for r in got] == [[x is None for x in r] for r in want], what
    np.testing.assert_allclose([x for r in got for x in r if x is not None],
                               [x for r in want for x in r if x is not None],
                               rtol=1e-5, err_msg=what)


def test_two_rank_entry_point_matches_one_process_and_resumes(tmp_path):
    """(e): two ranks of ``training.main`` (fsdp, global batch 4, 3 steps,
    a checkpoint every 2) on two datasets, each rank at step 2 holding rows
    of one only. Where both runs read the same params (steps 1 and 2, the
    first at lr 0, and the eval at step 0) the two ranks log the
    one-process run's train losses of each source and its total val loss
    (a source's val loss over ranks weighs each batch by the ranks that held
    the source, as JAX's does). The params of step 2 and of the end are the
    one-process run's within the Adam allowance. Rank 0 alone writes each
    checkpoint once, full size, and the final model. One process resumed
    from the two ranks' step-2 checkpoint reads their params, so it logs
    their step-2 val loss and step-3 train losses, and reaches their step-3
    params."""
    tmp = str(tmp_path)
    p2, out2 = _config(tmp, "two")
    p1, out1 = _config(tmp, "one")
    _wait(_spawn(_main(p2), 2) + [_single(_main(p1))])
    (l2, v2, rec2), (l1, v1, _) = _records(out2), _records(out1)
    assert len(l2) == len(l1) == 3 and len(v2) == len(v1) == 2
    # a source one rank held and the other did not, at some step
    assert any(r.get(f"loss_count/{s}") == 1.0 for r in rec2 for s in SOURCES)
    _same_losses(l2[:2], l1[:2], "train losses by source, two ranks vs one process")
    _same_losses(v2[:1], v1[:1], "val losses of step 0")
    assert [[x is None for x in r] for r in v2] == [[x is None for x in r] for r in v1]
    ckpts = os.path.join(out2, "checkpoints")
    assert sorted(os.listdir(ckpts)) == ["2", "3"]
    for step in ("2", "3"):
        assert sorted(os.listdir(os.path.join(ckpts, step))) == ["meta.json", "state.pt"]
    state = torch.load(os.path.join(ckpts, "2", "state.pt"), weights_only=True)
    full = _final(out1)
    for key, t in optim.tree_items(state["params"]):
        assert tuple(t.shape) == tuple(full[key].shape), key
    for key, t in optim.tree_items(state["opt_state"]["mu"]):
        assert tuple(t.shape) == tuple(full[key].shape), key
    _assert_params(_state_params(os.path.join(ckpts, "2")),
                   _state_params(os.path.join(out1, "checkpoints", "2")),
                   "step 2, two ranks vs one process", moving_steps=1)
    f2 = _final(out2)
    _assert_params(f2, full, "two ranks vs one process")

    p3, out3 = _config(tmp, "resumed")
    shutil.copytree(os.path.join(ckpts, "2"), os.path.join(out3, "checkpoints", "2"))
    _wait([_single(_main(p3))])
    l3, v3, _ = _records(out3)
    _same_losses(l3, l2[2:], "resumed on one process vs two ranks")
    _same_losses([r[:1] for r in v3], [r[:1] for r in v2[1:]], "val losses of step 2")
    _assert_params(_final(out3), f2, "resumed on one process vs two ranks")
