"""RLHF's trainer/sampler topology and FSDP x TP training over
``torch.distributed`` against the JAX package, four gloo ranks on the CPU.

One module-level spawn of four ranks (``tests/_torch_tp_worker.py
topology``, which imports torch and the port only) runs every check while
the JAX references run in this process on four of its virtual CPU devices:

- (a) ``TrainerSamplerTopology.create(2)``: the trainer ``(1, 2, 1)`` on
  ranks 0-1 and the sampler ``(1, 1, 2)`` on ranks 2-3, as JAX's
  ``create(n_sampler=2, devices=jax.devices()[:4])`` lays them out; the
  trainer's shards are JAX's on its devices and the weight push lands on
  each sampler rank, bit for bit, as the block JAX's push holds on its
  device;
- (b) two GRPO steps with ``rollout_via_engine`` and two through
  ``generate``, set up as ``test_multimesh_grpo_matches_single_mesh`` sets
  them up (fp32, greedy, kl_beta 0.04, a length reward): rewards and
  completion lengths equal to the port's one-process trainer's and to
  JAX's single-mesh trainer's, the loss within JAX's abs 1e-4, the same
  stats on every rank;
- (c) two ``fsdp_tp`` train steps on ``(1, 2, 2)`` against JAX's
  ``make_train_step`` on four devices (``__graft_entry__``'s shape):
  loss and grad norm rtol 1e-5, params atol 2e-6;
- (d) one step of ``training.rlhf.main --sampler_devices 2`` over the four
  ranks on ``test_torch_rlhf_main``'s tiny fixture.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import one_torch_thread  # noqa: F401
from test_rlhf_topology import _LenReward, _dataset as _jax_rlhf_dataset
from test_torch_distributed import _flat, _jax_paths, _leaf_close, _spawn, _wait
from test_torch_rlhf_main import _config as _rlhf_config, _dataset as _rlhf_dataset
from test_torch_tensor_parallel import _inputs
from tts_max_tpu.core import tokenization as jtok
from tts_max_tpu.core.config import MeshConfig, RLHFConfig as JRLHFConfig
from tts_max_tpu.models import llama as jllama
from tts_max_tpu.parallel.mesh import build_mesh
from tts_max_tpu.training import optim as joptim
from tts_max_tpu.training import train_step as jts
from tts_max_tpu.training.rlhf import grpo as jgrpo
from tts_max_tpu.training.rlhf.topology import TrainerSamplerTopology as JTopology
from tts_max_tpu_torch import convert
from tts_max_tpu_torch.core import tokenization
from tts_max_tpu_torch.core.config import RLHFConfig
from tts_max_tpu_torch.data.samples import Sample
from tts_max_tpu_torch.models import llama
from tts_max_tpu_torch.training.rlhf import grpo
from tts_max_tpu_torch.training.rlhf.dataset import TtsRLHFDataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_tp_worker.py")
WORLD = 4
STATS = ("reward_mean", "completion_len", "loss", "mean_logp", "grad_norm", "step")
PAIRS = ([0, 1], [1, 2])


def _rlhf_cfg(cls):
    return cls(num_generations=2, max_completion_length=8, max_prompt_length=64,
               temperature=0.0, repetition_penalty=1.0, kl_beta=0.04)


def _grpo_model():
    tok = jtok.build_byte_tokenizer()
    cfg = dataclasses.replace(jllama.tiny_config(vocab_size=len(tok), max_seq_len=512),
                              dtype=jnp.float32)
    return tok, cfg, jllama.init_params(jax.random.PRNGKey(0), cfg)


def _jax_grpo(tok, cfg, params):
    """JAX's single-mesh trainer: [stats row] of the two steps."""
    sv = jtok.speech_vocab(tok)
    ds = _jax_rlhf_dataset(tok)
    trainer = jgrpo.GRPOTrainer(params, cfg, tok, sv, [_LenReward()], _rlhf_cfg(JRLHFConfig),
                                learning_rate=1e-4)
    return np.array([[s[k] for k in STATS]
                     for s in (trainer.train_step([ds[i] for i in p]) for p in PAIRS)])


def _port_grpo(params_np, how):
    """The port's one-process trainer on the same weights."""
    tok = tokenization.build_byte_tokenizer()
    sv = tokenization.speech_vocab(tok)
    samples = [Sample.from_json({"wav_path": f"w{i}.wav", "transcript": f"text {i}",
                                 "language": "en", "duration": 1.0, "sample_rate": 16000},
                                "ds") for i in range(3)]
    ds = TtsRLHFDataset("ds", samples, np.arange(30, dtype=np.int32) % 65536,
                        [(0, 10), (10, 20), (20, 30)], tok)
    cfg = dataclasses.replace(llama.tiny_config(vocab_size=len(tok), max_seq_len=512),
                              dtype=torch.float32)
    trainer = grpo.GRPOTrainer(convert.llama_from_numpy(params_np, cfg, device="cpu"), cfg,
                               tok, sv, [_LenReward()], _rlhf_cfg(RLHFConfig),
                               learning_rate=1e-4, rollout_via_engine=how == "engine",
                               engine_max_batch=4)
    rows = []
    for p in PAIRS:
        s = trainer.train_step([ds[i] for i in p])
        rows.append([s[k] for k in STATS])
    return np.array(rows)


def _jax_fsdp_tp(models, inputs):
    """Two JAX steps on (1, 2, 2): [(metrics, params)]."""
    cfg, params = models["train"]
    cfg = dataclasses.replace(cfg, remat=True)
    mesh = build_mesh(MeshConfig(data=1, fsdp=2, tensor=2), devices=jax.devices()[:WORLD])
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
        out.append((jax.tree_util.tree_map(np.asarray, m), p))
    return out


def _jax_push(models):
    topo = JTopology.create(n_sampler=2, devices=jax.devices()[:WORLD])
    params = models["serve"][1]
    return topo, topo.shard_for_trainer(params), topo.push_to_sampler(
        topo.shard_for_trainer(params))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("topology")
    models, inputs = _inputs()
    tok, gcfg, gparams = _grpo_model()
    inputs.update({f"w_grpo/{k}": v for k, v in _flat(gparams).items()})
    np.savez(os.path.join(d, "inputs.npz"), **inputs)
    os.makedirs(d / "wavs")
    _rlhf_dataset(str(d / "ds"), str(d / "wavs"))
    path, _ = _rlhf_config(d)
    assert path == str(d / "rlhf.json")
    procs = _spawn([sys.executable, WORKER, "topology", str(d)], WORLD)
    try:
        gnp = jax.tree_util.tree_map(np.asarray, gparams)
        ref = {"push": _jax_push(models), "fsdp_tp": _jax_fsdp_tp(models, inputs),
               "jax_grpo": _jax_grpo(tok, gcfg, gparams),
               "port_grpo": {how: _port_grpo(gnp, how) for how in ("engine", "generate")}}
    finally:
        _wait(procs)
    outs = [dict(np.load(os.path.join(d, f"out_{r}.npz"))) for r in range(WORLD)]
    return outs, ref, str(d)


def test_split_matches_jax(run):
    """(a): each side's ranks and mesh; JAX's sub-meshes hold the same
    devices (by id) in the same places."""
    outs, ref, _ = run
    jtopo = ref["push"][0]
    assert dict(jtopo.trainer_mesh.shape) == {"data": 1, "fsdp": 2, "tensor": 1}
    assert dict(jtopo.sampler_mesh.shape) == {"data": 1, "fsdp": 1, "tensor": 2}
    ids = {"trainer": [d.id for d in jtopo.trainer_mesh.devices.flat],
           "sampler": [d.id for d in jtopo.sampler_mesh.devices.flat]}
    for r in range(WORLD):
        np.testing.assert_array_equal(outs[r]["topo/ranks"], [ids["trainer"], ids["sampler"]])
        trains = r in ids["trainer"]
        side = ids["trainer"] if trains else ids["sampler"]
        shape = (1, 2, 1) if trains else (1, 1, 2)
        i = side.index(r)
        coords = (0, i, 0) if trains else (0, 0, i)
        assert outs[r]["topo/mesh"].tolist() == [*shape, *coords, int(trains)]
    assert not set(ids["trainer"]) & set(ids["sampler"])


def test_weight_push_lands_the_jax_blocks_bitwise(run):
    """(a): a trainer rank holds JAX's shard on its device; a sampler rank
    holds, bit for bit, the block JAX's push leaves on its device."""
    outs, ref, _ = run
    _, sharded, pushed = ref["push"]
    devices = jax.devices()[:WORLD]
    for tree in (sharded, pushed):
        for key, arr in _jax_paths(tree):
            for shard in arr.addressable_shards:
                r = devices.index(shard.device)
                np.testing.assert_array_equal(outs[r][f"topo/local/{key}"],
                                              np.asarray(shard.data), err_msg=f"r{r} {key}")
    # the attention projection is split over the sampler's two ranks
    wq = outs[2]["topo/local/layers/attn/wq/kernel"]
    assert wq.shape[-1] * 2 == np.asarray(pushed["layers"]["attn"]["wq"]["kernel"]).shape[-1]


@pytest.mark.parametrize("how", ["engine", "generate"])
def test_multimesh_grpo_matches_single_mesh(run, how):
    """(b): the same stats on every rank; rewards and completion lengths
    equal to the one-process port trainer's and JAX's single-mesh
    trainer's, losses within abs 1e-4, mean logprob and grad norm to the
    port's within the same."""
    outs, ref, _ = run
    got = outs[0][f"grpo/{how}/stats"]
    for r in range(1, WORLD):
        np.testing.assert_array_equal(outs[r][f"grpo/{how}/stats"], got)
        np.testing.assert_array_equal(outs[r][f"grpo/{how}/tokens"],
                                      outs[0][f"grpo/{how}/tokens"])
    for want in (ref["port_grpo"][how], ref["jax_grpo"]):
        np.testing.assert_array_equal(got[:, :2], want[:, :2])  # rewards, lengths
        np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=0, atol=1e-4)  # loss
        np.testing.assert_array_equal(got[:, 5], [1, 2])
    np.testing.assert_allclose(got[:, 3:5], ref["port_grpo"][how][:, 3:5], rtol=0, atol=1e-4)
    if how == "engine":  # the sampler's engine holds one KV head a rank
        for r in (2, 3):
            assert int(outs[r]["grpo/engine/engine_kv_heads"]) == 1


def test_fsdp_tp_steps_match_jax(run):
    """(c): loss, grad norm and tokens of both steps on every rank, and the
    params after the second."""
    outs, ref, _ = run
    for k, (mj, _) in enumerate(ref["fsdp_tp"], 1):
        for r in range(WORLD):
            loss, gnorm, nonfinite, tokens = outs[r][f"fsdp_tp/s{k}/metrics"]
            np.testing.assert_allclose(loss, float(mj.loss), rtol=1e-5)
            np.testing.assert_allclose(gnorm, float(mj.grad_norm), rtol=1e-5)
            assert nonfinite == 0.0 and tokens == int(mj.tokens)
    for key, arr in _jax_paths(ref["fsdp_tp"][-1][1]):
        for r in range(WORLD):
            _leaf_close(outs[r][f"fsdp_tp/params/{key}"], np.asarray(arr), atol=2e-6,
                        what=f"r{r} {key}")


def test_rlhf_entry_point_over_a_trainer_sampler_split(run):
    """(d): one step of ``training.rlhf.main --sampler_devices 2``: every
    rank returns the same finite stats, the trainer ranks hold params and
    the sampler ranks none, and rank 0 alone wrote the config and the
    metrics."""
    outs, _, d = run
    for r in range(WORLD):
        np.testing.assert_array_equal(outs[r]["main/stats"], outs[0]["main/stats"])
        assert int(outs[r]["main/trains"]) == int(r < 2)
    loss, reward, length, step = outs[0]["main/stats"]
    assert np.isfinite([loss, reward]).all() and length > 0 and step == 1
    out = os.path.join(d, "out")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        assert len([json.loads(line) for line in f]) == 1
    assert os.path.isfile(os.path.join(out, "training_config.json"))
