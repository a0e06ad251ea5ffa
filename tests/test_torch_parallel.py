"""The port's mesh, rendezvous and partition rules (``tts_max_tpu_torch/parallel``)
against the JAX package's (``tts_max_tpu/parallel``), in this process.

Mesh shapes: every ``Strategy`` over 1, 2, 4 and 8 ranks, JAX's evaluated
on that many of this process's virtual CPU devices, ValueErrors included.
Partition specs: leaf by leaf against ``params_shardings`` for the tiny
Llama on ``(1, 2, 1)``, ``mesh8``, ``(1, 1, 2)``, ``(1, 2, 2)`` and
``(1, 4, 2)``, and for Llama-3.2-1B's and Llama-3.1-8B's shapes through
``jax.eval_shape`` (nothing allocated); the shards of both axes put together
again; RLHF's trainer/sampler shapes and errors against JAX's for worlds
2-8; which Llama blocks run tensor-parallel. The launcher variables of torchrun,
of SLURM and of neither. Shards of a leaf put together again, an
indivisible dim kept whole. And ``training.main`` under torchrun's
variables at world size 1 on gloo, in this process: the same losses as
without a launcher, through the collectives the mesh step makes.
"""

import json
import os
import socket

import jax
import numpy as np
import pytest
import torch

from _torch_fixtures import one_torch_thread  # noqa: F401
from tts_max_tpu.core.config import MeshConfig as JMeshConfig, Strategy as JStrategy
from tts_max_tpu.models import llama as jllama
from tts_max_tpu.parallel import mesh as jmesh
from tts_max_tpu.parallel import sharding as jsharding
from tts_max_tpu_torch.core.config import ExperimentConfig, MeshConfig, Strategy, from_dict
from tts_max_tpu_torch.parallel import collectives, mesh as pmesh
from tts_max_tpu_torch.data.loader import DataLoader
from tts_max_tpu_torch.parallel.sharding import ShardLayout, params_specs
from tts_max_tpu_torch.training.optim import tree_items


def _jax_shape(strategy, n, monkeypatch):
    """JAX's ``mesh_for_strategy`` over the first n devices, or its error."""
    devices = jax.devices()[:n]
    monkeypatch.setattr(jmesh.jax, "devices", lambda *a: devices)
    try:
        m = jmesh.mesh_for_strategy(JStrategy(strategy.value), n)
        return tuple(m.shape[a] for a in jmesh.AXIS_NAMES)
    except ValueError as e:
        return ("ValueError", str(e))
    finally:
        monkeypatch.undo()


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_shapes_match_jax(n, monkeypatch):
    for strategy in Strategy:
        want = _jax_shape(strategy, n, monkeypatch)
        try:
            got = pmesh.mesh_for_strategy(strategy, n)
        except ValueError as e:
            got = ("ValueError", str(e))
        assert got == want, (strategy, n)
    for cfg in (MeshConfig(-1, 2, 1), MeshConfig(2, 2, 2), MeshConfig(3, 1, 1),
                MeshConfig(-1, 3, 1)):
        try:
            want = jmesh.resolve_mesh_shape(JMeshConfig(cfg.data, cfg.fsdp, cfg.tensor), n)
        except ValueError as e:
            want = ("ValueError", str(e))
        try:
            got = pmesh.resolve_mesh_shape(cfg, n)
        except ValueError as e:
            got = ("ValueError", str(e))
        assert got == want, (cfg, n)


def _jax_specs(params, mesh):
    return {jsharding.path_str(p): tuple(s.spec) + (None,) * (len(x.shape) - len(s.spec))
            for (p, s), x in zip(
                jax.tree_util.tree_flatten_with_path(jsharding.params_shardings(params, mesh))[0],
                jax.tree_util.tree_leaves(params))}


def _sizes(mesh):
    return {a: mesh.shape[a] for a in jmesh.AXIS_NAMES}


def test_partition_specs_match_jax(mesh8):
    tiny = jax.eval_shape(lambda: jllama.init_params(
        jax.random.PRNGKey(0), jllama.tiny_config(vocab_size=128, max_seq_len=64)))
    big = jax.eval_shape(lambda: jllama.init_params(
        jax.random.PRNGKey(0), jllama.config_for_architecture("llama-1b")))
    fsdp2 = jmesh.build_mesh(JMeshConfig(1, 2, 1), devices=jax.devices()[:2])
    seen = set()
    for params in (tiny, big):
        for mesh in (fsdp2, mesh8):
            want = _jax_specs(params, mesh)
            got = params_specs(params, _sizes(mesh))
            assert got == want
            seen |= {a for s in got.values() for a in s if a}
    assert seen == {"data", "fsdp", "tensor"} - {"data"}  # the rules name no data axis
    one = params_specs(big, {"data": 1, "fsdp": 1, "tensor": 1})
    assert all(s == (None,) * len(s) for s in one.values())  # size-1 axes dropped


def _layout(params, shape, index, strategy="fsdp"):
    mesh = pmesh.Mesh(shape, (0, index, 0), shards_params=Strategy(strategy) is Strategy.FSDP
                      or shape[1] > 1)
    return ShardLayout(params, mesh)


def test_shards_put_together_again():
    """Rank i's block of each split leaf, joined in rank order, is the leaf;
    a dim that 2 does not divide stays whole on both ranks; one rank of an
    fsdp mesh splits into one block, a dp mesh splits nothing; the loader
    gives rank r of n rows [r B/n, (r + 1) B/n) of a global batch of B."""
    g = torch.Generator().manual_seed(0)
    params = {"embed": {"embedding": torch.randn(10, 6, generator=g)},
              "layers": {"attn": {"wq": {"kernel": torch.randn(2, 6, 4, generator=g)},
                                  "wo": {"kernel": torch.randn(2, 4, 5, generator=g)}},
                         "attn_norm": {"scale": torch.randn(2, 6, generator=g)}}}
    layouts = [_layout(params, (1, 2, 1), i) for i in range(2)]
    assert layouts[0].dims == {"embed/embedding": 1, "layers/attn/wq/kernel": 1,
                               "layers/attn/wo/kernel": None,  # 5 does not divide by 2
                               "layers/attn_norm/scale": None}
    shards = [lay.shard(params) for lay in layouts]
    for path, full in tree_items(params):
        d = layouts[0].dims[path]
        parts = [dict(tree_items(s))[path] for s in shards]
        if d is None:
            assert all(p is full for p in parts)
        else:
            assert all(p.shape[d] == full.shape[d] // 2 for p in parts)
            assert torch.equal(torch.cat(parts, d), full)
    state = {"count": 3, "mu": params, "nu": params}
    assert layouts[1].shard_opt_state(state)["count"] == 3
    one = _layout(params, (1, 1, 1), 0)
    assert one.sharded == {"embed/embedding", "layers/attn/wq/kernel", "layers/attn/wo/kernel"}
    assert _layout(params, (1, 1, 1), 0, "dp").sharded == frozenset()
    rows = [next(DataLoader(list(range(16)), 8, list, shuffle=False, process_index=r,
                            process_count=2).batches()) for r in range(2)]
    assert rows == [[0, 1, 2, 3], [4, 5, 6, 7]]  # rank r: rows [r B/n, (r + 1) B/n)
    with pytest.raises(ValueError):
        DataLoader(list(range(16)), 6, list, process_count=4)


@pytest.mark.parametrize("shape", [(1, 1, 2), (1, 2, 2), (1, 4, 2)])
def test_tensor_partition_specs_match_jax(shape):
    """Leaf by leaf, JAX's ``params_shardings`` under a tensor axis, for the
    tiny Llama (vocab 128 and an odd 129, whose vocab stays whole) and
    Llama-3.2-1B's shapes; ``ShardLayout`` splits the same dims over each
    axis."""
    n = shape[0] * shape[1] * shape[2]
    mesh = jmesh.build_mesh(JMeshConfig(*shape), devices=jax.devices()[:n])
    for cfg in (jllama.tiny_config(vocab_size=128, max_seq_len=64),
                jllama.tiny_config(vocab_size=129, max_seq_len=64),
                jllama.config_for_architecture("llama-1b")):
        params = jax.eval_shape(lambda: jllama.init_params(jax.random.PRNGKey(0), cfg))
        want = _jax_specs(params, mesh)
        assert params_specs(params, _sizes(mesh)) == want
        lay = ShardLayout(params, pmesh.Mesh(shape, shards_params=shape[1] > 1,
                                             splits_tensor=True))
        for path, spec in want.items():
            assert lay.dims[path] == (spec.index("fsdp") if "fsdp" in spec else None), path
            assert lay.tdims[path] == (spec.index("tensor") if "tensor" in spec else None)


def test_llama8b_plan_on_fsdp_tp():
    """Llama-3.1-8B's plan on (1, 4, 2) through ``jax.eval_shape``, as
    ``test_llama8b_sharding_plan_abstract``: every spec JAX's, the embedding
    and head split over both axes, every kernel over both."""
    mesh = jmesh.build_mesh(JMeshConfig(1, 4, 2), devices=jax.devices()[:8])
    params = jax.eval_shape(lambda: jllama.init_params(
        jax.random.PRNGKey(0), jllama.llama31_8b_config()))
    got = params_specs(params, _sizes(mesh))
    assert got == _jax_specs(params, mesh)
    assert got["embed/embedding"] == ("tensor", "fsdp")
    assert got["lm_head/kernel"] == ("fsdp", "tensor")
    assert got["layers/attn/wq/kernel"] == (None, "fsdp", "tensor")
    assert got["layers/mlp/w_down/kernel"] == (None, "tensor", "fsdp")
    assert sum(1 for s in got.values() if any(s)) == 9


def test_two_axis_shards_put_together_again():
    """On (1, 2, 2) the rank at (f, t) keeps block f of the fsdp dim and
    block t of the tensor dim of each leaf (``wq`` [L, D, q]: dims 1 and 2),
    and the four blocks joined are the leaf; a tp mesh of one rank splits
    into one block (every rule-split leaf), a dp mesh nothing."""
    g = torch.Generator().manual_seed(0)
    params = {"embed": {"embedding": torch.randn(8, 6, generator=g)},
              "layers": {"attn": {"wq": {"kernel": torch.randn(2, 6, 4, generator=g)},
                                  "wo": {"kernel": torch.randn(2, 4, 6, generator=g)}},
                         "attn_norm": {"scale": torch.randn(2, 6, generator=g)}},
              "norm": {"scale": torch.randn(6, generator=g)}}
    shape = (1, 2, 2)
    lays = {(f, t): ShardLayout(params, pmesh.Mesh(shape, (0, f, t), shards_params=True,
                                                   splits_tensor=True))
            for f in range(2) for t in range(2)}
    lay = lays[0, 0]
    assert (lay.dims["layers/attn/wq/kernel"], lay.tdims["layers/attn/wq/kernel"]) == (1, 2)
    assert (lay.dims["layers/attn/wo/kernel"], lay.tdims["layers/attn/wo/kernel"]) == (2, 1)
    assert (lay.dims["embed/embedding"], lay.tdims["embed/embedding"]) == (1, 0)
    assert lay.sharded == lay.tensor_sharded == {
        "embed/embedding", "layers/attn/wq/kernel", "layers/attn/wo/kernel"}
    shards = {c: dict(tree_items(lay.shard(params))) for c, lay in lays.items()}
    for path, full in tree_items(params):
        d, t = lay.dims[path], lay.tdims[path]
        if d is None:
            assert all(shards[c][path] is full for c in lays)
            continue
        rows = [torch.cat([shards[f, tt][path] for tt in range(2)], t) for f in range(2)]
        assert torch.equal(torch.cat(rows, d), full), path
        assert shards[1, 0][path].shape[t] == full.shape[t] // 2
    one = ShardLayout(params, pmesh.Mesh((1, 1, 1), splits_tensor=True))
    assert one.tensor_sharded == lay.tensor_sharded and one.sharded == frozenset()
    assert ShardLayout(params, pmesh.Mesh((1, 1, 1))).tensor_sharded == frozenset()


@pytest.mark.parametrize("world", range(2, 9))
def test_topology_shapes_match_jax(world):
    """The trainer's and the sampler's shapes, or JAX's ValueError, for
    every n_sampler of 0 to the world."""
    from tts_max_tpu.training.rlhf.topology import TrainerSamplerTopology as JTopology
    from tts_max_tpu_torch.training.rlhf.topology import topology_shapes

    for n_sampler in range(world + 1):
        try:
            t = JTopology.create(n_sampler, devices=jax.devices()[:world])
            want = tuple(tuple(m.shape[a] for a in jmesh.AXIS_NAMES)
                         for m in (t.trainer_mesh, t.sampler_mesh))
        except ValueError as e:
            want = ("ValueError", str(e))
        try:
            got = topology_shapes(world, n_sampler)
        except ValueError as e:
            got = ("ValueError", str(e))
        assert got == want, (world, n_sampler)


def test_topology_needs_two_ranks():
    """One process (no group) has no rank to spare for a sampler: JAX's
    ValueError."""
    from tts_max_tpu_torch.training.rlhf.topology import TrainerSamplerTopology

    with pytest.raises(ValueError, match="n_sampler=1 must leave >=1 trainer device of 1"):
        TrainerSamplerTopology.create(1)


def test_tensor_parallel_plan():
    """Which blocks run split: all of the tiny Llama's on two ranks; with
    ``n_kv_heads`` 1 the attention runs whole (its split leaves gathered)
    and the MLP split; an odd vocab leaves the embedding whole; quantized
    leaves, which no rule splits, run whole; a mesh that does not split
    ``tensor`` has no plan."""
    import dataclasses

    from tts_max_tpu_torch.models import llama
    from tts_max_tpu_torch.models.quantization import quantize_llama_params
    from tts_max_tpu_torch.parallel.tensor import TensorParallel

    mesh = pmesh.Mesh((1, 1, 2), groups={"tensor": None}, splits_tensor=True)
    cfg = llama.tiny_config(vocab_size=128)
    tp = TensorParallel.create(cfg, mesh)
    assert (tp.embed, tp.head, tp.attn, tp.mlp, dict(tp.whole)) == (True, True, True, True, {})
    assert tp.kv_heads(cfg) == 1
    kv1 = dataclasses.replace(cfg, n_kv_heads=1)
    tp = TensorParallel.create(kv1, mesh)
    assert (tp.attn, tp.mlp, tp.kv_heads(kv1)) == (False, True, 1)
    assert dict(tp.whole) == {"attn/wq": 1, "attn/wk": 1, "attn/wv": 1, "attn/wo": 0}
    assert not TensorParallel.create(dataclasses.replace(cfg, vocab_size=129), mesh).embed
    q = quantize_llama_params(llama.init_params(dataclasses.replace(cfg, dtype=torch.float32),
                                                device="cpu"), bits=8)
    tp = TensorParallel.create(cfg, mesh, q)
    assert (tp.embed, tp.attn, tp.mlp, dict(tp.whole)) == (False, False, False, {})
    assert TensorParallel.create(cfg, pmesh.Mesh((1, 1, 1))) is None


def test_launcher_env():
    torchrun = {"RANK": "3", "WORLD_SIZE": "8", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "4",
                "MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29500"}
    env = pmesh.launcher_env(torchrun)
    assert env == pmesh.LauncherEnv("torchrun", 3, 1, 8, 2, "10.0.0.1", 29500)
    assert env.context() == pmesh.EnvironmentContext(3, 1, 8, 2, False)
    slurm = {"SLURM_PROCID": "0", "SLURM_NTASKS": "4", "SLURM_LOCALID": "0",
             "SLURM_NNODES": "2", "MASTER_ADDR": "node1", "MASTER_PORT": "1234"}
    assert pmesh.launcher_env(slurm) == pmesh.LauncherEnv("slurm", 0, 0, 4, 2, "node1", 1234)
    # torchrun's variables come first, as JAX's explicit ones do
    assert pmesh.launcher_env({**slurm, **torchrun}).source == "torchrun"
    assert pmesh.launcher_env({}) is None
    # one SLURM task without a rendezvous is a single process; more cannot meet
    assert pmesh.launcher_env({"SLURM_PROCID": "0", "SLURM_NTASKS": "1"}) is None
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        pmesh.launcher_env({"SLURM_PROCID": "0", "SLURM_NTASKS": "2"})
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        pmesh.launcher_env({"RANK": "0", "WORLD_SIZE": "1"})
    # world size 1 under torchrun is a launcher too (it joins a group)
    assert pmesh.launcher_env({"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "h",
                               "MASTER_PORT": "1"}).world_size == 1


def test_tensor_axis_and_batch_checks(tmp_path):
    from tts_max_tpu_torch.training import main as train_main

    cfg = from_dict(ExperimentConfig, {"training": {"batch_size": 2, "strategy": "tp"}})
    assert train_main.check_mesh(cfg, 2) == (1, 1, 2)  # tensor peers share the batch
    cfg = from_dict(ExperimentConfig, {"training": {"batch_size": 3, "strategy": "fsdp"}})
    with pytest.raises(ValueError, match="data\\*fsdp = 2"):
        train_main.check_mesh(cfg, 2)
    assert train_main.check_mesh(cfg, 1) == (1, 1, 1)
    cfg.training.strategy = Strategy.FSDP_TP
    with pytest.raises(ValueError, match="data\\*fsdp = 2"):
        train_main.check_mesh(cfg, 4)
    cfg.training.batch_size = 4
    assert train_main.check_mesh(cfg, 4) == (1, 2, 2)
    with pytest.raises(ValueError, match="does not divide"):
        train_main.check_mesh(cfg, 1)  # as JAX's fsdp_tp on one device
    assert pmesh.initialize_distributed("cpu") == pmesh.EnvironmentContext()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_world_size_one_group_matches_one_process(tmp_path, monkeypatch):
    """``training.main`` under torchrun's variables at world size 1 joins a
    gloo group and runs the FSDP step (one block a leaf, every collective
    issued); its losses equal the run without a launcher. The collectives
    of its 2 steps (2 layers, 7 split leaves a layer, remat, the chunked
    loss) follow from the step's structure, and the group is gone after
    (a dry run's too)."""
    import torch.distributed as dist

    from test_torch_train_main import _config, _run

    path, cfg = _config(tmp_path)
    cfg["training"]["strategy"] = "fsdp"
    cfg["checkpointing"]["save_steps"] = 0
    cfg.pop("val_weighted_datasets")
    with open(path, "w") as f:
        json.dump(cfg, f)
    alone = _run(path, "--total_steps", "2")
    os.rename(cfg["output_dir"], cfg["output_dir"] + "_alone")
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}.items():
        monkeypatch.setenv(k, v)
    assert _run(path, "--dry_run") is None and not dist.is_initialized()
    assert not os.path.exists(cfg["output_dir"])  # a dry run writes nothing
    collectives.reset_counts()
    grouped = _run(path, "--total_steps", "2")
    got = collectives.counts()
    assert not dist.is_initialized()
    np.testing.assert_allclose([m.loss for _, m, _, _ in grouped.steps],
                               [m.loss for _, m, _, _ in alone.steps], rtol=1e-5)
    S, L, leaves = 2, 2, 7 + 1  # steps, layers, split leaves (7 a layer, the embedding)
    # a step: the embedding once and each layer twice (forward, recompute);
    # at the end the last checkpoint and the final model gather every split
    # leaf (the checkpoint's of the params, mu and nu)
    assert got == dict(all_gather=S * (1 + 2 * 7 * L) + 3 * leaves + leaves,
                       reduce_scatter_sum=S * (7 * L + 1),
                       # counts, loss terms, whole grads, norm; the statistics'
                       # sum (logging_steps 1)
                       all_reduce_sum=4 * S + S,
                       barrier=2)  # after the checkpoint, after the final model


def test_rank_groups_follow_jax_device_order(mesh8):
    """Rank r sits where JAX's mesh puts device r: each axis group (and the
    batch group of data x fsdp) holds the ranks JAX's device array lines up
    along that axis, on ``mesh8`` (2, 2, 2) and on (2, 4, 1)."""
    for jm in (mesh8, jmesh.build_mesh(JMeshConfig(2, 4, 1), devices=jax.devices())):
        ids = np.vectorize(lambda d: d.id)(jm.devices)
        shape = ids.shape
        for axes in (("data",), ("fsdp",), ("tensor",), ("data", "fsdp")):
            moved = np.moveaxis(ids, [jmesh.AXIS_NAMES.index(a) for a in axes],
                                list(range(len(axes))))
            want = {tuple(g) for g in moved.reshape(
                int(np.prod([shape[jmesh.AXIS_NAMES.index(a)] for a in axes])), -1).T}
            assert set(pmesh._axis_members(shape, axes)) == want, axes
