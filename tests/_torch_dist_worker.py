"""One rank of the port's data-parallel and FSDP checks over gloo, for
``tests/test_torch_distributed.py``. It imports torch and the port only.

    RANK=r WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/_torch_dist_worker.py <dir>

It joins the group through ``parallel.mesh.initialize_distributed("cpu")``,
reads ``<dir>/inputs.npz`` (the tiny Llama's weights by path, each step's
per-rank batches, the GAN's global batch) and writes ``<dir>/out_<r>.npz``:

- ``dp/*``: two steps of the ``(2, 1, 1)`` step (ranks with different
  valid-token counts and pad lengths): each step's loss, grad norm and
  tokens, then the params and Adam moments;
- ``fsdp/*``: the same on ``(1, 2, 1)`` with two accumulation micro-steps,
  the chunked loss and remat, this rank's shards and the gathered params,
  and the collectives of the second step;
- ``gan/*``: one data-parallel GAN step on this rank's rows of the global
  batch: its six losses and both sides' params;
- ``fsdp/health``: the health statistics of this rank's shards, each
  leaf gathered whole;
- ``sum``, ``barriers``: ``make_process_sum`` of ``[r + 1, 10 (r + 1)]`` and
  the barrier count of one ``multihost.barrier()``;
- ``sources/*``: the training statistics and the eval metrics of ranks that
  saw different sources of three datasets (a, b, c), reduced over them;
- ``loop/*``: two steps of ``training.codec.gan_loop`` in this group
  (``<dir>/gan_loop.json``, ``--tiny``): each step's losses and the final
  params.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from tts_max_tpu_torch import convert
from tts_max_tpu_torch.core.config import CodecTrainingConfig
from tts_max_tpu_torch.models import llama
from tts_max_tpu_torch.models.codec import discriminator as disc, vocos
from tts_max_tpu_torch.parallel import collectives, mesh as pmesh, multihost
from tts_max_tpu_torch.training import evaluation, optim, train_step as ts
from tts_max_tpu_torch.training.codec import gan, gan_loop
from tts_max_tpu_torch.utils.statistics import Statistics, make_process_sum

GAN_LRS = (1e-3, 1e-2)  # generator, discriminators
GAN_EPS = 1e-3


def unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def flat_np(tree, prefix: str) -> dict:
    return {f"{prefix}/{p}": np.asarray(t.detach().float()) for p, t in optim.tree_items(tree)}


def llama_setup(inputs, remat: bool):
    cfg = dataclasses.replace(llama.tiny_config(vocab_size=128, max_seq_len=64),
                              dtype=torch.float32, remat=remat)
    flat = {k[len("llama/"):]: v for k, v in inputs.items() if k.startswith("llama/")}
    params = convert.llama_from_numpy(unflatten(flat), cfg, device="cpu")
    tx = optim.create_optimizer(optim.cosine_warmup_schedule(1e-3, 1, 10))
    return cfg, params, tx


def run_llama(name, shape, strategy, inputs, rank, out, accum, chunk, remat):
    cfg, params, tx = llama_setup(inputs, remat)
    mesh = pmesh.build_mesh(shape, strategy)
    step = ts.make_train_step(mesh, cfg, tx, params, 1.0, chunk)
    p, o = step.shard(params, tx.init(params))
    for k in (1, 2):
        batch = {f: inputs[f"{name}/s{k}/{f}/r{rank}"] for f in ("input_ids", "labels")}
        collectives.reset_counts()
        p, o, m = step(p, o, {f: v.reshape(accum, -1, v.shape[-1]) for f, v in batch.items()})
        out[f"{name}/s{k}/metrics"] = np.array([m.loss, m.grad_norm, m.nonfinite, m.tokens])
    out[f"{name}/calls"] = np.array([collectives.counts()[f.__name__]
                                     for f in collectives.COUNTED])
    out.update(flat_np(p, f"{name}/local/params"))
    out.update(flat_np(o["mu"], f"{name}/local/mu"))
    out.update(flat_np(o["nu"], f"{name}/local/nu"))
    out.update(flat_np(step.layout.gather(p), f"{name}/params"))
    out[f"{name}/count"] = np.array(o["count"])
    health = evaluation.health_stats(p, step.layout)
    out[f"{name}/health"] = np.array([health["health/param_abs_max"],
                                      health["health/param_abs_avg"]])


def gan_setup():
    vcfg, mpd_cfg, msd_cfg = vocos.tiny_vocos_config(), disc.tiny_mpd_config(), \
        disc.tiny_msd_config()
    dp = optim.tree_map(lambda t: t * 5.0, {
        "mpd": disc.init_mpd(mpd_cfg, seed=1, device="cpu"),
        "msd": disc.init_msd(msd_cfg, seed=2, device="cpu")})
    gp = vocos.init_decoder(vcfg, seed=0, device="cpu")
    return vcfg, mpd_cfg, msd_cfg, dp, gp


def run_gan(inputs, rank, world, out):
    vcfg, mpd_cfg, msd_cfg, dp, gp = gan_setup()
    cfg = CodecTrainingConfig(generator_lr=GAN_LRS[0], discriminator_lr=GAN_LRS[1])
    txs = list(gan.create_gan_optimizers(cfg))
    for tx in txs:
        tx.eps = GAN_EPS
    gt, gf = gan.split_generator_params(gp)
    mesh = pmesh.build_mesh((world, 1, 1), "dp")
    step = gan.make_gan_step(vcfg, mpd_cfg, msd_cfg, cfg, gf, *txs, mesh=mesh)
    b = len(inputs["gan/wav"]) // world  # rank r holds rows [r b, (r + 1) b)
    rows = slice(rank * b, (rank + 1) * b)
    batch = {k: torch.from_numpy(inputs[f"gan/{k}"][rows]) for k in ("audio_codes", "wav")}
    collectives.reset_counts()
    gt, dp, _, _, m = step(gt, dp, txs[0].init(gt), txs[1].init(dp), batch)
    out["gan/calls"] = np.array(collectives.all_reduce_sum.calls)
    out["gan/metrics"] = np.array([float(x) for x in m])
    out.update(flat_np(gt, "gan/gen"))
    for side in ("mpd", "msd"):  # conv kernels in JAX's HWIO layout
        out.update({k: (v.transpose(2, 3, 1, 0) if v.ndim == 4 else v)
                    for k, v in flat_np(dp[side], f"gan/disc/{side}").items()})


def run_sources(rank, out):
    """Rank 0 sees source a, rank 1 sources a and b; no rank sees c."""
    stats = Statistics()
    stats.record_loss("total", rank + 1.0)
    for s in ("a",) if rank == 0 else ("a", "b"):
        stats.record_loss(s, 2.0 + rank)
    got = stats.logging_stats(make_process_sum(), ("a", "b", "c"))
    out["sources/train"] = np.array(
        [got[k] for k in ("loss/total", "loss/a", "loss/b", "loss_count/a", "loss_count/b")]
        + [any(k.endswith("/c") for k in got)])
    batch = {"input_ids": np.zeros((2, 4)), "source": ["a", "a"] if rank == 0 else ["b", "c"]}
    val = evaluation.compute_metrics(lambda p, b: (torch.tensor(1.0 + rank), None), None,
                                     [batch], lambda b: b, reduce_fn=make_process_sum(),
                                     sources=("a", "b", "c"))
    out["sources/val"] = np.array([val[f"val_loss/{k}"] for k in ("total", "a", "b", "c")])


def main(directory: str) -> None:
    torch.set_num_threads(1)
    env = pmesh.initialize_distributed("cpu")
    rank, world = env.global_rank, env.world_size
    inputs = dict(np.load(os.path.join(directory, "inputs.npz")))
    out = {"env": np.array([rank, env.local_rank, world, int(env.is_main)])}
    run_llama("dp", (world, 1, 1), "dp", inputs, rank, out, accum=1, chunk=0, remat=False)
    run_llama("fsdp", (1, world, 1), "fsdp", inputs, rank, out, accum=2, chunk=16, remat=True)
    run_gan(inputs, rank, world, out)
    out["sum"] = make_process_sum()(np.array([rank + 1.0, 10.0 * (rank + 1)]))
    run_sources(rank, out)
    collectives.reset_counts()
    multihost.barrier()
    out["barriers"] = np.array(collectives.barrier.calls)
    res = gan_loop.main(["--config_path", os.path.join(directory, "gan_loop.json"), "--tiny",
                         "--device", "cpu", "--total_steps", "2"])
    out["loop/losses"] = np.array([[v[k] for k in sorted(v)] for _, v, _ in res.steps])
    out.update(flat_np(res.gen_trainable, "loop/gen"))
    out.update(flat_np(res.disc_params, "loop/disc"))
    np.savez(os.path.join(directory, f"out_{rank}.npz"), **out)
    pmesh.destroy_distributed(env)


if __name__ == "__main__":
    main(sys.argv[1])
