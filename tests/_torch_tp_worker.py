"""One rank of the port's tensor-parallel and RLHF-topology checks over
gloo, for ``tests/test_torch_tensor_parallel.py`` (two ranks, ``tp``) and
``tests/test_torch_topology.py`` (four ranks, ``topology``). It imports
torch and the port only.

    RANK=r WORLD_SIZE=n MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/_torch_tp_worker.py tp|topology <dir>

It joins the group through ``parallel.mesh.initialize_distributed("cpu")``,
reads ``<dir>/inputs.npz`` (weights by path under a prefix a model, token
ids, batches) and writes ``<dir>/out_<r>.npz``.

``tp`` on ``(1, 1, 2)``:

- ``gen/*``: greedy ``generate`` with this rank's blocks and ``mesh=``;
- ``eng/<kind>/*``: the contiguous, int8-KV and paged engines with
  ``mesh=`` (``steps_per_dispatch`` 4): each request's ids and finish
  reason; ``same/*``: the paged engine with the prefix cache and
  prefill-ahead, and a cancel, beside the same engine without a mesh on
  this rank (1 where the ids are equal);
- ``kv1/*``: generate and the contiguous engine where ``n_kv_heads`` 1 does
  not divide by 2 (the attention runs whole);
- ``train/*``: two steps of the ``tp`` train step (two micro-steps, the
  chunked loss, remat): metrics, this rank's blocks of the params and of
  Adam's moments, the gathered params, the collectives of the second step
  and the norms' grads of one backward;
- ``gan/*``: one GAN step on the tensor mesh, this rank holding every row.

``topology`` over four ranks:

- ``topo/*``: ``TrainerSamplerTopology.create(2)``: each side's ranks and
  mesh, then the trainer's shards and, on a sampler rank, the pushed
  blocks;
- ``grpo/<how>/*``: two GRPO steps through the engine and through
  ``generate``: each step's stats and the rollout ids;
- ``fsdp_tp/*``: two ``fsdp_tp`` train steps on ``(1, 2, 2)``: metrics and
  the gathered params;
- one step of ``training.rlhf.main --sampler_devices 2`` in the group.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from _torch_dist_worker import GAN_EPS, GAN_LRS, flat_np, gan_setup, unflatten
from tts_max_tpu_torch import convert
from tts_max_tpu_torch.core import tokenization
from tts_max_tpu_torch.core.config import CodecTrainingConfig, RLHFConfig
from tts_max_tpu_torch.data.samples import Sample
from tts_max_tpu_torch.inference.engine import InferenceEngine, PagedInferenceEngine
from tts_max_tpu_torch.inference.generate import generate
from tts_max_tpu_torch.models import llama
from tts_max_tpu_torch.ops.sampling import SamplingParams
from tts_max_tpu_torch.parallel import collectives, mesh as pmesh
from tts_max_tpu_torch.parallel.sharding import ShardLayout
from tts_max_tpu_torch.training import optim, train_step as ts
from tts_max_tpu_torch.training.codec import gan
from tts_max_tpu_torch.training.rlhf import grpo
from tts_max_tpu_torch.training.rlhf.dataset import TtsRLHFDataset
from tts_max_tpu_torch.training.rlhf.topology import TrainerSamplerTopology

GREEDY = SamplingParams(temperature=0.0, repetition_penalty=1.0, frequency_penalty=0.0)
PROMPTS = [np.array([5, 9, 42], np.int32), np.arange(3, 70, dtype=np.int32),
           np.array([7, 8], np.int32)]


def tiny(vocab, max_seq, **over):
    return dataclasses.replace(llama.tiny_config(vocab_size=vocab, max_seq_len=max_seq),
                               dtype=torch.float32, **over)


def weights(inputs, prefix, cfg):
    flat = {k[len(prefix) + 1:]: v for k, v in inputs.items() if k.startswith(prefix + "/")}
    return convert.llama_from_numpy(unflatten(flat), cfg, device="cpu")


def completions(done):
    return ([c.tokens for c in done], [c.finish_reason == "eos" for c in done])


def engine_kinds():
    return {"contiguous": (InferenceEngine, {}),
            "int8": (InferenceEngine, {"quantized_kv": True}),
            "paged": (PagedInferenceEngine, {"block_size": 32})}


def run_serving(inputs, out):
    mesh = pmesh.build_mesh((1, 1, 2), "tp")
    cfg = tiny(512, 128)
    full = weights(inputs, "w_serve", cfg)
    local = ShardLayout(full, mesh).shard(full)
    res = generate(local, cfg, torch.from_numpy(inputs["gen/toks"]),
                   torch.from_numpy(inputs["gen/lens"]), None, sp=GREEDY, max_new_tokens=8,
                   eos_id=-1, cache_len=64, device="cpu", mesh=mesh)
    out["gen/tokens"] = res.tokens.numpy()
    for kind, (cls, kw) in engine_kinds().items():
        eng = cls(local, cfg, max_batch=2, max_len=128, sp=GREEDY, steps_per_dispatch=4,
                  device="cpu", mesh=mesh, **kw)
        toks, eos = completions(eng.generate_all(PROMPTS, max_new_tokens=8, eos_id=-1))
        for i, t in enumerate(toks):
            out[f"eng/{kind}/{i}"] = t
        out[f"eng/{kind}/eos"] = np.array(eos)
        out[f"eng/{kind}/kv_heads"] = np.array(
            (eng.cache["k"]["q"] if kw.get("quantized_kv") else eng.cache["k"]).shape[3])
    # the prefix cache, prefill-ahead and a cancel under the mesh, beside the
    # same engine without it (every rank runs both)
    shared = np.arange(3, 70, dtype=np.int32)
    prompts = [shared, np.array([4, 4, 4], np.int32), np.array([6, 5], np.int32),
               np.concatenate([shared, [8]]), np.array([3, 9], np.int32)]
    for m, params in ((None, full), (mesh, local)):
        eng = PagedInferenceEngine(params, cfg, block_size=32, max_batch=2, max_len=128,
                                   sp=GREEDY, steps_per_dispatch=4, device="cpu", mesh=m,
                                   enable_prefix_cache=True, prefill_ahead=True, park_rows=2,
                                   park_len=128)
        ids = [eng.submit(p, 8, eos_id=-1) for p in prompts]
        eng.poll()  # the first two admitted, the third parked
        eng.cancel(ids[2])
        done = {c.request_id: c.tokens for c in eng.run()}
        name = "mesh" if m is not None else "alone"
        for i in ids:
            out[f"same/{name}/{i}"] = done.get(i, np.zeros(0, np.int32))
        st = eng.stats()
        out[f"same/{name}/stats"] = np.array([st["prefix_cache_hits"], st["parked_total"],
                                              len(done)])
    kv1 = tiny(512, 128, n_kv_heads=1)
    full1 = weights(inputs, "w_kv1", kv1)
    local1 = ShardLayout(full1, mesh).shard(full1)
    res = generate(local1, kv1, torch.from_numpy(inputs["gen/toks"]),
                   torch.from_numpy(inputs["gen/lens"]), None, sp=GREEDY, max_new_tokens=8,
                   eos_id=-1, cache_len=64, device="cpu", mesh=mesh)
    out["kv1/gen"] = res.tokens.numpy()
    eng = InferenceEngine(local1, kv1, max_batch=2, max_len=128, sp=GREEDY,
                          steps_per_dispatch=4, device="cpu", mesh=mesh)
    toks, eos = completions(eng.generate_all(PROMPTS, max_new_tokens=8, eos_id=-1))
    for i, t in enumerate(toks):
        out[f"kv1/eng/{i}"] = t
    out["kv1/kv_heads"] = np.array(eng.cache["k"].shape[3])


def run_train(name, shape, strategy, inputs, rank, out, steps):
    """``steps`` steps of the mesh's train step on the global batch (each
    batch rank its rows)."""
    cfg = tiny(128, 64, remat=True)
    params = weights(inputs, "w_train", cfg)
    tx = optim.create_optimizer(optim.cosine_warmup_schedule(1e-3, 1, 10))
    mesh = pmesh.build_mesh(shape, strategy)
    step = ts.make_train_step(mesh, cfg, tx, params, 1.0, 16)
    p, o = step.shard(params, tx.init(params))
    nb, i = mesh.size(pmesh.BATCH), mesh.index(pmesh.BATCH)
    for k in range(1, steps + 1):
        batch = {f: inputs[f"train/s{k}/{f}"] for f in ("input_ids", "labels")}
        rows = batch["input_ids"].shape[1] // nb
        collectives.reset_counts()
        p, o, m = step(p, o, {f: v[:, i * rows:(i + 1) * rows] for f, v in batch.items()})
        out[f"{name}/s{k}/metrics"] = np.array([m.loss, m.grad_norm, m.nonfinite, m.tokens])
    out[f"{name}/calls"] = np.array(list(collectives.counts().values())
                                    + list(collectives.counts_tp().values()))
    out.update(flat_np(p, f"{name}/local/params"))
    out.update(flat_np(o["mu"], f"{name}/local/mu"))
    out.update(flat_np(o["nu"], f"{name}/local/nu"))
    out.update(flat_np(step.layout.gather(p), f"{name}/params"))
    return step, p


def norm_grads(step, params, inputs, out):
    """The norms' grads of one backward of this rank's batch."""
    batch = ts.to_device_batch({f: inputs[f"train/s1/{f}"][0] for f in ("input_ids",
                                                                         "labels")}, "cpu")
    grads, _ = step.reduced_grads(params, [lambda live: ts.nll_sum(
        live, step.cfg, batch, step.chunk, step._gather_layer, step.tp)])
    for path, g in optim.tree_items(grads):
        if path.endswith("norm/scale"):
            out[f"train/norm_grad/{path}"] = g.numpy()


def run_gan(inputs, out):
    vcfg, mpd_cfg, msd_cfg, dp, gp = gan_setup()
    cfg = CodecTrainingConfig(generator_lr=GAN_LRS[0], discriminator_lr=GAN_LRS[1])
    txs = list(gan.create_gan_optimizers(cfg))
    for tx in txs:
        tx.eps = GAN_EPS
    gt, gf = gan.split_generator_params(gp)
    mesh = pmesh.build_mesh((1, 1, 2), "tp")
    step = gan.make_gan_step(vcfg, mpd_cfg, msd_cfg, cfg, gf, *txs, mesh=mesh)
    batch = {k: torch.from_numpy(inputs[f"gan/{k}"]) for k in ("audio_codes", "wav")}
    gt, dp, _, _, m = step(gt, dp, txs[0].init(gt), txs[1].init(dp), batch)
    out["gan/metrics"] = np.array([float(x) for x in m])
    out.update(flat_np(gt, "gan/gen"))
    for side in ("mpd", "msd"):  # conv kernels in JAX's HWIO layout
        out.update({k: (v.transpose(2, 3, 1, 0) if v.ndim == 4 else v)
                    for k, v in flat_np(dp[side], f"gan/disc/{side}").items()})


class LenReward:
    __name__ = "len"

    def __call__(self, completions, **kw):
        return [float(len(c)) for c in completions]


def rlhf_setup():
    """The byte tokenizer, its speech vocab, the three-prompt dataset and
    the GRPO config of the JAX package's topology test."""
    tok = tokenization.build_byte_tokenizer()
    sv = tokenization.speech_vocab(tok)
    samples = [Sample.from_json({"wav_path": f"w{i}.wav", "transcript": f"text {i}",
                                 "language": "en", "duration": 1.0, "sample_rate": 16000},
                                "ds") for i in range(3)]
    codes = np.arange(30, dtype=np.int32) % 65536
    ds = TtsRLHFDataset("ds", samples, codes, [(0, 10), (10, 20), (20, 30)], tok)
    cfg = RLHFConfig(num_generations=2, max_completion_length=8, max_prompt_length=64,
                     temperature=0.0, repetition_penalty=1.0, kl_beta=0.04)
    return tok, sv, ds, cfg


def grpo_steps(trainer, ds):
    """Two steps on the test's prompt pairs: [stats row] and rollout ids."""
    keys = ("reward_mean", "completion_len", "loss", "mean_logp", "grad_norm", "step")
    stats, tokens = [], []
    for pair in ([0, 1], [1, 2]):
        s = trainer.train_step([ds[i] for i in pair])
        stats.append([s[k] for k in keys])
        tokens.append(trainer.last_batch.tokens)
    return np.array(stats), np.stack(tokens)


def run_topology(inputs, rank, out):
    topo = TrainerSamplerTopology.create(2)
    out["topo/ranks"] = np.array([topo.trainer_ranks, topo.sampler_ranks])
    mine = topo.trainer_mesh or topo.sampler_mesh
    out["topo/mesh"] = np.array([*mine.shape, *mine.coords, int(topo.is_trainer)])
    cfg = tiny(512, 128)
    full = weights(inputs, "w_serve", cfg)
    shards = topo.shard_for_trainer(full)
    pushed = topo.push_to_sampler(shards)
    out.update(flat_np(shards if topo.is_trainer else pushed, "topo/local"))

    tok, sv, ds, rcfg = rlhf_setup()
    pcfg = tiny(len(tok), 512)
    for how in ("engine", "generate"):
        trainer = grpo.GRPOTrainer(weights(inputs, "w_grpo", pcfg), pcfg, tok, sv, [LenReward()],
                                   rcfg, learning_rate=1e-4,
                                   topology=TrainerSamplerTopology.create(2),
                                   rollout_via_engine=how == "engine", engine_max_batch=4)
        out[f"grpo/{how}/stats"], out[f"grpo/{how}/tokens"] = grpo_steps(trainer, ds)
        if trainer._engine is not None:
            out[f"grpo/{how}/engine_kv_heads"] = np.array(trainer._engine.cache["k"].shape[3])


def main(mode: str, directory: str) -> None:
    torch.set_num_threads(1)
    env = pmesh.initialize_distributed("cpu")
    rank = env.global_rank
    inputs = dict(np.load(os.path.join(directory, "inputs.npz")))
    out = {}
    if mode == "tp":
        run_serving(inputs, out)
        step, p = run_train("train", (1, 1, 2), "tp", inputs, rank, out, steps=2)
        norm_grads(step, p, inputs, out)
        run_gan(inputs, out)
    else:
        run_topology(inputs, rank, out)
        run_train("fsdp_tp", (1, 2, 2), "fsdp_tp", inputs, rank, out, steps=2)
        from tts_max_tpu_torch.training.rlhf import main as rlhf_main

        res = rlhf_main.main(["--config_path", os.path.join(directory, "rlhf.json"),
                              "--dataset_dir", os.path.join(directory, "ds"),
                              "--architecture", "llama-tiny", "--device", "cpu",
                              "--total_steps", "1", "--sampler_devices", "2"])
        s = res.steps[0]
        out["main/stats"] = np.array([s["loss"], s["reward_mean"], s["completion_len"],
                                      s["step"]])
        out["main/trains"] = np.array(int(res.trainer.params is not None))
    np.savez(os.path.join(directory, f"out_{rank}.npz"), **out)
    pmesh.destroy_distributed(env)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
