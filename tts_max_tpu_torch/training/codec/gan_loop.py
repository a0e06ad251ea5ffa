"""Codec GAN training loop and entry point (counterpart of
``tts_max_tpu/training/codec/gan_loop.py``).

    python -m tts_max_tpu_torch.training.codec.gan_loop --config_path cfg.json \\
        [--dataset_dir ds] [--decoder_checkpoint ckpt] [--total_steps N] \\
        [--dry_run] [--tiny] [--device cuda|cpu]

The generator starts from ``--decoder_checkpoint`` (a torch xcodec2
checkpoint, read by ``api.create_decoder``) or from seeded random weights;
the discriminators from ``init_mpd``/``init_msd`` (seeds 1 and 2). The
serving ``model_config.json`` (with the computed token rate) is written
first; there is no eval loop. Every ``save_steps`` a checkpoint (generator
and discriminators, both optimizers, through ``training/checkpointing``)
and the fixed 4-sample validation batch decoded, generated and true wavs
under ``quality/step_<n>/``. Each step's losses are read to the host after
the step, in one read. It runs on the card unless ``--device cpu``.

Under a launcher (``torchrun --nproc_per_node N -m
tts_max_tpu_torch.training.codec.gan_loop ...``; world size 1 included) it
trains data-parallel over ``torch.distributed``: ``batch_size`` is the
global batch, each rank loads its rows, and the step averages both sides'
grads over the ranks (``gan.make_gan_step(mesh=...)``). Rank 0 writes
``model_config.json``, the checkpoints and the validation wavs. (The JAX
loop builds its step without the mesh, so its ranks would step apart.)
"""

from __future__ import annotations

import argparse
import os
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from tts_max_tpu_torch.core.config import ExperimentConfig
from tts_max_tpu_torch.data.audio_io import save_wav
from tts_max_tpu_torch.data.loader import DataLoader
from tts_max_tpu_torch.device import full_fp32, resolve_device, to_device_async
from tts_max_tpu_torch.models.codec import api, discriminator as disc, vocos
from tts_max_tpu_torch.parallel import mesh as pmesh
from tts_max_tpu_torch.parallel.multihost import barrier
from tts_max_tpu_torch.training.checkpointing import CheckpointManager, save_config
from tts_max_tpu_torch.training.codec import gan
from tts_max_tpu_torch.training.codec.codec_data import CodecTrainingDataset, codec_collate
from tts_max_tpu_torch.utils.logging import get_logger, setup_logging
from tts_max_tpu_torch.utils.statistics import Statistics, Timer

log = get_logger(__name__)


class GanResult(NamedTuple):
    """Every step's (step, {gen, disc, mel, adv, fm, rms} losses, host
    seconds from fetching its batch to reading its losses), the seconds of
    each checkpoint save and of each save with its validation, the final
    params, and the frozen generator params (the FSQ quantizer) the steps
    ran with."""

    steps: list
    checkpoint_seconds: list
    save_seconds: list
    gen_trainable: dict
    disc_params: dict
    gen_frozen: dict


def to_device(batch: dict, device: torch.device) -> dict:
    """The step's inputs on ``device`` (no host sync)."""
    return {k: to_device_async(torch.from_numpy(np.ascontiguousarray(batch[k])), device)
            for k in ("audio_codes", "wav")}


class FixedBatchCodecValidator:
    """Decode the same fixed batch at every save; write the generated and
    the true wavs."""

    def __init__(self, batch: dict, vocos_cfg, gen_frozen, output_dir: str, sample_rate: int,
                 device):
        self._batch = batch
        self._codes = to_device(batch, device)["audio_codes"]
        self._cfg = vocos_cfg
        self._frozen = gen_frozen
        self._dir = output_dir
        self._sr = sample_rate

    @torch.no_grad()
    def validate(self, gen_trainable, step: int) -> list[str]:
        params = gan.merge_generator_params(gen_trainable, self._frozen)
        wavs = vocos.decode(params, self._codes, self._cfg).cpu().numpy()
        out = os.path.join(self._dir, f"step_{step}")
        os.makedirs(out, exist_ok=True)
        paths = []
        for i, w in enumerate(wavs):
            paths += [os.path.join(out, f"generated_{i}.wav"), os.path.join(out, f"true_{i}.wav")]
            save_wav(paths[-2], w, self._sr)
            save_wav(paths[-1], self._batch["wav"][i], self._sr)
        return paths


def run_training(config: ExperimentConfig, args) -> GanResult | None:
    env = pmesh.initialize_distributed(args.device)
    try:
        return _train(config, args, env)
    finally:
        pmesh.destroy_distributed(env)


def _train(config: ExperimentConfig, args, env) -> GanResult | None:
    setup_logging(env.global_rank)
    device = resolve_device(args.device)
    mesh = None
    if dist.is_initialized():
        shape = pmesh.mesh_for_strategy("dp", env.world_size)
        mesh = pmesh.build_mesh(shape, "dp")
    full_fp32()  # the codec trains in fp32, TF32 off
    ccfg = config.codec
    vocos_cfg = (vocos.tiny_vocos_config() if args.tiny else vocos.VocosConfig(
        upsample_factors=ccfg.upsample_factors or (),
        upsample_kernel_sizes=ccfg.upsample_kernel_sizes or ()))
    mpd_cfg = disc.tiny_mpd_config() if args.tiny else disc.MPDConfig()
    msd_cfg = disc.tiny_msd_config() if args.tiny else disc.MSDConfig()

    if args.decoder_checkpoint:
        gen_params = api.create_decoder(args.decoder_checkpoint, device=device)._params
    else:
        gen_params = vocos.init_decoder(vocos_cfg, seed=config.training.seed, device=device)
        log.warning("No decoder checkpoint: training from random init.")
    gen_trainable, gen_frozen = gan.split_generator_params(gen_params)
    disc_params = {"mpd": disc.init_mpd(mpd_cfg, seed=1, device=device),
                   "msd": disc.init_msd(msd_cfg, seed=2, device=device)}

    gen_tx, disc_tx = gan.create_gan_optimizers(ccfg, config.training.betas,
                                                config.training.weight_decay)
    gen_opt, disc_opt = gen_tx.init(gen_trainable), disc_tx.init(disc_params)
    step_fn = gan.make_gan_step(vocos_cfg, mpd_cfg, msd_cfg, ccfg, gen_frozen, gen_tx, disc_tx,
                                mesh=mesh)

    datasets = list(config.train_weighted_datasets) or [args.dataset_dir]
    ds = CodecTrainingDataset(datasets[0], "train", ccfg.code_window_size, vocos_cfg.hop_length,
                              ccfg.sample_rate, config.dataset.min_sample_rate,
                              seed=config.training.seed)
    loader = DataLoader(ds, config.training.batch_size, codec_collate,
                        seed=config.training.seed,
                        process_index=mesh.index(pmesh.BATCH) if mesh else 0,
                        process_count=mesh.size(pmesh.BATCH) if mesh else 1)

    os.makedirs(config.output_dir, exist_ok=True)
    if env.is_main:
        save_config(config.output_dir, config)
        ups = int(np.prod(ccfg.upsample_factors)) if ccfg.upsample_factors else 1
        api.DecoderConfig(
            sample_rate=ccfg.sample_rate,
            token_rate=ccfg.sample_rate // (vocos_cfg.hop_length * ups),
            hop_length=vocos_cfg.hop_length,
            upsample_factors=ccfg.upsample_factors,
            kernel_sizes=ccfg.upsample_kernel_sizes,
        ).to_json(os.path.join(config.output_dir, "model_config.json"))

    val_batch = codec_collate([ds[i] for i in range(min(4, len(ds)))])
    validator = FixedBatchCodecValidator(val_batch, vocos_cfg, gen_frozen,
                                         os.path.join(config.output_dir, "quality"),
                                         ccfg.sample_rate, device)
    mgr = CheckpointManager(os.path.join(config.output_dir, "checkpoints"),
                            keep_last_n=config.checkpointing.keep_only_last_n_checkpoints,
                            is_main=env.is_main)

    stats = Statistics()
    save_steps = config.checkpointing.save_steps
    if args.dry_run:
        m = step_fn(gen_trainable, disc_params, gen_opt, disc_opt,
                    to_device(next(iter(loader)), device))[-1]
        log.info("Dry run: disc %.4f gen %.4f mel %.4f", float(m.disc_loss),
                 float(m.gen_loss), float(m.mel_loss))
        return None

    steps, save_seconds = [], []
    epoch = 0
    iterator = iter(loader.batches(epoch))
    while stats.step < args.total_steps:
        t0 = time.perf_counter()
        try:
            batch = next(iterator)
        except StopIteration:
            epoch += 1
            iterator = iter(loader.batches(epoch))
            batch = next(iterator)
        gen_trainable, disc_params, gen_opt, disc_opt, m = step_fn(
            gen_trainable, disc_params, gen_opt, disc_opt, to_device(batch, device))
        stats.step += 1
        values = dict(zip(("disc", "gen", "adv", "fm", "mel", "rms"),
                          torch.stack(list(m)).tolist()))  # one read, after the step
        for name in ("gen", "disc", "mel"):
            stats.record_loss(name, values[name])
        seconds = time.perf_counter() - t0
        stats.record_step_time(seconds)
        steps.append((stats.step, values, seconds))
        if stats.step % config.training.logging_steps == 0:
            log.info("GAN step %d: %s", stats.step, stats.logging_stats())
            stats.reset_window()
        if save_steps > 0 and stats.step % save_steps == 0:
            with Timer() as t:
                mgr.save(stats.step, {"gen": gen_trainable, "disc": disc_params},
                         {"gen": gen_opt, "disc": disc_opt}, stats, config)
                if env.is_main:
                    validator.validate(gen_trainable, stats.step)
                barrier()
            save_seconds.append(t.elapsed)
            log.info("Step %d: checkpoint + validation %.2fs", stats.step, t.elapsed)
    mgr.wait()
    mgr.close()
    log.info("GAN training done at step %d", stats.step)
    return GanResult(steps, list(mgr.save_seconds), save_seconds, gen_trainable, disc_params,
                     gen_frozen)


def main(argv=None) -> GanResult | None:
    parser = argparse.ArgumentParser(description="Codec GAN training")
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--dataset_dir", default="")
    parser.add_argument("--decoder_checkpoint", default="")
    parser.add_argument("--total_steps", type=int, default=1000)
    parser.add_argument("--dry_run", action="store_true")
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain PyTorch path)")
    args = parser.parse_args(argv)
    config = ExperimentConfig.from_json(args.config_path, required=False)
    return run_training(config, args)


if __name__ == "__main__":
    main()
