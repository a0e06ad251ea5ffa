"""SFT / pretraining entry point (counterpart of ``tts_max_tpu/training/main.py``).

    python -m tts_max_tpu_torch.training.main --config_path cfg.json \\
        [--dry_run] [--pretraining_mode] [--total_steps N] [--device cuda|cpu]

config -> tokenizer and weights (an HF directory's, or the byte tokenizer and
seeded weights of an architecture) -> weighted datasets and loaders -> steps
math -> cosine schedule and AdamW -> optional dry-run step -> loop (eval,
checkpoints with quality validation, resume) -> final model. It runs on the
card unless ``--device cpu`` is given.

Under a launcher it trains over ``torch.distributed``, one process a card
(NCCL; gloo with ``--device cpu``), world size 1 included:

    torchrun --nproc_per_node N -m tts_max_tpu_torch.training.main --config_path cfg.json

(under SLURM, ``srun`` with ``MASTER_ADDR``/``MASTER_PORT`` exported). As in
the JAX package the mesh comes from ``training.strategy`` and the world
size (``parallel/mesh.mesh_for_strategy``; ``training.mesh`` is not read):
``dp``/``ddp`` replicate the params, ``fsdp``/``deepspeed`` shard them and
Adam's moments, ``tp`` splits them over ``tensor`` (``(1, 1, n)``) and
``fsdp_tp`` over both (``(-1, n/2, 2)``); ``batch_size`` is the global
batch, which must divide by data x fsdp; each rank loads its rows, which
its tensor peers share. Rank 0 writes the config, the checkpoints, the
metrics and the final model; a checkpoint holds whole leaves, so a run
resumes under any strategy and world size.

Quality validation (``checkpointing.validation_type`` "random_phrases" or
"prompt_continuation", with ``--codec_decoder_checkpoint`` and
``--codec_encoder_checkpoint``) synthesizes through a ``LocalTtsModel`` on
the training params after each checkpoint (``inference/quality.py``);
``--validation_prompt_wavs`` takes ``wav_path:transcript`` pairs.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import math
import os
import time
from typing import NamedTuple

import torch
import torch.distributed as dist

from tts_max_tpu_torch.core.config import ExperimentConfig
from tts_max_tpu_torch.core.tokenization import build_byte_tokenizer, build_tokenizer
from tts_max_tpu_torch.data import builder
from tts_max_tpu_torch.data.collate import collate
from tts_max_tpu_torch.data.loader import DataLoader
from tts_max_tpu_torch.data.normalization import create as create_normalizer
from tts_max_tpu_torch.device import resolve_device
from tts_max_tpu_torch.models import hf_import, llama
from tts_max_tpu_torch.parallel import mesh as pmesh
from tts_max_tpu_torch.parallel.multihost import barrier
from tts_max_tpu_torch.training import optim, train_step as ts
from tts_max_tpu_torch.training.checkpointing import (
    CheckpointManager,
    save_config,
    save_final_model,
)
from tts_max_tpu_torch.training.loop import run as run_loop
from tts_max_tpu_torch.utils.logging import get_logger, setup_logging
from tts_max_tpu_torch.utils.metrics_logging import MetricsLogger

log = get_logger(__name__)


class TrainResult(NamedTuple):
    """What ``run_training`` did: every step's metrics, seconds (host clock
    around the step, which ends reading its loss from the device) and
    padded batch tokens, the statistics, and the seconds of each checkpoint
    save and of the final model's."""

    steps: list  # (step, StepMetrics, seconds, padded tokens)
    statistics: object
    checkpoint_seconds: list
    final_model_seconds: float


def build_model_and_tokenizer(config: ExperimentConfig, device="cuda"):
    """Tokenizer, fp32 params on ``device`` and model config.

    A local HF directory as ``model_name`` (a Llama 3 checkpoint) gives its
    own tokenizer (``tokenizer.json``, read by the port's
    ``core/hf_tokenizer.py``), extended to ``vocab_size``, and its weights
    with the embedding resized to that tokenizer; otherwise the named
    architecture with the air-gapped byte tokenizer and weights drawn by the
    port's seeded ``init_params`` (torch's generator, so not JAX's numbers)
    is the from-scratch path."""
    mp = config.modeling.parameters
    if os.path.isdir(mp.model_name):
        tokenizer = build_tokenizer(mp.model_name, mp.max_seq_len, mp.codebook_size,
                                    expected_vocab_size=mp.vocab_size)
        params, cfg = hf_import.load_model_from_hf_dir(
            mp.model_name, vocab_size=len(tokenizer), device=device, dtype=torch.float32)
        # fp32 weights, as JAX's import reads them; the config's compute dtype
        cfg = dataclasses.replace(cfg, dtype=hf_import.config_from_hf(mp.model_name).dtype)
        return tokenizer, params, cfg
    arch = mp.architecture or "llama-tiny"
    tokenizer = build_byte_tokenizer(mp.codebook_size)
    cfg = llama.config_for_architecture(
        arch, vocab_size=mp.vocab_size or len(tokenizer), max_seq_len=mp.max_seq_len)
    params = llama.init_params(dataclasses.replace(cfg, dtype=torch.float32),
                               seed=config.training.seed, device=device)
    return tokenizer, params, cfg


def world_size_to_come() -> int:
    """The world size of the group this process is in or will join."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    launcher = pmesh.launcher_env()
    return launcher.world_size if launcher else 1


def check_mesh(config: ExperimentConfig, world: int) -> tuple[int, int, int]:
    """The strategy's mesh over ``world`` ranks, refused before any
    rendezvous where it cannot run: JAX's shape errors, or a global batch
    that data x fsdp does not divide."""
    shape = pmesh.mesh_for_strategy(config.training.strategy, world)
    if config.training.batch_size % (shape[0] * shape[1]):
        raise ValueError(
            f"batch_size {config.training.batch_size} must be divisible by the "
            f"data-parallel extent data*fsdp = {shape[0] * shape[1]} of the {shape} mesh")
    return shape


class _FullParamsValidator:
    """A quality validator handed the full params gathered from the ranks'
    shards (every rank takes part in the gather)."""

    def __init__(self, validator, layout):
        self._validator, self._layout = validator, layout

    def validate(self, params, step: int):
        return self._validator.validate(self._layout.gather(params), step)


def build_quality_validator(config: ExperimentConfig, args, params, model_cfg, tokenizer,
                            device, env=pmesh.EnvironmentContext(), layout=None):
    """The checkpoint-time validator of ``checkpointing.validation_type``, as
    the JAX trainer wires it: the codec decoder and (prompt-caching) encoder
    of ``--codec_*_checkpoint``, a ``LocalTtsModel`` on the training params
    (the validator points it at the latest ones at each checkpoint), and
    ``--validation_prompt_wavs`` as ``wav_path:transcript`` pairs. None
    without a validation type or a decoder checkpoint. With a ``layout``
    the params are this rank's shards: the model and each validation get
    them gathered."""
    vtype = config.checkpointing.validation_type
    if not (vtype and vtype != "none" and args.codec_decoder_checkpoint):
        return None
    from tts_max_tpu_torch.core.tokenization import speech_vocab
    from tts_max_tpu_torch.inference import quality
    from tts_max_tpu_torch.inference.synthesize import LocalTtsModel
    from tts_max_tpu_torch.models.codec import api

    decoder = api.create_decoder(args.codec_decoder_checkpoint, device=device)
    encoder = api.CachingAudioEncoder(
        api.create_encoder(args.codec_encoder_checkpoint, device=device))
    tts_model = LocalTtsModel(layout.gather(params) if layout else params, model_cfg,
                              tokenizer, speech_vocab(tokenizer), encoder, decoder,
                              device=device)
    prompt_wavs = dict(p.split(":", 1) for p in args.validation_prompt_wavs)
    validator = quality.create(vtype, tts_model, config.output_dir, env.global_rank,
                               env.world_size, prompt_wavs=prompt_wavs,
                               prompt_wav_paths=list(prompt_wavs))
    return _FullParamsValidator(validator, layout) if layout else validator


def run_training(config: ExperimentConfig, args) -> TrainResult | None:
    shape = check_mesh(config, world_size_to_come())
    env = pmesh.initialize_distributed(args.device)
    try:
        return _train(config, args, env, shape)
    finally:
        pmesh.destroy_distributed(env)


def _train(config: ExperimentConfig, args, env, shape) -> TrainResult | None:
    setup_logging(env.global_rank)
    device = resolve_device(args.device)
    mesh = (pmesh.build_mesh(shape, config.training.strategy)
            if dist.is_initialized() else None)
    log.info("Mesh (data, fsdp, tensor): %s, %s", shape,
             f"rank {env.global_rank} of {env.world_size}" if mesh else "one process")

    tokenizer, params, model_cfg = build_model_and_tokenizer(config, device)
    log.info("Model: %s params, vocab %d, device %s", llama.param_count(params),
             model_cfg.vocab_size, device)

    tcfg = config.training
    if tcfg.precision == "bf16":
        params = optim.tree_map(
            lambda x: x.to(torch.bfloat16) if x.is_floating_point() else x, params)
    if tcfg.gradient_checkpointing:
        model_cfg = dataclasses.replace(
            model_cfg, remat=True,
            remat_policy="dots" if tcfg.remat_policy == "dots" else None)

    normalizer = create_normalizer(config.modeling.parameters.enable_text_normalization)
    mp = config.modeling.parameters
    train_ds = builder.merge_datasets(
        tokenizer, config.train_weighted_datasets, mp.max_seq_len, "train",
        args.pretraining_mode, normalizer, config.dataset)
    val_ds = (builder.merge_datasets(
        tokenizer, config.val_weighted_datasets, mp.max_seq_len, "val",
        args.pretraining_mode, normalizer, config.dataset)
        if config.val_weighted_datasets else None)

    collate_fn = functools.partial(collate, pad_token_id=tokenizer.pad_token_id,
                                   max_seq_len=mp.max_seq_len)
    mk_loader = functools.partial(
        DataLoader, collate_fn=collate_fn, seed=tcfg.seed,
        process_index=mesh.index(pmesh.BATCH) if mesh else 0,
        process_count=mesh.size(pmesh.BATCH) if mesh else 1)
    train_loader = mk_loader(train_ds, tcfg.batch_size)
    val_loader = mk_loader(val_ds, tcfg.batch_size, shuffle=False) if val_ds else None

    steps_per_epoch = max(
        1, len(train_ds) // (tcfg.batch_size * tcfg.gradient_accumulation_steps))
    total_steps = args.total_steps or int(math.ceil(steps_per_epoch * tcfg.num_train_epochs))
    warmup = max(1, int(total_steps * tcfg.warmup_ratio))
    log.info("steps/epoch=%d total=%d warmup=%d", steps_per_epoch, total_steps, warmup)

    schedule = (
        optim.cosine_warmup_schedule(tcfg.learning_rate, warmup, total_steps)
        if tcfg.lr_scheduler == "cosine" and total_steps > warmup
        else optim.constant_schedule(tcfg.learning_rate))
    tx = optim.create_optimizer(schedule, tcfg.betas, tcfg.weight_decay,
                                mu_dtype=tcfg.adam_mu_dtype)
    layout = None
    if mesh is None:
        step_fn = functools.partial(ts.train_step, cfg=model_cfg, tx=tx,
                                    gradient_clip_value=tcfg.gradient_clip_value,
                                    loss_chunk_size=tcfg.loss_chunk_size)
        eval_fn = functools.partial(ts.eval_step, cfg=model_cfg,
                                    loss_chunk_size=tcfg.loss_chunk_size)
    else:
        step_fn = ts.make_train_step(mesh, model_cfg, tx, params, tcfg.gradient_clip_value,
                                     tcfg.loss_chunk_size)
        eval_fn, layout = step_fn.eval_step, step_fn.layout
        params = layout.shard(params)  # this rank's shards from here on
    opt_state = tx.init(params)

    if args.dry_run:
        micro = next(iter(train_loader))
        macro = {"input_ids": micro["input_ids"][None], "labels": micro["labels"][None]}
        _, _, m = step_fn(params, opt_state, macro)
        log.info("Dry run loss: %.4f", m.loss)
        return None

    os.makedirs(config.output_dir, exist_ok=True)
    if env.is_main:
        save_config(config.output_dir, config)
    mgr = CheckpointManager(os.path.join(config.output_dir, "checkpoints"),
                            keep_last_n=config.checkpointing.keep_only_last_n_checkpoints,
                            layout=layout, is_main=env.is_main)

    statistics = None
    resume = config.checkpointing.checkpoint_file_to_resume_from
    if resume or mgr.latest_step() is not None:
        try:
            params, opt_state, statistics = mgr.restore(
                None, params, opt_state,
                weights_only=config.checkpointing.only_load_model_weights)
            log.info("Resumed from step %s", statistics.step if statistics else 0)
        except FileNotFoundError:
            pass

    quality_validator = build_quality_validator(config, args, params, model_cfg, tokenizer,
                                                device, env, layout)

    history = []

    def timed_step(p, o, macro):
        t0 = time.perf_counter()
        p, o, m = step_fn(p, o, macro)  # ends reading the loss from the device
        history.append((m, time.perf_counter() - t0, int(macro["input_ids"].size)))
        return p, o, m

    metrics_logger = MetricsLogger(config.output_dir, experiment_name=config.experiment_name,
                                   use_wandb=args.use_wandb, is_main=env.is_main)
    start = statistics.step if statistics else 0
    params, opt_state, stats = run_loop(
        train_step=timed_step, eval_step=eval_fn, params=params, opt_state=opt_state,
        train_loader=train_loader, val_loader=val_loader, config=config,
        total_training_steps=total_steps, steps_per_epoch=steps_per_epoch,
        checkpoint_manager=mgr, quality_validator=quality_validator, lr_schedule=schedule,
        statistics=statistics, metrics_logger=metrics_logger, layout=layout)
    metrics_logger.close()
    mgr.wait()
    t0 = time.perf_counter()
    if layout is not None:  # every rank gathers, rank 0 keeps and writes
        params = layout.gather(params, to_cpu=True, keep=env.is_main)
    path = save_final_model(config.output_dir, params) if env.is_main else None
    barrier()
    final_s = time.perf_counter() - t0
    log.info("Final model saved to %s in %.2f s", path, final_s)
    mgr.close()
    steps = [(start + i + 1, *h) for i, h in enumerate(history)]
    return TrainResult(steps, stats, list(mgr.save_seconds), final_s)


def main(argv=None) -> TrainResult | None:
    parser = argparse.ArgumentParser(description="SpeechLM SFT/pretraining")
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--dry_run", action="store_true")
    parser.add_argument("--pretraining_mode", action="store_true")
    parser.add_argument("--total_steps", type=int, default=0)
    parser.add_argument("--use_wandb", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain PyTorch path)")
    parser.add_argument("--codec_encoder_checkpoint", default="",
                        help="xcodec2 torch checkpoint of the codec encoder (with its "
                             "w2v-bert weights) for quality validation")
    parser.add_argument("--codec_decoder_checkpoint", default="",
                        help="xcodec2 torch checkpoint of the codec decoder; quality "
                             "validation runs only with one")
    parser.add_argument("--validation_prompt_wavs", nargs="*", default=[],
                        help="wav_path:transcript pairs for random-phrases validation")
    args = parser.parse_args(argv)
    config = ExperimentConfig.from_json(args.config_path)
    return run_training(config, args)


if __name__ == "__main__":
    main()
