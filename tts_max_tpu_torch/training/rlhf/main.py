"""GRPO RLHF entry point (counterpart of ``tts_max_tpu/training/rlhf/main.py``).

    python -m tts_max_tpu_torch.training.rlhf.main --config_path rlhf.json \\
        --dataset_dir DS [--model_dir HF_DIR | --architecture llama-tiny] \\
        [--codec_decoder CKPT] [--whisper_dir DIR] [--dnsmos_dir DIR] \\
        [--wavlm_dir DIR] [--ecapa_checkpoint PT] [--rollout_via_engine] \\
        [--sampler_devices N] [--total_steps N] [--device cuda|cpu]

Builds the RLHF dataset (this sample's audio prompt and the next sample's
transcript), the reward functions with their backends (Whisper for WER,
DNSMOS over ONNX graphs, WavLM + ECAPA for speaker similarity; each only
when its directory is given, from the flags or ``WHISPER_CHECKPOINT``,
``DNSMOS_ONNX_DIR``, ``WAVLM_CHECKPOINT`` and ``ECAPA_CHECKPOINT``), and runs
GRPO on one device, the card unless ``--device cpu`` is given, with
checkpoints and a metrics log under the config's ``output_dir``.

The policy is an HF directory's (``--model_dir``: its ``tokenizer.json``
extended with the speech vocabulary, fp32 weights under the config's
compute dtype, remat on) or a named architecture's (the byte tokenizer, bf16
weights from the port's seeded ``init_params``, remat on). Without
``--codec_decoder`` the rewards decode with a tiny random Vocos (smoke
mode).

``--sampler_devices N`` splits the ranks of a launcher's group (torchrun,
one process a card; gloo with ``--device cpu``) into RLHF's trainer and
sampler (``topology.TrainerSamplerTopology``): the last N ranks make the
rollouts tensor-parallel, the rest train on an FSDP mesh, and the weights
are pushed between rounds:

    torchrun --nproc_per_node 8 -m tts_max_tpu_torch.training.rlhf.main \\
        --config_path rlhf.json --dataset_dir DS --sampler_devices 4

A world of N ranks or fewer (one process without a launcher included)
raises JAX's ``ValueError``. Rank 0 writes the checkpoints, the config and
the metrics.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import NamedTuple

import numpy as np
import torch

from tts_max_tpu_torch.core.config import ExperimentConfig
from tts_max_tpu_torch.core.tokenization import build_byte_tokenizer, build_tokenizer, speech_vocab
from tts_max_tpu_torch.data import codes_io
from tts_max_tpu_torch.data.normalization import create as create_normalizer
from tts_max_tpu_torch.device import resolve_device
from tts_max_tpu_torch.models import hf_import, llama
from tts_max_tpu_torch.models.codec import api, vocos
from tts_max_tpu_torch.parallel import mesh as pmesh
from tts_max_tpu_torch.training.checkpointing import CheckpointManager, save_config
from tts_max_tpu_torch.training.rlhf.dataset import TtsRLHFDataset
from tts_max_tpu_torch.training.rlhf.grpo import GRPOTrainer
from tts_max_tpu_torch.training.rlhf.rewards import create_reward_funcs
from tts_max_tpu_torch.utils.logging import get_logger, setup_logging
from tts_max_tpu_torch.utils.metrics_logging import MetricsLogger
from tts_max_tpu_torch.utils.statistics import Statistics

log = get_logger(__name__)


class RLHFResult(NamedTuple):
    """What ``run_training`` did: the trainer (params, optimizer state,
    engine), each step's stats, the reward backends by name
    (``transcribe_fn``, ``dnsmos_fn``, ``embed_fn``), the reward functions
    and the seconds of each checkpoint save."""

    trainer: GRPOTrainer
    steps: list
    backends: dict
    reward_funcs: list
    checkpoint_seconds: list


def build_policy(args, config: ExperimentConfig, device):
    """(tokenizer, params, model config) of ``--model_dir`` or
    ``--architecture``."""
    if args.model_dir and os.path.isdir(args.model_dir):
        tokenizer = build_tokenizer(args.model_dir, expected_vocab_size=None)
        # fp32 weights, as JAX's import reads them, under the config's
        # compute dtype; remat, which JAX's HF-dir path does not set: at
        # Llama-3.2-1B, fp32 weights, grads and second moment beside the
        # 8 x 3072 update's saved activations exceed one 80 GB card
        params, model_cfg = hf_import.load_model_from_hf_dir(
            args.model_dir, device=device, dtype=torch.float32)
        model_cfg = dataclasses.replace(
            model_cfg, dtype=hf_import.config_from_hf(args.model_dir).dtype, remat=True)
        return tokenizer, params, model_cfg
    tokenizer = build_byte_tokenizer()
    # bf16 params + remat: the single-device 1B training recipe
    model_cfg = dataclasses.replace(
        llama.config_for_architecture(args.architecture, vocab_size=len(tokenizer)),
        remat=True)
    params = llama.init_params(model_cfg, seed=config.training.seed, device=device)
    return tokenizer, params, model_cfg


def build_backends(args, device) -> dict:
    backends = {}
    if args.whisper_dir and os.path.isdir(args.whisper_dir):
        from tts_max_tpu_torch.training.rlhf.asr import load_transcriber

        backends["transcribe_fn"] = load_transcriber(args.whisper_dir, device=device)
        log.info("WER reward backed by Whisper: %s", args.whisper_dir)
    if args.dnsmos_dir and os.path.isdir(args.dnsmos_dir):
        from tts_max_tpu_torch.training.rlhf.dnsmos import load_dnsmos

        primary = os.path.join(args.dnsmos_dir, "sig_bak_ovr.onnx")
        p808 = os.path.join(args.dnsmos_dir, "model_v8.onnx")
        backends["dnsmos_fn"] = load_dnsmos(
            primary if os.path.exists(primary) else None,
            p808 if os.path.exists(p808) else None,
            device=device,
        )
        log.info("DNSMOS reward backed by onnx_lite: %s", args.dnsmos_dir)
    if args.wavlm_dir and os.path.isdir(args.wavlm_dir):
        from tts_max_tpu_torch.training.rlhf.ecapa import load_wavlm_similarity_embedder

        backends["embed_fn"] = load_wavlm_similarity_embedder(
            args.wavlm_dir, args.ecapa_checkpoint or None, device=device)
        log.info("Similarity reward backed by WavLM+ECAPA: %s", args.wavlm_dir)
    return backends


def run_training(config: ExperimentConfig, args) -> RLHFResult:
    env = (pmesh.initialize_distributed(args.device) if args.sampler_devices > 0
           else pmesh.EnvironmentContext())
    try:
        return _train(config, args, env)
    finally:
        pmesh.destroy_distributed(env)


def _train(config: ExperimentConfig, args, env) -> RLHFResult:
    setup_logging(env.global_rank)
    topology = None
    if args.sampler_devices > 0:
        from tts_max_tpu_torch.training.rlhf.topology import TrainerSamplerTopology

        topology = TrainerSamplerTopology.create(n_sampler=args.sampler_devices)
        log.info("Trainer/sampler topology: trainer ranks %s, sampler ranks %s",
                 topology.trainer_ranks, topology.sampler_ranks)
    device = resolve_device(args.device)
    tokenizer, params, model_cfg = build_policy(args, config, device)
    sv = speech_vocab(tokenizer)
    log.info("Policy: %s params, vocab %d, device %s", llama.param_count(params),
             model_cfg.vocab_size, device)

    # codec decoder for the rewards
    if args.codec_decoder:
        decoder = api.create_decoder(args.codec_decoder, device=device)
    else:
        vcfg = vocos.tiny_vocos_config()
        decoder = api.AudioDecoder(vocos.init_decoder(vcfg, seed=1, device=device), vcfg,
                                   api.DecoderConfig(), device=device)
        log.warning("No codec decoder checkpoint: random decoder (smoke mode).")

    # dataset (audio prompt + next transcript)
    codes, samples, spans, _ = codes_io.load_and_filter_audio_codes_and_samples(
        args.dataset_dir, "train", config.dataset)
    normalizer = create_normalizer(config.modeling.parameters.enable_text_normalization)
    dataset = TtsRLHFDataset(os.path.basename(args.dataset_dir), samples, codes, spans,
                             tokenizer, normalizer)
    log.info("RLHF dataset: %d prompts", len(dataset))

    backends = build_backends(args, device)
    reward_funcs = create_reward_funcs(
        config.rlhf.reward_funcs,
        decoder,
        speech_vocab=sv,
        save_completions_steps=config.rlhf.save_completions_every_n_steps,
        save_dir=os.path.join(config.output_dir, "completion_samples"),
        logging_steps=config.training.logging_steps,
        backends=backends,
    )
    trainer = GRPOTrainer(
        params, model_cfg, tokenizer, sv, reward_funcs, config.rlhf,
        learning_rate=config.training.learning_rate,
        seed=config.training.seed,
        topology=topology,
        rollout_via_engine=args.rollout_via_engine,
    )
    os.makedirs(config.output_dir, exist_ok=True)
    if env.is_main:
        save_config(config.output_dir, config)
    mgr = CheckpointManager(os.path.join(config.output_dir, "checkpoints"),
                            keep_last_n=config.checkpointing.keep_only_last_n_checkpoints,
                            layout=trainer.layout, is_main=env.is_main)

    prompts_per_step = max(1, config.training.batch_size)
    rng = np.random.default_rng(config.training.seed)
    stats_acc = Statistics()
    metrics = MetricsLogger(config.output_dir, is_main=env.is_main)
    history = []
    for _ in range(args.total_steps):
        idxs = rng.integers(0, len(dataset), prompts_per_step)
        prompts = [dataset[int(i)] for i in idxs]
        stats = trainer.train_step(prompts)
        history.append(stats)
        stats_acc.step = trainer.step
        stats_acc.record_loss("grpo", stats["loss"])
        stats_acc.record_counter("reward_mean", stats["reward_mean"])
        metrics.log(trainer.step, {k: v for k, v in stats.items()
                                   if isinstance(v, (int, float))})
        if trainer.step % config.training.logging_steps == 0:
            log.info("GRPO step %d: %s", trainer.step, stats)
        if (config.checkpointing.save_steps > 0
                and trainer.step % config.checkpointing.save_steps == 0):
            mgr.save(trainer.step, trainer.params, trainer.opt_state, stats_acc, config)
    mgr.wait()
    mgr.close()
    metrics.close()
    log.info("RLHF done at step %d", trainer.step)
    return RLHFResult(trainer, history, backends, reward_funcs, list(mgr.save_seconds))


def main(argv=None) -> RLHFResult:
    parser = argparse.ArgumentParser(description="GRPO RLHF alignment")
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--dataset_dir", required=True)
    parser.add_argument("--model_dir", default="")
    parser.add_argument("--architecture", default="llama-tiny")
    parser.add_argument("--codec_decoder", default="",
                        help="xcodec2 torch checkpoint of the codec decoder for the rewards")
    parser.add_argument("--whisper_dir", default=os.environ.get("WHISPER_CHECKPOINT", ""),
                        help="Local HF Whisper dir for the WER reward.")
    parser.add_argument("--dnsmos_dir", default=os.environ.get("DNSMOS_ONNX_DIR", ""),
                        help="Dir with DNSMOS ONNX weights (sig_bak_ovr.onnx / model_v8.onnx).")
    parser.add_argument("--wavlm_dir", default=os.environ.get("WAVLM_CHECKPOINT", ""),
                        help="Local HF WavLM dir for the similarity reward.")
    parser.add_argument("--ecapa_checkpoint", default=os.environ.get("ECAPA_CHECKPOINT", ""),
                        help="UniSpeech ECAPA_TDNN_SMALL torch checkpoint (with the trained "
                             "WavLM layer weights) for the similarity reward.")
    parser.add_argument("--sampler_devices", type=int, default=0,
                        help="The last N ranks of the launcher's group sample on a "
                             "tensor-parallel mesh, the rest train; 0 = one device "
                             "time-multiplexed.")
    parser.add_argument("--rollout_via_engine", action="store_true",
                        help="Generate rollouts through the continuous-batching serving "
                             "engine instead of generate.")
    parser.add_argument("--total_steps", type=int, default=100)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain PyTorch path)")
    args = parser.parse_args(argv)
    config = ExperimentConfig.from_json(args.config_path, required=False)
    return run_training(config, args)


if __name__ == "__main__":
    main()
