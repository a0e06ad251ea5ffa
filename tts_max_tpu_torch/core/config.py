"""Typed experiment configuration system.

Copy of ``tts_max_tpu/core/config.py`` (the port imports nothing of the JAX package).

JSON experiment configs deserialize into frozen-ish dataclasses, tolerant of
unknown keys (the reference's example configs carry keys its dataclasses do
not declare — see tts/utils/configuration.py:249-305 and the
survey note on cattrs tolerance). Required-key validation and dynamic-field
reset mirror reference configuration.py:287-300.

TPU-specific additions: mesh axis sizes (data / fsdp / tensor), sequence
bucketing for static shapes, and precision policies expressed as dtypes.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, get_args, get_origin, get_type_hints


class Strategy(str, Enum):
    """Parallelism strategy (reference configuration.py:21-35 had ddp|fsdp|deepspeed).

    On TPU these map onto one GSPMD mesh:
      - ``dp``   : batch sharded over the ``data`` axis, params replicated (DDP)
      - ``fsdp`` : params/optimizer state additionally sharded over ``fsdp``
                   (FSDP / ZeRO equivalent)
      - ``tp``   : params sharded over ``tensor`` (serving-style TP)
      - ``fsdp_tp``: both.
    """

    SINGLE = "single"
    DP = "dp"
    FSDP = "fsdp"
    TP = "tp"
    FSDP_TP = "fsdp_tp"
    # Accepted aliases from reference configs.
    DDP = "ddp"
    DEEPSPEED = "deepspeed"

    def canonical(self) -> "Strategy":
        if self in (Strategy.DDP,):
            return Strategy.DP
        if self in (Strategy.DEEPSPEED,):
            return Strategy.FSDP
        return self


def _convert(value: Any, typ: Any) -> Any:
    """Convert a JSON value into the annotated dataclass field type."""
    if value is None:
        return None
    origin = get_origin(typ)
    if origin is not None:
        args = get_args(typ)
        if origin in (list, tuple):
            item_t = args[0] if args else Any
            seq = [_convert(v, item_t) for v in value]
            return tuple(seq) if origin is tuple else seq
        if origin is dict:
            kt = args[0] if args else Any
            vt = args[1] if len(args) > 1 else Any
            return {_convert(k, kt): _convert(v, vt) for k, v in value.items()}
        # Optional[T] / Union — try each arm.
        for arm in args:
            if arm is type(None):
                continue
            try:
                return _convert(value, arm)
            except (TypeError, ValueError):
                continue
        return value
    if dataclasses.is_dataclass(typ) and isinstance(value, dict):
        return from_dict(typ, value)
    if isinstance(typ, type) and issubclass(typ, Enum):
        return typ(value)
    if typ in (int, float, str, bool):
        return typ(value)
    return value


def from_dict(cls: type, data: dict[str, Any]):
    """Build dataclass ``cls`` from ``data``, ignoring unknown keys."""
    hints = get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in data:
            kwargs[f.name] = _convert(data[f.name], hints[f.name])
    return cls(**kwargs)


def to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return [to_dict(v) for v in obj]
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    return obj


@dataclass
class MeshConfig:
    """Logical device mesh axis sizes. -1 on ``data`` means "all remaining"."""

    data: int = -1
    fsdp: int = 1
    tensor: int = 1


@dataclass
class TrainingConfig:
    """Mirrors reference TrainingConfig semantics (configuration.py, sft.json)."""

    seed: int = 777
    logging_steps: int = 50
    eval_steps: int = 300
    gradient_accumulation_steps: int = 1
    gradient_clip_value: float = 1.0
    learning_rate: float = 1e-4
    betas: tuple[float, float] = (0.9, 0.95)
    warmup_ratio: float = 0.05
    batch_size: int = 4  # per-step global micro-batch (per process)
    weight_decay: float = 0.1
    precision: str = "bf16"  # "bf16" casts float params to bf16; "fp32" keeps
    strategy: Strategy = Strategy.DP
    gradient_checkpointing: bool = False
    # remat granularity when gradient_checkpointing is on: "full" recomputes
    # the whole layer (min memory); "dots" saves matmul outputs and
    # recomputes only elementwise ops (faster backward, more memory)
    remat_policy: str = "full"
    # AdamW first-moment dtype; "bf16" halves optimizer-state memory (needed
    # to fit 1B single-chip together with bf16 params + remat)
    adam_mu_dtype: str = "fp32"
    num_workers: int = 1
    num_train_epochs: float = 1.0
    # Blockwise cross-entropy: sequence-chunked loss that never materializes
    # the full [B, S, 193856] fp32 logprobs (0 = naive full-vocab loss).
    loss_chunk_size: int = 256
    lr_scheduler: str = "cosine"
    mesh: MeshConfig = field(default_factory=MeshConfig)
    # Static-shape control: sequences are padded to the smallest bucket.
    seq_len_buckets: tuple[int, ...] = ()


@dataclass
class ModelingParameters:
    codebook_size: int = 65536
    max_seq_len: int = 2048
    model_name: str = "meta-llama/Llama-3.2-1B-Instruct"
    enable_text_normalization: bool = True
    # TPU-native additions: explicit architecture override for from-scratch
    # runs (no HF download available on an air-gapped pod).
    architecture: str | None = None  # e.g. "llama-tiny", "llama-1b", "llama-8b"
    vocab_size: int | None = None


@dataclass
class ModelingConfig:
    parameters: ModelingParameters = field(default_factory=ModelingParameters)


@dataclass
class CheckpointingConfig:
    save_steps: int = 100
    collect_health_stats: bool = False
    save_intermediate_generations: bool = False
    only_load_model_weights: bool = False
    keep_only_last_n_checkpoints: int = 10
    checkpoint_file_to_resume_from: str | None = None
    validation_type: str = "none"  # none | random_phrases | prompt_continuation


@dataclass
class DatasetConfig:
    allowed_languages: tuple[str, ...] = ()
    min_dnsmos_score: float = 0.0
    min_sample_rate: int = 0
    min_duration_sec: float = 0.0
    enable_rlhf_training: bool = False


@dataclass
class LoraConfig:
    enabled: bool = False
    r: int = 16
    alpha: int = 32
    dropout: float = 0.0
    target_modules: tuple[str, ...] = ()  # empty -> auto-discover all Linears


@dataclass
class RLHFConfig:
    """GRPO hyperparameters (reference rlhf_main.py:110-136 / rlhf.json)."""

    num_generations: int = 8
    max_prompt_length: int = 1280
    max_completion_length: int = 1792
    temperature: float = 0.8
    top_k: int = 50
    repetition_penalty: float = 1.1
    kl_beta: float = 0.0
    reward_funcs: tuple[str, ...] = ("wer",)
    reward_weights: tuple[float, ...] = ()
    save_completions_every_n_steps: int = 0
    whisper_model: str = "openai/whisper-large-v3"
    # Constrain rollout sampling to the speech-token window
    # (SpeechVocab.generation_window): faster rollouts (~3x smaller LM-head
    # read) and no reward-crashing malformed completions. Opt-in because it
    # changes the behavior policy (the reference's vLLM sampler is
    # unconstrained).
    constrain_to_speech: bool = False


@dataclass
class CodecTrainingConfig:
    """Codec GAN training knobs (reference decoder.py:147-153, train_codec.py)."""

    sample_rate: int = 16000
    upsample_factors: tuple[int, ...] | None = None
    upsample_kernel_sizes: tuple[int, ...] | None = None
    code_window_size: int = 80  # codes per training window
    lambda_mel: float = 15.0
    lambda_adv: float = 1.0
    lambda_fm: float = 1.0
    lambda_rms: float = 1.0
    lambda_disc: float = 1.0
    generator_lr: float = 1e-4
    discriminator_lr: float = 1e-4


@dataclass
class ExperimentConfig:
    training: TrainingConfig = field(default_factory=TrainingConfig)
    modeling: ModelingConfig = field(default_factory=ModelingConfig)
    checkpointing: CheckpointingConfig = field(default_factory=CheckpointingConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    lora: LoraConfig = field(default_factory=LoraConfig)
    rlhf: RLHFConfig = field(default_factory=RLHFConfig)
    codec: CodecTrainingConfig = field(default_factory=CodecTrainingConfig)
    train_weighted_datasets: dict[str, float] = field(default_factory=dict)
    val_weighted_datasets: dict[str, float] = field(default_factory=dict)
    experiment_name: str = "experiment"
    output_dir: str = "output"
    # Dynamic fields, computed at runtime and reset on load
    # (reference configuration.py:295-300).
    world_size: int = 0
    model_size: int = 0
    total_steps: int = 0

    REQUIRED_KEYS = ("training", "modeling", "checkpointing")
    DYNAMIC_FIELDS = ("world_size", "model_size", "total_steps")

    @classmethod
    def from_json(cls, path: str, required: bool = True) -> "ExperimentConfig":
        with open(path) as f:
            data = json.load(f)
        if required:
            missing = [k for k in cls.REQUIRED_KEYS if k not in data]
            if missing:
                raise ValueError(f"config {path} missing required keys: {missing}")
        cfg = from_dict(cls, data)
        for name in cls.DYNAMIC_FIELDS:
            setattr(cfg, name, 0)
        return cfg

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(to_dict(self), f, indent=2)
