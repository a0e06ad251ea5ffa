"""Public codec APIs (counterpart of ``tts_max_tpu/models/codec/api.py``):
``AudioEncoder`` (waveform -> codes), ``AudioDecoder`` (codes ->
waveform), the prompt-caching ``CachingAudioEncoder``, ``DecoderConfig``
read from ``model_config.json``, and factories that take port parameters
(``params=``) or a torch xcodec2 checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable

import numpy as np
import torch

from tts_max_tpu_torch.core import constants
from tts_max_tpu_torch.device import full_fp32, resolve_device
from tts_max_tpu_torch.models.codec import encoder as enc
from tts_max_tpu_torch.models.codec import torch_import, vocos


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Serving decoder config, read from and written to
    ``model_config.json`` (a missing ``model_type`` key defaults to
    "vocos")."""

    sample_rate: int = 16000
    token_rate: int = 50
    hop_length: int = 320
    upsample_factors: tuple[int, ...] | None = None
    kernel_sizes: tuple[int, ...] | None = None
    model_type: str = "vocos"

    @classmethod
    def from_json(cls, path: str) -> "DecoderConfig":
        with open(path) as f:
            d = json.load(f)
        return cls(
            sample_rate=d.get("sample_rate", 16000),
            token_rate=d.get("token_rate", 50),
            hop_length=d.get("hop_length", 320),
            upsample_factors=tuple(d["upsample_factors"])
            if d.get("upsample_factors") else None,
            kernel_sizes=tuple(d["kernel_sizes"]) if d.get("kernel_sizes") else None,
            model_type=d.get("model_type", "vocos"),
        )

    def to_json(self, path: str) -> None:
        """``model_config.json`` with the JAX package's keys and layout."""
        with open(path, "w") as f:
            json.dump({
                "sample_rate": self.sample_rate,
                "token_rate": self.token_rate,
                "hop_length": self.hop_length,
                "upsample_factors": list(self.upsample_factors)
                if self.upsample_factors else None,
                "kernel_sizes": list(self.kernel_sizes) if self.kernel_sizes else None,
                "model_type": self.model_type,
            }, f, indent=2)

    def vocos_config(self) -> vocos.VocosConfig:
        return vocos.VocosConfig(
            hop_length=self.hop_length,
            upsample_factors=self.upsample_factors or (),
            upsample_kernel_sizes=self.kernel_sizes or (),
        )


class AudioDecoder:
    """codes -> waveform. ``params`` are port parameters (``init_decoder``
    or ``convert.vocos_from_numpy``) on ``device``. Building one turns TF32
    off for the process (``device.full_fp32``)."""

    def __init__(self, params: Any, cfg: vocos.VocosConfig, config: DecoderConfig,
                 device="cuda"):
        self.device = resolve_device(device)
        emb = params["fc_post_a"]["kernel"]
        if emb.device != self.device:
            raise ValueError(f"decoder params live on {emb.device}, not on {self.device}")
        full_fp32()
        self._params = params
        self._cfg = cfg
        self.config = config

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    @property
    def token_rate(self) -> int:
        return self.config.token_rate

    @torch.inference_mode()
    def decode(self, codes) -> np.ndarray:
        """codes: [T] or [B, T] int -> wav float32 [B, samples] (numpy)."""
        codes = torch.as_tensor(np.asarray(codes, dtype=np.int64), device=self.device)
        if codes.ndim == 1:
            codes = codes[None]
        return vocos.decode(self._params, codes, self._cfg).cpu().numpy()


class AudioEncoder:
    """waveform -> FSQ codes. ``params`` are port parameters
    (``encoder.init_encoder`` or ``convert.encoder_from_numpy``) on
    ``device``; ``semantic_fn(padded_wav [B, L] numpy) -> feats [B, T, C]``
    on ``device`` supplies the wav2vec-BERT layer-16 hidden states
    (``w2vbert.default_semantic_fn``) or any stand-in of that shape.
    Building one turns TF32 off for the process (``device.full_fp32``)."""

    def __init__(self, params: Any, cfg: enc.EncoderConfig,
                 semantic_fn: Callable[[np.ndarray], torch.Tensor],
                 sample_rate: int = constants.CODEC_SAMPLE_RATE,
                 token_rate: int = constants.CODEC_TOKEN_RATE, device="cuda"):
        self.device = resolve_device(device)
        fusion = params["fusion"]["kernel"]
        if fusion.device != self.device:
            raise ValueError(f"encoder params live on {fusion.device}, not on {self.device}")
        full_fp32()
        self._params = params
        self._cfg = cfg
        self._semantic_fn = semantic_fn
        self.sample_rate = sample_rate
        self.token_rate = token_rate

    @torch.inference_mode()
    def encode(self, wav) -> np.ndarray:
        """wav: [L] or [B, L] float -> codes int32 [T] / [B, T] (numpy). The
        wav is padded to a hop multiple on the host."""
        wav = np.asarray(wav, dtype=np.float32)
        squeeze = wav.ndim == 1
        if squeeze:
            wav = wav[None]
        wav = enc.pad_wav_for_encode(wav, self._cfg.hop_length)
        feats = self._semantic_fn(wav)
        codes = enc.encode_features(self._params, torch.from_numpy(wav).to(self.device),
                                    feats, self._cfg).cpu().numpy()
        return codes[0] if squeeze else codes


class CachingAudioEncoder:
    """Memoizes prompt encodings by id around any ``encoder`` with
    ``encode(wav) -> codes`` (and ``sample_rate`` / ``token_rate``)."""

    def __init__(self, encoder):
        self._encoder = encoder
        self._cache: dict[str, np.ndarray] = {}

    @property
    def sample_rate(self) -> int:
        return self._encoder.sample_rate

    @property
    def token_rate(self) -> int:
        return self._encoder.token_rate

    def encode(self, prompt_id: str, wav) -> np.ndarray:
        if prompt_id not in self._cache:
            self._cache[prompt_id] = self._encoder.encode(wav)
        return self._cache[prompt_id]


def create_decoder(
    checkpoint_path: str | None = None,
    model_config_path: str | None = None,
    params: Any | None = None,
    config: DecoderConfig | None = None,
    device="cuda",
) -> AudioDecoder:
    """``model_config.json`` lives next to the checkpoint unless given
    explicitly; ``params=`` (port parameters on ``device``) or a torch
    xcodec2 checkpoint."""
    if config is None:
        if model_config_path is None and checkpoint_path is not None:
            model_config_path = os.path.join(
                os.path.dirname(checkpoint_path), "model_config.json"
            )
        config = (
            DecoderConfig.from_json(model_config_path)
            if model_config_path and os.path.exists(model_config_path)
            else DecoderConfig()
        )
    vcfg = config.vocos_config()
    if params is None:
        if checkpoint_path is None:
            raise ValueError("need checkpoint_path or params")
        params = torch_import.import_decoder(
            torch_import.load_torch_checkpoint(checkpoint_path), vcfg, device=device)
    return AudioDecoder(params, vcfg, config, device=device)


def create_encoder(
    checkpoint_path: str | None = None,
    params: Any | None = None,
    cfg: enc.EncoderConfig | None = None,
    semantic_fn: Callable | None = None,
    device="cuda",
) -> AudioEncoder:
    """``params=`` (port parameters on ``device``) or a torch xcodec2
    checkpoint; without ``semantic_fn``, w2v-bert weights are read from the
    same checkpoint, as the JAX package does."""
    cfg = cfg or enc.EncoderConfig()
    if params is None:
        if checkpoint_path is None:
            raise ValueError("need checkpoint_path or params")
        params = torch_import.import_encoder(
            torch_import.load_torch_checkpoint(checkpoint_path), cfg, device=device)
    if semantic_fn is None:
        from tts_max_tpu_torch.models.codec import w2vbert

        semantic_fn = w2vbert.default_semantic_fn(checkpoint_path, device=device)
    return AudioEncoder(params, cfg, semantic_fn, device=device)
