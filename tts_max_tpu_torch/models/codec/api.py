"""Public codec APIs (counterpart of ``tts_max_tpu/models/codec/api.py``):
``DecoderConfig``, ``AudioDecoder``, ``create_decoder`` and the
prompt-caching ``CachingAudioEncoder`` wrapper. The audio encoder itself and
the loading of torch codec checkpoints are not ported yet:
``CachingAudioEncoder`` wraps any object with ``encode(wav) -> codes``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch

from tts_max_tpu_torch.device import resolve_device
from tts_max_tpu_torch.models.codec import vocos


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Serving decoder config, read from ``model_config.json`` (a missing
    ``model_type`` key defaults to "vocos")."""

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

    def vocos_config(self) -> vocos.VocosConfig:
        return vocos.VocosConfig(
            hop_length=self.hop_length,
            upsample_factors=self.upsample_factors or (),
            upsample_kernel_sizes=self.kernel_sizes or (),
        )


class AudioDecoder:
    """codes -> waveform. ``params`` are port parameters (``init_decoder``
    or ``convert.vocos_from_numpy``) on ``device``."""

    def __init__(self, params: Any, cfg: vocos.VocosConfig, config: DecoderConfig,
                 device="cuda"):
        self.device = resolve_device(device)
        emb = params["fc_post_a"]["kernel"]
        if emb.device != self.device:
            raise ValueError(f"decoder params live on {emb.device}, not on {self.device}")
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
    explicitly. Only ``params=`` is supported so far: reading a codec
    checkpoint is not ported yet."""
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
    if params is None:
        raise NotImplementedError(
            "loading a codec checkpoint is not ported yet; pass params="
        )
    return AudioDecoder(params, config.vocos_config(), config, device=device)
