"""Codec encoder, waveform (+ semantic features) -> FSQ codes (counterpart of
``tts_max_tpu/models/codec/encoder.py``).

- acoustic encoder: a k=7 conv (48 channels), 5 encoder blocks with strides
  (2, 2, 4, 4, 5) (channel-doubling, SnakeBeta residual units with
  dilations 1/3/9), then an anti-aliased SnakeBeta and a k=3 conv to 1024
  channels at 50 Hz. Its 36 activations run kernel G on the card;
- semantic encoder: a 3 x (k=3 conv) residual stack over wav2vec-BERT-2.0
  layer-16 hidden states (``w2vbert.py``);
- a fusion Linear over [semantic ; acoustic], then FSQ -> codes.

Channel-last [B, T, C], fp32, parameters in the JAX package's names and
layouts (conv kernels [K, Cin, Cout], dense kernels [in, out]).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from tts_max_tpu_torch.core.constants import CODEC_HOP_LENGTH
from tts_max_tpu_torch.device import resolve_device
from tts_max_tpu_torch.models.codec import fsq
from tts_max_tpu_torch.models.codec.filters import activation1d, init_snake_beta
from tts_max_tpu_torch.models.codec.vocos import conv1d, linear


@dataclass(frozen=True)
class EncoderConfig:
    num_generator_features: int = 48
    initial_conv_kernel_size: int = 7
    final_conv_kernel_size: int = 3
    up_ratios: tuple[int, ...] = (2, 2, 4, 4, 5)
    dilations: tuple[int, ...] = (1, 3, 9)
    acoustic_dim: int = 1024
    semantic_input_dim: int = 1024
    semantic_dim: int = 1024
    semantic_kernel_size: int = 3
    fsq: fsq.FSQConfig = field(default_factory=fsq.FSQConfig)

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.up_ratios))

    @property
    def fused_dim(self) -> int:
        return self.semantic_dim + self.acoustic_dim


def tiny_encoder_config() -> EncoderConfig:
    return EncoderConfig(
        num_generator_features=4,
        up_ratios=(2, 2, 4, 4, 5),
        acoustic_dim=16,
        semantic_input_dim=8,
        semantic_dim=16,
        fsq=fsq.FSQConfig(dim=32),
    )


# --- acoustic encoder -------------------------------------------------------------


def residual_unit(x, p, kernel_size: int = 7, dilation: int = 1):
    pad = ((kernel_size - 1) * dilation) // 2
    h = activation1d(x, p["act1"])
    h = conv1d(h, p["conv1"], padding=pad, dilation=dilation)
    h = activation1d(h, p["act2"])
    h = conv1d(h, p["conv2"])
    return x + h


def encoder_block(x, p, stride: int, dilations):
    for unit, d in zip(p["units"], dilations):
        x = residual_unit(x, unit, dilation=d)
    x = activation1d(x, p["act"])
    pad = stride // 2 + stride % 2
    return conv1d(x, p["down"], stride=stride, padding=pad)


def acoustic_encoder(wav: torch.Tensor, p, cfg: EncoderConfig) -> torch.Tensor:
    """wav [B, L] (L a multiple of hop) -> [B, L/hop, acoustic_dim]."""
    x = conv1d(wav[..., None], p["initial"], padding=(cfg.initial_conv_kernel_size - 1) // 2)
    for block, stride in zip(p["blocks"], cfg.up_ratios):
        x = encoder_block(x, block, stride, cfg.dilations)
    x = activation1d(x, p["final_act"])
    return conv1d(x, p["final"], padding=(cfg.final_conv_kernel_size - 1) // 2)


# --- semantic encoder -------------------------------------------------------------


def semantic_encoder(feats: torch.Tensor, p, cfg: EncoderConfig) -> torch.Tensor:
    """feats [B, T, semantic_input_dim] -> [B, T, semantic_dim]."""
    pad = (cfg.semantic_kernel_size - 1) // 2
    x = conv1d(feats, p["initial"], padding=pad)
    h = conv1d(torch.relu(x), p["res1"], padding=pad)
    h = conv1d(torch.relu(h), p["res2"], padding=pad)
    return conv1d(x + h, p["final"], padding=pad)


# --- full encoder -----------------------------------------------------------------


def encode_features(params, wav: torch.Tensor, semantic_feats: torch.Tensor,
                    cfg: EncoderConfig) -> torch.Tensor:
    """(wav [B, L], w2v features [B, T, Cs]) -> FSQ codes [B, T] int32.

    The two streams are length-aligned by truncation to the shorter."""
    ac = acoustic_encoder(wav, params["acoustic"], cfg)
    se = semantic_encoder(semantic_feats, params["semantic"], cfg)
    t = min(ac.shape[1], se.shape[1])
    fused = linear(torch.cat([se[:, :t], ac[:, :t]], dim=-1), params["fusion"])
    return fsq.encode(params["quantizer"], fused, cfg.fsq)[1]


def pad_wav_for_encode(wav: np.ndarray, hop: int = CODEC_HOP_LENGTH) -> np.ndarray:
    """Pad on the host up to the next hop multiple (a full hop when L is
    one already); the half-hop pad of the w2v-bert input happens in
    ``w2vbert.default_semantic_fn``."""
    L = wav.shape[-1]
    pad = hop - (L % hop) if L % hop else hop
    return np.pad(wav, [(0, 0)] * (wav.ndim - 1) + [(0, pad)])


def init_encoder(cfg: EncoderConfig, seed: int = 0, device="cuda"):
    """Random fp32 encoder parameters with the JAX package's distributions
    (truncated-normal conv kernels at std 0.02 with zero biases, zero
    log-scale SnakeBeta parameters, normal * fan_in^-1/2 dense kernels),
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def conv(ksize, cin, cout, bias=True):
        w = torch.empty(ksize, cin, cout, device=dev)
        torch.nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0, generator=gen)
        p = {"kernel": w * 0.02}
        if bias:
            p["bias"] = torch.zeros(cout, device=dev)
        return p

    def unit(dim):
        return {"act1": init_snake_beta(dim, dev), "conv1": conv(7, dim, dim),
                "act2": init_snake_beta(dim, dev), "conv2": conv(1, dim, dim)}

    d = cfg.num_generator_features
    blocks = []
    for stride in cfg.up_ratios:
        d *= 2
        blocks.append({"units": [unit(d // 2) for _ in cfg.dilations],
                       "act": init_snake_beta(d // 2, dev),
                       "down": conv(2 * stride, d // 2, d)})
    k = cfg.semantic_kernel_size
    fd = cfg.fused_dim
    return {
        "acoustic": {
            "initial": conv(cfg.initial_conv_kernel_size, 1, cfg.num_generator_features),
            "blocks": blocks,
            "final_act": init_snake_beta(d, dev),
            "final": conv(cfg.final_conv_kernel_size, d, cfg.acoustic_dim),
        },
        "semantic": {
            "initial": conv(k, cfg.semantic_input_dim, cfg.semantic_dim, bias=False),
            "res1": conv(k, cfg.semantic_dim, cfg.semantic_dim),
            "res2": conv(k, cfg.semantic_dim, cfg.semantic_dim),
            "final": conv(k, cfg.semantic_dim, cfg.semantic_dim, bias=False),
        },
        "fusion": {"kernel": torch.randn(fd, fd, generator=gen, device=dev) * fd ** -0.5,
                   "bias": torch.zeros(fd, device=dev)},
        "quantizer": fsq.init_params(cfg.fsq, gen, dev),
    }
