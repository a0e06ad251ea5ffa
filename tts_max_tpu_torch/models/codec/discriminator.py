"""GAN discriminators for codec training (counterpart of
``tts_max_tpu/models/codec/discriminator.py``): HiFiGAN's multi-period
discriminator (periods 2/3/5/7/11, 2D convs over period-folded waveforms)
and the multi-resolution spectral discriminator (8 STFT resolutions, fft
sizes 78 to 2296). Each sub-discriminator returns its per-layer features
(for the feature-matching loss) with its final logits last.

Tensors are NCHW and conv kernels are torch's ``[Cout, Cin, kh, kw]``, for
``F.conv2d`` (the JAX package is NHWC with ``[kh, kw, Cin, Cout]`` kernels;
``convert.mpd_from_numpy`` and ``msd_from_numpy`` permute them). A feature
map is the JAX one transposed NHWC -> NCHW; a period discriminator's final
logits are flattened in the same order as JAX's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from tts_max_tpu_torch.device import resolve_device
from tts_max_tpu_torch.ops.stft import stft


@dataclass(frozen=True)
class MPDConfig:
    periods: tuple[int, ...] = (2, 3, 5, 7, 11)
    channels: int = 16
    channel_increasing_factor: int = 4
    max_downsample_channels: int = 512
    kernel_sizes: tuple[int, int] = (5, 3)
    downsample_scales: tuple[int, ...] = (3, 3, 3, 3, 1)
    leaky_slope: float = 0.1


@dataclass(frozen=True)
class MSDConfig:
    fft_sizes: tuple[int, ...] = (78, 126, 206, 334, 542, 876, 1418, 2296)
    hop_sizes: tuple[int, ...] = (39, 63, 103, 167, 271, 438, 709, 1148)
    win_lengths: tuple[int, ...] = (78, 126, 206, 334, 542, 876, 1418, 2296)
    channels: int = 32
    max_downsample_channels: int = 512
    kernel_sizes: tuple[int, int] = (5, 3)
    downsample_scales: tuple[int, ...] = (2, 2, 2)
    leaky_slope: float = 0.2


def tiny_mpd_config() -> MPDConfig:
    return MPDConfig(periods=(2, 3), channels=4, max_downsample_channels=16,
                     downsample_scales=(3, 3, 1))


def tiny_msd_config() -> MSDConfig:
    return MSDConfig(fft_sizes=(78, 126), hop_sizes=(39, 63), win_lengths=(78, 126),
                     channels=4, max_downsample_channels=16, downsample_scales=(2, 2))


def conv2d(x: torch.Tensor, p, stride=(1, 1), padding=(0, 0)) -> torch.Tensor:
    """NCHW conv; p["kernel"]: [Cout, Cin, kh, kw], p["bias"]: [Cout]."""
    return F.conv2d(x, p["kernel"], p.get("bias"), stride=stride, padding=padding)


def _conv_init(gen, kh, kw, cin, cout, device):
    return {"kernel": torch.randn(cout, cin, kh, kw, generator=gen, device=device) * 0.02,
            "bias": torch.zeros(cout, device=device)}


# --- period discriminator ---------------------------------------------------


def _init_period(gen, cfg: MPDConfig, device):
    k0, k1 = cfg.kernel_sizes
    convs, cin, cout = [], 1, cfg.channels
    for _ in cfg.downsample_scales:
        convs.append(_conv_init(gen, k0, 1, cin, cout, device))
        cin, cout = cout, min(cout * cfg.channel_increasing_factor,
                              cfg.max_downsample_channels)
    return {"convs": convs, "out": _conv_init(gen, k1 - 1, 1, cin, 1, device)}


def period_discriminator(wav: torch.Tensor, p, period: int, cfg: MPDConfig):
    """wav [B, T] -> per-layer features [B, C, T/period, period], then the
    flat final logits [B, n]."""
    b, t = wav.shape
    if t % period:
        wav = F.pad(wav[:, None], (0, period - t % period), mode="reflect")[:, 0]
    x = wav.reshape(b, 1, -1, period)
    k0, k1 = cfg.kernel_sizes
    outs = []
    for conv, scale in zip(p["convs"], cfg.downsample_scales):
        x = F.leaky_relu(conv2d(x, conv, stride=(scale, 1), padding=((k0 - 1) // 2, 0)),
                         cfg.leaky_slope)
        outs.append(x)
    x = conv2d(x, p["out"], padding=((k1 - 1) // 2, 0))
    outs.append(x.reshape(b, -1))
    return outs


def init_mpd(cfg: MPDConfig, seed: int = 1, device="cuda"):
    """Kernels normal * 0.02 and zero biases, one period after another,
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [_init_period(gen, cfg, dev) for _ in cfg.periods]


def mpd(wav: torch.Tensor, params, cfg: MPDConfig):
    """[B, T] -> list (per period) of per-layer feature lists."""
    return [period_discriminator(wav, p, period, cfg)
            for p, period in zip(params, cfg.periods)]


# --- spectral discriminator -------------------------------------------------


def _init_spec(gen, cfg: MSDConfig, device):
    k0, k1 = cfg.kernel_sizes
    layers, cin = [_conv_init(gen, k0, k0, 1, cfg.channels, device)], cfg.channels
    for scale in cfg.downsample_scales:
        cout = min(cin * scale, cfg.max_downsample_channels)
        layers.append(_conv_init(gen, scale * 2 + 1, scale * 2 + 1, cin, cout, device))
        cin = cout
    cout = min(cin * 2, cfg.max_downsample_channels)
    layers.append(_conv_init(gen, k1, k1, cin, cout, device))
    layers.append(_conv_init(gen, k1, k1, cout, 1, device))
    return {"layers": layers}


def nlayer_spec_discriminator(spec: torch.Tensor, p, cfg: MSDConfig):
    """spec [B, 1, F, T] -> per-layer features (the final logits last)."""
    k0, k1 = cfg.kernel_sizes
    layers, slope = p["layers"], cfg.leaky_slope
    x = F.leaky_relu(conv2d(spec, layers[0], stride=(2, 2), padding=(k0 // 2, k0 // 2)),
                     slope)
    outs = [x]
    for conv, scale in zip(layers[1:-2], cfg.downsample_scales):
        x = F.leaky_relu(conv2d(x, conv, stride=(scale, scale), padding=(scale, scale)),
                         slope)
        outs.append(x)
    x = F.leaky_relu(conv2d(x, layers[-2], padding=(k1 // 2, k1 // 2)), slope)
    outs.append(x)
    outs.append(conv2d(x, layers[-1], padding=(k1 // 2, k1 // 2)))
    return outs


def init_msd(cfg: MSDConfig, seed: int = 2, device="cuda"):
    """As ``init_mpd``, one resolution after another."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [_init_spec(gen, cfg, dev) for _ in cfg.fft_sizes]


def _magnitude_spec(wav: torch.Tensor, fft: int, hop: int, win: int) -> torch.Tensor:
    """Clamped magnitude STFT under a Hann window of ``win``: [B, 1, F, T]."""
    s = torch.view_as_real(stft(wav, fft, hop, win))
    return torch.sqrt(torch.clamp(s.square().sum(-1), 1e-7, 1e3))[:, None]


def msd(wav: torch.Tensor, params, cfg: MSDConfig):
    """[B, T] -> list (per resolution) of per-layer feature lists."""
    return [nlayer_spec_discriminator(_magnitude_spec(wav, fft, hop, win), p, cfg)
            for p, fft, hop, win in zip(params, cfg.fft_sizes, cfg.hop_sizes,
                                        cfg.win_lengths)]
