"""Alias-free DSP blocks of the codec encoder (counterpart of
``tts_max_tpu/models/codec/filters.py``): Kaiser-windowed sinc resampling
and the periodic Snake/SnakeBeta activations, channel-last [B, T, C], fp32.

``activation1d`` is the anti-aliased up-2x -> SnakeBeta -> down-2x sandwich
around every activation of the acoustic encoder. It picks its path by
configuration only:
- the standard (2, 2, 12, 12) configuration goes to
  ``ops.act1d.activation1d_kernel``: CUDA kernel G on a CUDA tensor, its
  plain version ``ops.act1d.activation1d_fused`` on a CPU tensor;
- ``fused=False``, or any other ratio or kernel size, runs the unfused
  composition (depthwise transposed conv, SnakeBeta, depthwise strided
  conv), the reference oracle of both.

The Kaiser-sinc taps (computed on the host with numpy once per (ratio,
kernel_size)) and SnakeBeta live in ``ops.act1d`` beside the kernel that
is built from them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tts_max_tpu_torch.ops.act1d import activation1d_kernel, kaiser_sinc_filter1d, snake_beta


def _depthwise_taps(taps: np.ndarray, channels: int, device) -> torch.Tensor:
    """The same taps for every channel, as a grouped-conv weight [C, 1, K]."""
    return torch.as_tensor(taps.copy(), device=device).view(1, 1, -1).expand(channels, 1, -1)


def lowpass1d(x: torch.Tensor, cutoff: float = 0.5, half_width: float = 0.6,
              stride: int = 1, kernel_size: int = 12) -> torch.Tensor:
    """Replicate-padded depthwise low-pass over [B, T, C]."""
    even = kernel_size % 2 == 0
    pad_left = kernel_size // 2 - int(even)
    pad_right = kernel_size // 2
    taps = kaiser_sinc_filter1d(cutoff, half_width, kernel_size)
    c = x.shape[-1]
    xt = F.pad(x.transpose(1, 2), (pad_left, pad_right), mode="replicate")
    y = F.conv1d(xt, _depthwise_taps(taps, c, x.device), stride=stride, groups=c)
    return y.transpose(1, 2)


def upsample1d(x: torch.Tensor, ratio: int = 2, kernel_size: int | None = None) -> torch.Tensor:
    """Anti-aliased ratio-x upsample of [B, T, C]: a depthwise transposed
    conv of the replicate-padded signal, cropped to T * ratio."""
    kernel_size = kernel_size or int(6 * ratio // 2) * 2
    stride = ratio
    pad = kernel_size // ratio - 1
    pad_left = pad * stride + (kernel_size - stride) // 2
    pad_right = pad * stride + (kernel_size - stride + 1) // 2
    taps = kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, kernel_size)
    c = x.shape[-1]
    xt = F.pad(x.transpose(1, 2), (pad, pad), mode="replicate")
    y = ratio * F.conv_transpose1d(xt, _depthwise_taps(taps, c, x.device),
                                   stride=stride, groups=c)
    return y[..., pad_left:-pad_right].transpose(1, 2)


def downsample1d(x: torch.Tensor, ratio: int = 2, kernel_size: int | None = None) -> torch.Tensor:
    """Anti-aliased ratio-x downsample of [B, T, C]."""
    kernel_size = kernel_size or int(6 * ratio // 2) * 2
    return lowpass1d(x, cutoff=0.5 / ratio, half_width=0.6 / ratio, stride=ratio,
                     kernel_size=kernel_size)


# --- snake activations ----------------------------------------------------------


def snake(x: torch.Tensor, alpha: torch.Tensor, logscale: bool = True) -> torch.Tensor:
    """x + (1/a) sin^2(a x); alpha per channel [C], x [B, T, C]."""
    a = (torch.exp(alpha) if logscale else alpha).float()
    xf = x.float()
    return (xf + (1.0 / (a + 1e-9)) * torch.square(torch.sin(xf * a))).to(x.dtype)


def init_snake_beta(channels: int, device="cuda"):
    """Log-scale init: zeros."""
    return {"alpha": torch.zeros(channels, device=device),
            "beta": torch.zeros(channels, device=device)}


def activation1d(x: torch.Tensor, p, up_ratio: int = 2, down_ratio: int = 2,
                 up_kernel: int = 12, down_kernel: int = 12,
                 fused: bool = True) -> torch.Tensor:
    """Anti-aliased activation: up-2x -> SnakeBeta -> down-2x over [B, T, C]
    (see the module docstring for the path each configuration takes)."""
    standard = (up_ratio == 2 and down_ratio == 2 and up_kernel == 12
                and down_kernel == 12)
    if fused and standard:
        return activation1d_kernel(x, p)
    x = upsample1d(x, up_ratio, up_kernel)
    x = snake_beta(x, p["alpha"], p["beta"])
    return downsample1d(x, down_ratio, down_kernel)
