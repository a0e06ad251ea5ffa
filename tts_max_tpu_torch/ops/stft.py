"""Inverse STFT of the codec's ISTFT head (counterpart of the ISTFT part of
``tts_max_tpu/ops/stft.py``): irfft, windowed overlap-add, division by the
window envelope ("same" padding)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """torch.hann_window(periodic=True) equivalent, in numpy."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2 * np.pi * n / win_length)).astype(dtype)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Fold [B, T, win] -> [B, (T-1)*hop + win] (sum of overlapping frames)."""
    b, t, win = frames.shape
    y = F.fold(frames.float().transpose(1, 2), output_size=(1, (t - 1) * hop + win),
               kernel_size=(1, win), stride=(1, hop))
    return y.reshape(b, -1)


def istft_same(spec: torch.Tensor, n_fft: int, hop_length: int,
               win_length: int | None = None,
               window: np.ndarray | None = None) -> torch.Tensor:
    """spec: complex [B, n_fft//2+1, T] -> wav [B, T * hop_length]."""
    win_length = win_length or n_fft
    if window is None:
        window = hann_window(win_length)
    window = torch.as_tensor(window, device=spec.device)
    pad = (win_length - hop_length) // 2
    t = spec.shape[-1]

    ifft = torch.fft.irfft(spec, n=n_fft, dim=1)  # [B, n_fft, T]
    y = overlap_add(ifft.transpose(1, 2) * window, hop_length)
    env = overlap_add((window ** 2).expand(1, t, win_length), hop_length)
    if pad:
        y, env = y[:, pad:-pad], env[:, pad:-pad]
    return y / env.clamp_min(1e-11)
