"""STFT ops (counterpart of ``tts_max_tpu/ops/stft.py``): the inverse STFT
of the codec's ISTFT head (irfft, windowed overlap-add, division by the
window envelope, "same" padding), and for GAN training the forward STFT
(``torch.stft``-compatible with a Hann window: centered and reflect-padded
unless ``center=False``, a window shorter than ``n_fft`` zero-padded to the
middle; zero-padded with ``pad_mode="constant"``, as DNSMOS's features
are), the Slaney mel filter bank (numpy, float64, as torchaudio's
``norm='slaney', mel_scale='slaney'``) and the mel spectrogram of the
magnitude (or of its ``power``, ECAPA's fbank features).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from tts_max_tpu_torch.device import cached_constant


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """torch.hann_window(periodic=True) equivalent, in numpy."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2 * np.pi * n / win_length)).astype(dtype)


def _hann_padded(win_length: int, n_fft: int) -> np.ndarray:
    """The Hann window, zero-padded to the middle of ``n_fft`` samples."""
    lpad = (n_fft - win_length) // 2
    return np.pad(hann_window(win_length), (lpad, n_fft - win_length - lpad))


_window = cached_constant(_hann_padded)  # (device, win_length, n_fft)


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
    window = (_window(spec.device, win_length, win_length) if window is None
              else torch.as_tensor(window, device=spec.device))
    pad = (win_length - hop_length) // 2
    t = spec.shape[-1]

    ifft = torch.fft.irfft(spec, n=n_fft, dim=1)  # [B, n_fft, T]
    y = overlap_add(ifft.transpose(1, 2) * window, hop_length)
    env = overlap_add((window ** 2).expand(1, t, win_length), hop_length)
    if pad:
        y, env = y[:, pad:-pad], env[:, pad:-pad]
    return y / env.clamp_min(1e-11)


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """[B, L] -> [B, n_frames, frame_length] (a strided view)."""
    return x.unfold(-1, frame_length, hop)


def stft(x: torch.Tensor, n_fft: int, hop_length: int, win_length: int | None = None,
         center: bool = True, pad_mode: str = "reflect") -> torch.Tensor:
    """Complex STFT with a Hann window, x: [B, L] -> [B, n_fft//2+1, T].
    ``pad_mode`` ("reflect" or "constant", zeros) pads the centered signal."""
    window = _window(x.device, win_length or n_fft, n_fft)
    if center:
        p = n_fft // 2
        x = F.pad(x[:, None], (p, p), mode=pad_mode)[:, 0]
    spec = torch.fft.rfft(frame_signal(x, n_fft, hop_length) * window, n=n_fft, dim=-1)
    return spec.transpose(-1, -2)


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    lin = f / (200.0 / 3)
    logstep = np.log(6.4) / 27.0
    with np.errstate(divide="ignore"):
        log_part = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / logstep
    return np.where(f >= 1000.0, log_part, lin)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    logstep = np.log(6.4) / 27.0
    return np.where(m >= 15.0, 1000.0 * np.exp(logstep * (m - 15.0)), m * (200.0 / 3))


@functools.lru_cache(maxsize=32)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: float | None = None) -> np.ndarray:
    """[n_fft//2+1, n_mels] triangular filters, Slaney scale and area norm."""
    fmax = fmax if fmax is not None else sample_rate / 2
    all_freqs = np.linspace(0, sample_rate / 2, n_fft // 2 + 1)
    f_pts = _mel_to_hz_slaney(np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax),
                                          n_mels + 2))
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]  # [n_freqs, n_mels+2]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    fb = fb * (2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels]))[None, :]
    return fb.astype(np.float32)


_mel = cached_constant(mel_filterbank)  # (device, sample_rate, n_fft, n_mels)


def mel_spectrogram(x: torch.Tensor, sample_rate: int, n_fft: int, hop_length: int,
                    n_mels: int, power: float = 1.0) -> torch.Tensor:
    """torchaudio ``MelSpectrogram(power=power, center=True, norm='slaney',
    mel_scale='slaney')``: x [B, L] -> [B, n_mels, T]."""
    mag = stft(x, n_fft, hop_length).abs()
    if power != 1.0:
        mag = mag ** power
    return torch.einsum("bft,fm->bmt", mag, _mel(x.device, sample_rate, n_fft, n_mels))
