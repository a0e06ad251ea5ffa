"""Host-side audio IO: wav load/save, mono-ize, resample (counterpart of
``tts_max_tpu/data/audio_io.py``): scipy's ``wavfile`` and polyphase
``resample_poly``, on the host.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def load_wav(path: str, target_sample_rate: int | None = None) -> tuple[np.ndarray, int]:
    """Returns (wav float32 [1, n] in [-1, 1], sample_rate)."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    if wav.ndim == 2:  # [n, channels] -> mono
        wav = wav.mean(axis=1)
    if target_sample_rate and sr != target_sample_rate:
        g = math.gcd(sr, target_sample_rate)
        wav = resample_poly(wav, target_sample_rate // g, sr // g).astype(np.float32)
        sr = target_sample_rate
    return wav[None, :], sr


def save_wav(path: str, wav: np.ndarray, sample_rate: int) -> None:
    """16-bit PCM mono; ``wav`` [n] or [1, n] float, clipped to [-1, 1]."""
    wav = np.asarray(wav, dtype=np.float32)
    if wav.ndim == 2:
        wav = wav[0]
    wav = np.clip(wav, -1.0, 1.0)
    wavfile.write(path, sample_rate, (wav * 32767.0).astype(np.int16))
