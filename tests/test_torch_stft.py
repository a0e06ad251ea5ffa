"""The port's forward STFT, Slaney mel filter bank and mel spectrogram
(``tts_max_tpu_torch/ops/stft.py``) against the JAX package's
``ops/stft.py`` on the CPU in fp32: ``stft`` complex, with ``center`` on and
off and a window shorter than ``n_fft`` (zero-padded to the middle), also
against ``torch.stft``; the filter bank bitwise (both numpy float64 cast to
fp32); ``mel_spectrogram`` at the GAN mel loss's resolutions and two
sample rates; DNSMOS's zero-padded STFT at its odd ``n_fft`` 321
(``pad_mode="constant"``) and ECAPA's power mel (``power=2.0``) as the RLHF
rewards call them. Tolerance: 1e-5 of the largest magnitude (fp32 FFTs of two
libraries)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_max_tpu.ops import stft as jstft
from tts_max_tpu_torch.ops import stft


@pytest.fixture(scope="module")
def wav():
    return np.random.default_rng(0).standard_normal((2, 4000)).astype(np.float32) * 0.3


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), what


@pytest.mark.parametrize("n_fft,hop,win,center", [
    (512, 128, None, True), (1024, 120, 600, True), (78, 39, 78, True), (2296, 1148, 2296, True),
    (512, 50, 240, False), (255, 64, 200, True)])
def test_stft_matches_jax_and_torch(wav, n_fft, hop, win, center):
    got = stft.stft(torch.from_numpy(wav), n_fft, hop, win, center=center)
    want = jstft.stft(jnp.asarray(wav), n_fft, hop, win, center=center)
    assert got.dtype == torch.complex64
    _close(got.numpy(), np.asarray(want), "vs JAX")
    w = win or n_fft
    ref = torch.stft(torch.from_numpy(wav), n_fft, hop, w,
                     torch.from_numpy(stft.hann_window(w)), center=center, pad_mode="reflect",
                     return_complex=True)
    _close(got.numpy(), ref.numpy(), "vs torch.stft")


@pytest.mark.parametrize("sr,n_fft,n_mels,fmin,fmax", [
    (16000, 32, 5, 0.0, None), (16000, 512, 80, 0.0, None), (16000, 2048, 320, 0.0, None),
    (24000, 1024, 100, 30.0, 11000.0)])
def test_mel_filterbank_bitwise(sr, n_fft, n_mels, fmin, fmax):
    got = stft.mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    want = jstft.mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("win,n_mels", [(32, 5), (128, 20), (512, 80), (2048, 320)])
@pytest.mark.parametrize("sr", [16000, 24000])
def test_mel_spectrogram_matches_jax(wav, win, n_mels, sr):
    got = stft.mel_spectrogram(torch.from_numpy(wav), sr, win, win // 4, n_mels)
    want = jstft.mel_spectrogram(jnp.asarray(wav), sr, win, win // 4, n_mels)
    _close(got.numpy(), np.asarray(want), f"mel {win}")


@pytest.mark.parametrize("n_fft,hop", [(321, 160), (400, 160)])
def test_stft_constant_pad_matches_jax(wav, n_fft, hop):
    """DNSMOS's features: an odd n_fft, the centered signal zero-padded."""
    got = stft.stft(torch.from_numpy(wav), n_fft, hop, pad_mode="constant")
    want = jstft.stft(jnp.asarray(wav), n_fft, hop, pad_mode="constant")
    _close(got.numpy(), np.asarray(want), "constant pad vs JAX")
    ref = torch.stft(torch.from_numpy(wav), n_fft, hop, n_fft,
                     torch.from_numpy(stft.hann_window(n_fft)), center=True,
                     pad_mode="constant", return_complex=True)
    _close(got.numpy(), ref.numpy(), "constant pad vs torch.stft")


@pytest.mark.parametrize("power", [1.0, 2.0])
def test_mel_spectrogram_power_matches_jax(wav, power):
    """ECAPA's fbank features: the mel of |STFT| ** power."""
    got = stft.mel_spectrogram(torch.from_numpy(wav), 16000, 400, 160, 80, power=power)
    want = jstft.mel_spectrogram(jnp.asarray(wav), 16000, 400, 160, 80, power=power)
    _close(got.numpy(), np.asarray(want), f"mel power {power}")
