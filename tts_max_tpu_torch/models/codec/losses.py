"""GAN training losses for the codec decoder (counterpart of
``tts_max_tpu/models/codec/losses.py``): LSGAN adversarial terms, the
7-resolution log10-mel L1, spectral convergence plus log magnitude (the
STFT loss), feature matching and the RMS-dB match. The weights live in
``CodecTrainingConfig`` (λ_mel 15, the others 1).
"""

from __future__ import annotations

import torch

from tts_max_tpu_torch.ops.stft import mel_spectrogram, stft

MEL_N_MELS = (5, 10, 20, 40, 80, 160, 320)
MEL_WINDOWS = (32, 64, 128, 256, 512, 1024, 2048)


def disc_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor):
    return ((real_logits - 1.0) ** 2).mean(), (fake_logits ** 2).mean()


def gen_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    return ((fake_logits - 1.0) ** 2).mean()


def multi_resolution_mel_loss(x: torch.Tensor, y: torch.Tensor, sample_rate: int = 16000,
                              clamp_eps: float = 1e-5) -> torch.Tensor:
    """L1 between log10 mel spectrograms at 7 resolutions; x, y: [B, T]."""
    loss = 0.0
    for n_mels, win in zip(MEL_N_MELS, MEL_WINDOWS):
        lx = torch.log10(torch.clamp_min(mel_spectrogram(x, sample_rate, win, win // 4,
                                                         n_mels), clamp_eps))
        ly = torch.log10(torch.clamp_min(mel_spectrogram(y, sample_rate, win, win // 4,
                                                         n_mels), clamp_eps))
        loss = loss + (lx - ly).abs().mean()
    return loss


def stft_loss(x: torch.Tensor, y: torch.Tensor, fft_size: int, hop_size: int,
              win_size: int) -> torch.Tensor:
    xm = stft(x, fft_size, hop_size, win_size).abs()
    ym = stft(y, fft_size, hop_size, win_size).abs()
    sc = torch.linalg.vector_norm(ym - xm) / torch.clamp_min(torch.linalg.vector_norm(ym),
                                                             1e-9)
    mag = (torch.log(xm + 1e-7) - torch.log(ym + 1e-7)).abs().mean()
    return sc + mag


def multi_resolution_stft_loss(x: torch.Tensor, y: torch.Tensor, fft_sizes=(1024, 2048, 512),
                               hop_sizes=(120, 240, 50),
                               win_sizes=(600, 1200, 240)) -> torch.Tensor:
    losses = [stft_loss(x, y, f, h, w) for f, h, w in zip(fft_sizes, hop_sizes, win_sizes)]
    return sum(losses) / len(losses)


def rms_loss(y_true: torch.Tensor, y_gen: torch.Tensor) -> torch.Tensor:
    """Squared dB difference of per-track RMS."""
    db_t = 20 * torch.log10(torch.sqrt((y_true ** 2).mean(-1)) + 1e-10)
    db_g = 20 * torch.log10(torch.sqrt((y_gen ** 2).mean(-1)) + 1e-10)
    return ((db_g - db_t) ** 2).mean()


def feature_matching_loss(feats_gen, feats_true) -> torch.Tensor:
    """Sum of L1 over every intermediate layer (final logits excluded) of
    every sub-discriminator."""
    loss = 0.0
    for dg, dt in zip(feats_gen, feats_true):
        for g, t in zip(dg[:-1], dt[:-1]):
            loss = loss + (g - t).abs().mean()
    return loss


def adversarial_loss(feats_gen) -> torch.Tensor:
    """Sum of LSGAN generator losses over each sub-discriminator's logits."""
    loss = 0.0
    for d in feats_gen:
        loss = loss + gen_loss(d[-1])
    return loss


def discriminator_loss(feats_true, feats_gen) -> torch.Tensor:
    """Sum of real + fake LSGAN losses over each sub-discriminator's logits."""
    loss = 0.0
    for dt, dg in zip(feats_true, feats_gen):
        r, f = disc_loss(dt[-1], dg[-1])
        loss = loss + r + f
    return loss
