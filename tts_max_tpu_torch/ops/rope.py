"""Rotary position embeddings (counterpart of ``tts_max_tpu/ops/rope.py``).

Tables are built in float64 numpy and cast to fp32, exactly as the JAX
package builds them; rotation runs in fp32. The SpeechLM uses the
half-split convention with Llama-3 frequency scaling, the Vocos backbone the
interleaved-pair convention.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def llama3_scale_freqs(
    freqs: np.ndarray,
    factor: float = 32.0,
    low_freq_factor: float = 1.0,
    high_freq_factor: float = 4.0,
    original_max_position: int = 8192,
) -> np.ndarray:
    """Llama-3.x rope frequency rescaling (HF rope_scaling type 'llama3')."""
    low_freq_wavelen = original_max_position / low_freq_factor
    high_freq_wavelen = original_max_position / high_freq_factor
    wavelen = 2 * math.pi / freqs
    scaled = np.where(wavelen > low_freq_wavelen, freqs / factor, freqs)
    smooth = (original_max_position / wavelen - low_freq_factor) / (
        high_freq_factor - low_freq_factor
    )
    mid = (1 - smooth) * freqs / factor + smooth * freqs
    is_mid = (wavelen <= low_freq_wavelen) & (wavelen >= high_freq_wavelen)
    return np.where(is_mid, mid, scaled)


def rope_table(
    head_dim: int,
    max_len: int,
    theta: float = 10000.0,
    use_llama3_scaling: bool = False,
    device: str | torch.device = "cpu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Return fp32 (cos, sin) tables of shape [max_len, head_dim // 2]."""
    return _rope_table(head_dim, max_len, theta, use_llama3_scaling,
                       torch.device(device))


@functools.lru_cache(maxsize=16)
@torch.inference_mode(False)
def _rope_table(head_dim, max_len, theta, use_llama3_scaling, device):
    # cached: decode asks for the same table on every step. Built outside
    # inference mode even when the first caller runs in it (generate does),
    # so that a training step in the same process may save the table for
    # its backward pass.
    freqs = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    if use_llama3_scaling:
        freqs = llama3_scale_freqs(freqs)
    ang = np.outer(np.arange(max_len, dtype=np.float64), freqs)
    cos = torch.from_numpy(np.cos(ang).astype(np.float32))
    sin = torch.from_numpy(np.sin(ang).astype(np.float32))
    if device.type == "cuda":  # through pinned memory: no host sync
        return (cos.pin_memory().to(device, non_blocking=True),
                sin.pin_memory().to(device, non_blocking=True))
    return cos.to(device), sin.to(device)


def apply_rope(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
    positions: torch.Tensor | None = None,
) -> torch.Tensor:
    """Half-split RoPE on x [..., seq, heads, head_dim] (HF Llama convention).
    ``positions``: optional [batch?, seq] int positions; default arange(seq)."""
    if positions is None:
        seq = x.shape[-3]
        c, s = cos[:seq, None, :], sin[:seq, None, :]
    else:
        c, s = cos[positions][..., None, :], sin[positions][..., None, :]
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def apply_rope_interleaved(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
    positions: torch.Tensor | None = None,
) -> torch.Tensor:
    """Interleaved-pair RoPE (torchtune convention; Vocos backbone)."""
    if positions is None:
        seq = x.shape[-3]
        c, s = cos[:seq, None, :], sin[:seq, None, :]
    else:
        c, s = cos[positions][..., None, :], sin[positions][..., None, :]
    xf = x.float()
    pairs = xf.reshape(*xf.shape[:-1], -1, 2)
    x1, x2 = pairs[..., 0], pairs[..., 1]
    out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.reshape(xf.shape).to(x.dtype)
