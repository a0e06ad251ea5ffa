"""Normalization ops (counterpart of ``tts_max_tpu/ops/norms.py``).
Computed in fp32, cast back to the input dtype."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm (the SpeechLM and the Vocos backbone)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (y * scale.float()).to(x.dtype)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.reciprocal(torch.sqrt(var + eps))
    return (y * scale.float() + bias.float()).to(x.dtype)


def group_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float = 1e-6,
) -> torch.Tensor:
    """GroupNorm over channel-last [B, T, C]: statistics per (batch, group)
    over all positions and the group's channels (torch semantics)."""
    xf = x.float()
    b, t, c = xf.shape
    g = xf.reshape(b, t, num_groups, c // num_groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = (g - mean).square().mean(dim=(1, 3), keepdim=True)
    g = (g - mean) * torch.reciprocal(torch.sqrt(var + eps))
    y = g.reshape(b, t, c)
    return (y * scale.float() + bias.float()).to(x.dtype)
