"""Finite Scalar Quantization (counterpart of
``tts_max_tpu/models/codec/fsq.py``): a Linear dim→8 projection, per-dim
tanh bounding and rounding to one of 4 levels (``encode``), mixed-radix
indices over the 8 dims (a 65536-entry codebook), and normalized codes →
Linear 8→dim (``decode_indices``).

Params: ``{"project_in": {"kernel": [dim, 8], "bias": [8]},
"project_out": {"kernel": [8, dim], "bias": [dim]}}`` (the decoder reads
only ``project_out``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tts_max_tpu_torch.core.constants import FSQ_LEVELS
from tts_max_tpu_torch.device import cached_constant


@dataclass(frozen=True)
class FSQConfig:
    levels: tuple[int, ...] = FSQ_LEVELS
    dim: int = 2048
    eps: float = 1e-3  # bound epsilon (encoder side)

    @property
    def codebook_dim(self) -> int:
        return len(self.levels)

    @property
    def codebook_size(self) -> int:
        return int(np.prod(self.levels))


def _basis(cfg: FSQConfig) -> np.ndarray:
    return np.concatenate([[1], np.cumprod(cfg.levels[:-1])]).astype(np.int64)


def init_params(cfg: FSQConfig, gen: torch.Generator, device) -> dict:
    """project_in / project_out: normal * fan_in^-1/2 kernels, zero biases,
    drawn from ``gen`` on ``device``."""
    d, cd = cfg.dim, cfg.codebook_dim
    return {
        "project_in": {
            "kernel": torch.randn(d, cd, generator=gen, device=device) * d ** -0.5,
            "bias": torch.zeros(cd, device=device)},
        "project_out": {
            "kernel": torch.randn(cd, d, generator=gen, device=device) * cd ** -0.5,
            "bias": torch.zeros(d, device=device)},
    }


# a small constant (values, dtype) on a device, made once
_on = cached_constant(lambda values, dtype: torch.tensor(values, dtype=dtype))


def bound(z: torch.Tensor, cfg: FSQConfig) -> torch.Tensor:
    """tanh-bound each dim into its level range (FSQ paper eq. 4)."""
    levels = _on(z.device, tuple(cfg.levels), torch.float32)
    half_l = (levels - 1) * (1 + cfg.eps) / 2
    offset = torch.where(levels % 2 == 0, 0.5, 0.0)
    shift = torch.atanh(offset / half_l)
    return torch.tanh(z + shift) * half_l - offset


def quantize_codes(z: torch.Tensor, cfg: FSQConfig) -> torch.Tensor:
    """z [..., codebook_dim] -> normalized quantized codes in [-1, 1].
    ``torch.round`` rounds half to even, as ``jnp.round`` does; the sum
    ``bounded + (rounded - bounded)`` is the JAX package's straight-through
    form, kept for its rounding."""
    bounded = bound(z, cfg)
    quantized = bounded + (torch.round(bounded) - bounded)
    half_width = _on(z.device, tuple(cfg.levels), torch.float32) // 2
    return quantized / half_width


def codes_to_indices(codes: torch.Tensor, cfg: FSQConfig) -> torch.Tensor:
    """Normalized codes [..., cd] -> int32 indices [...], through a float
    sum that is rounded (as the JAX package computes them)."""
    half_width = _on(codes.device, tuple(cfg.levels), torch.float32) // 2
    digits = codes * half_width + half_width  # in [0, level-1]
    basis = _on(codes.device, tuple(_basis(cfg).tolist()), torch.float32)
    return torch.round(torch.sum(digits * basis, dim=-1)).to(torch.int32)


def encode(params, x: torch.Tensor, cfg: FSQConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., dim] -> (quantized_out [..., dim], indices [...] int32)."""
    pin = params["project_in"]
    z = x @ pin["kernel"] + pin["bias"]
    codes = quantize_codes(z.float(), cfg)
    indices = codes_to_indices(codes, cfg)
    pout = params["project_out"]
    return codes.to(x.dtype) @ pout["kernel"] + pout["bias"], indices


def indices_to_codes(indices: torch.Tensor, cfg: FSQConfig) -> torch.Tensor:
    """Integer indices [...] -> normalized codes [..., codebook_dim] in [-1, 1]."""
    basis = _on(indices.device, tuple(_basis(cfg).tolist()), torch.int64)
    levels = _on(indices.device, tuple(cfg.levels), torch.int64)
    digits = (indices.long()[..., None] // basis) % levels
    half_width = (levels // 2).float()
    return (digits.float() - half_width) / half_width


def decode_indices(params, indices: torch.Tensor, cfg: FSQConfig) -> torch.Tensor:
    """indices [...] -> embeddings [..., dim]."""
    pout = params["project_out"]
    return indices_to_codes(indices, cfg) @ pout["kernel"] + pout["bias"]
