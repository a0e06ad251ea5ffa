"""Finite Scalar Quantization, decode side (counterpart of
``tts_max_tpu/models/codec/fsq.py``): mixed-radix indices over 8 dims of 4
levels (a 65536-entry codebook) -> normalized codes -> Linear 8→dim.

Params: ``{"project_out": {"kernel": [8, dim], "bias": [dim]}}`` (the
encoder's ``project_in`` is not used here).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tts_max_tpu_torch.core.constants import FSQ_LEVELS


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


def indices_to_codes(indices: torch.Tensor, cfg: FSQConfig) -> torch.Tensor:
    """Integer indices [...] -> normalized codes [..., codebook_dim] in [-1, 1]."""
    basis = torch.as_tensor(_basis(cfg), device=indices.device)
    levels = torch.as_tensor(cfg.levels, dtype=torch.int64, device=indices.device)
    digits = (indices.long()[..., None] // basis) % levels
    half_width = (levels // 2).float()
    return (digits.float() - half_width) / half_width


def decode_indices(params, indices: torch.Tensor, cfg: FSQConfig) -> torch.Tensor:
    """indices [...] -> embeddings [..., dim]."""
    pout = params["project_out"]
    return indices_to_codes(indices, cfg) @ pout["kernel"] + pout["bias"]
