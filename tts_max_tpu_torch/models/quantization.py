"""Int8 quantization of KV-cache rows (counterpart of the int8 path of
``tts_max_tpu/models/quantization.py``'s ``quantize_tensor``).

Weight-only int8/int4 for serving is not ported yet.
"""

from __future__ import annotations

import torch


def quantize_tensor(w: torch.Tensor, axis: int) -> dict[str, torch.Tensor]:
    """Symmetric int8, reducing only over ``axis``: ``{"q": int8 like w,
    "scale": f32 with ``axis`` removed}``. Bitwise equal to the JAX
    package's ``quantize_tensor(w, axis, bits=8)`` (fp32 division,
    round-half-to-even)."""
    w32 = w.float()
    amax = w32.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(amax / 127.0, 1e-12)
    q = torch.clamp(torch.round(w32 / scale), -127.0, 127.0)
    return {"q": q.to(torch.int8), "scale": scale.squeeze(axis)}
