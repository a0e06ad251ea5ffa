"""Device resolution for the port's entry points.

Entry points take ``device="cuda"`` by default. Asking for CUDA on a machine
without a usable GPU raises: nothing falls back to the CPU silently. The CPU
runs the plain PyTorch versions of the kernels only when the caller asks for
it with ``device="cpu"`` (the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch.device for ``device``; "cuda" without an index becomes the
    current card ("cuda:0"), so that it compares equal to a tensor's device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    return dev if dev.index is not None else torch.device(
        "cuda", torch.cuda.current_device())
