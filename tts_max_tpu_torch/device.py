"""Device resolution for the port's entry points.

Entry points take ``device="cuda"`` by default. Asking for CUDA on a machine
without a usable GPU raises: nothing falls back to the CPU silently. The CPU
runs the plain PyTorch versions of the kernels only when the caller asks for
it with ``device="cpu"`` (the tests do).
"""

from __future__ import annotations

import functools

import numpy as np
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


def full_fp32() -> None:
    """Full fp32 for fp32 matmuls and cuDNN convolutions, for the whole
    process. PyTorch lets cuDNN run fp32 convolutions in TF32 (about three
    decimal digits) by default; the codec is fp32 like the JAX package's,
    so its entry points (``AudioEncoder``, ``AudioDecoder``) call this once,
    when they are built."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_device_async(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device``: on the card through pinned memory, so
    that the copy does not wait for the host (no sync); on the CPU as is."""
    return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t


def cached_constant(make):
    """``make(*key)`` (a numpy array or a host tensor) as a function
    ``(device, *key) -> tensor on device``, made once for each device and
    key: outside inference mode, so that a training step may save it for
    its backward, and copied with ``to_device_async``."""

    @functools.lru_cache(maxsize=64)
    @torch.inference_mode(False)
    def get(device: torch.device, *key) -> torch.Tensor:
        a = make(*key)
        t = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
        return to_device_async(t, device)

    return get
