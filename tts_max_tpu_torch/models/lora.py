"""LoRA adapters for the SpeechLM (counterpart of ``tts_max_tpu/models/lora.py``).

Adapters are a separate tree mirroring the parameter tree: each targeted
kernel ``[..., in, out]`` gets ``{"a": [..., in, r], "b": [..., r, out]}``,
every other leaf ``None``. Training merges the adapters into the frozen
weights inside the loss, so the model code is unchanged, and takes gradients
with respect to the adapters only. Adapter files are flat ``.npz`` archives
keyed by the "/"-joined parameter path, the JAX package's ``path_str`` keys,
so an adapter written by either package loads into the other.
"""

from __future__ import annotations

import re
from typing import Any, Callable

import numpy as np
import torch

from tts_max_tpu_torch.device import resolve_device

# every attention and MLP projection (the stacked layer kernels)
DEFAULT_TARGET_PATTERN = r"(attn|mlp)/[^/]+/kernel$"


def _is_adapter(x) -> bool:
    return isinstance(x, dict) and set(x) == {"a", "b"}


def _walk(tree, fn, prefix=""):
    """``fn(path, leaf)`` on every leaf of a nested dict, in sorted key order
    (JAX's order for dicts); the result mirrors the tree."""
    if isinstance(tree, dict):
        return {k: _walk(tree[k], fn, f"{prefix}{k}/") for k in sorted(tree)}
    return fn(prefix[:-1], tree)


def adapter_items(lora_params, prefix=""):
    """("layers/attn/wq/kernel/a", tensor) pairs of the adapter tree, in
    sorted key order; ``None`` leaves are skipped, as JAX's flatten skips
    them."""
    if isinstance(lora_params, dict):
        for k in sorted(lora_params):
            yield from adapter_items(lora_params[k], f"{prefix}{k}/")
    elif lora_params is not None:
        yield prefix[:-1], lora_params


def init_lora(params: Any, r: int = 16, target_pattern: str = DEFAULT_TARGET_PATTERN,
              dtype=torch.float32, seed: int = 0, device=None) -> Any:
    """The adapter tree for ``params``: for each kernel whose path matches
    ``target_pattern``, ``a ~ normal * (1/r)`` (JAX's draw, from a
    ``torch.Generator`` seeded with ``seed``, one draw after another in path
    order) and ``b = 0``, so a new adapter changes nothing. On ``device``
    (default: the kernel's)."""
    pattern = re.compile(target_pattern)
    gens: dict = {}

    def one(path, leaf):
        if not pattern.search(path) or leaf.ndim < 2:
            return None
        dev = resolve_device(device) if device is not None else leaf.device
        if dev not in gens:
            gens[dev] = torch.Generator(device=dev).manual_seed(seed)
        *batch, fan_in, fan_out = leaf.shape
        a = (torch.randn((*batch, fan_in, r), generator=gens[dev], device=dev)
             * (1.0 / r)).to(dtype)
        b = torch.zeros((*batch, r, fan_out), dtype=dtype, device=dev)
        return {"a": a, "b": b}

    return _walk(params, one)


def merge(params: Any, lora_params: Any, alpha: float, r: int) -> Any:
    """A new tree: ``p + (alpha/r) * a@b`` on every adapted kernel, the
    product cast to ``p``'s dtype before it is scaled and added, in JAX's
    order; every other leaf as it is. Differentiable in ``a`` and ``b``."""
    scale = alpha / r

    def one(p, lp):
        if isinstance(p, dict):
            return {k: one(v, None if lp is None else lp[k]) for k, v in p.items()}
        if lp is None:
            return p
        return p + scale * torch.matmul(lp["a"], lp["b"]).to(p.dtype)

    return one(params, lora_params)


def trainable_count(lora_params: Any) -> int:
    return sum(t.numel() for _, t in adapter_items(lora_params))


def save_adapter(path: str, lora_params: Any) -> None:
    """A flat ``.npz`` of the adapters, keyed by path (``np.savez``)."""
    np.savez(path, **{k: t.detach().cpu().numpy() for k, t in adapter_items(lora_params)})


def load_adapter(path: str, lora_template: Any) -> Any:
    """The adapters of ``path`` in the template's structure, each on its
    template leaf's device in the dtype stored."""
    with np.load(path) as data:
        def walk(tree, prefix=""):
            if tree is None:
                return None
            if _is_adapter(tree):
                return {k: torch.from_numpy(np.array(data[prefix + k])).to(t.device)
                        for k, t in tree.items()}
            return {k: walk(v, f"{prefix}{k}/") for k, v in tree.items()}

        return walk(lora_template)


def lora_loss_fn(base_params: Any, alpha: float, r: int, loss_fn: Callable) -> Callable:
    """A loss over adapters from a loss over params: the base is detached
    (no leaf of it requires a gradient), so autograd reaches ``a`` and ``b``
    only."""
    base = _walk(base_params, lambda _, t: t.detach())

    def fn(lora_params, *args, **kw):
        return loss_fn(merge(base, lora_params, alpha, r), *args, **kw)

    return fn
