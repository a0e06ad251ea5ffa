"""Carry the JAX package's parameters across to the port.

Both functions take the JAX parameter pytree as nested dicts (and lists) of
numpy arrays — e.g. ``jax.tree_util.tree_map(np.asarray, params)`` made by
the caller — so the port itself never sees JAX. The port keeps the JAX
names and layouts (dense kernels ``[in, out]``, layers stacked on a leading
``L``, conv kernels ``[K, Cin, Cout]``, the Vocos ``c_attn`` fused qkv, the
tied embedding as LM head), so converting is a copy to ``device`` in the
right dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from tts_max_tpu_torch.device import resolve_device
from tts_max_tpu_torch.models.codec.vocos import VocosConfig
from tts_max_tpu_torch.models.llama import LlamaConfig


def _tree(tree, leaf, key=None):
    if isinstance(tree, dict):
        if "q" in tree or "q4" in tree:
            raise NotImplementedError("quantized weights are not ported yet")
        return {k: _tree(v, leaf, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v, leaf, key) for v in tree]
    return leaf(np.asarray(tree), key)


def llama_from_numpy(tree, cfg: LlamaConfig, device="cuda"):
    """SpeechLM parameters: matmul kernels and the embedding in
    ``cfg.dtype``, norm scales in fp32."""
    dev = resolve_device(device)

    def leaf(a, key):
        dtype = cfg.dtype if key in ("kernel", "embedding") else torch.float32
        return torch.from_numpy(a.astype(np.float32)).to(device=dev, dtype=dtype)

    params = _tree(tree, leaf)
    emb = params["embed"]["embedding"]
    if emb.shape != (cfg.vocab_size, cfg.dim):
        raise ValueError(f"embedding {tuple(emb.shape)} does not fit the config")
    if cfg.tie_embeddings == ("lm_head" in params):
        raise ValueError("tie_embeddings disagrees with the presence of lm_head")
    return params


def vocos_from_numpy(tree, cfg: VocosConfig, device="cuda"):
    """Codec decoder parameters, all fp32."""
    dev = resolve_device(device)
    params = _tree(
        tree, lambda a, key: torch.from_numpy(a.astype(np.float32)).to(dev)
    )
    if params["fc_post_a"]["kernel"].shape != (cfg.vq_dim, cfg.hidden_dim):
        raise ValueError("fc_post_a does not fit the config")
    return params
