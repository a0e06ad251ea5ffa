"""HF Llama checkpoint import/export for the SpeechLM (counterpart of
``tts_max_tpu/models/hf_import.py``).

Reads safetensors (through the port's own ``safetensors_io``) or ``.bin``
shards from a local HF model directory into the stacked-layer parameter
dict of ``models/llama.py``, on the device in ``cfg.dtype`` (norm scales in
fp32); resizes the embedding (and lm_head) to a new vocab with
mean-initialized rows drawn exactly as the JAX package draws them; and
exports back to an HF-format directory for serving interchange; and
writes and loads pre-quantized serving directories (weight-only int8/int4
levels and fp32 scales in ``model.quant.safetensors`` under the flattened
``a/b/c`` names of the parameter tree, the geometry in
``quantized_config.json``), in the JAX package's format, so that each side
loads the other's.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch

from tts_max_tpu_torch import convert
from tts_max_tpu_torch.device import resolve_device
from tts_max_tpu_torch.models import llama, safetensors_io

_QUANT_MANIFEST = "quantized_config.json"
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16"}


def _load_hf_state_dict(model_dir: str) -> dict[str, torch.Tensor]:
    """All tensors of a local HF model dir, as CPU tensors in their stored
    dtype: every ``*.safetensors`` shard in sorted order, else every
    ``*.bin`` shard through ``torch.load(weights_only=True)``."""
    sd: dict[str, torch.Tensor] = {}
    st_files = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
    if st_files:
        for f in st_files:
            sd.update(safetensors_io.load_file(os.path.join(model_dir, f)))
        return sd
    bin_files = sorted(f for f in os.listdir(model_dir) if f.endswith(".bin"))
    if not bin_files:
        raise FileNotFoundError(f"no safetensors/bin weights in {model_dir}")
    for f in bin_files:
        sd.update(torch.load(os.path.join(model_dir, f), map_location="cpu",
                             weights_only=True))
    return sd


def config_from_hf(model_dir: str, **over) -> llama.LlamaConfig:
    """A LlamaConfig from an HF config.json; ``over`` replaces fields (e.g.
    ``dtype``, the compute dtype, bf16 unless given)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        c = json.load(f)
    rope_scaling = c.get("rope_scaling") or {}
    cfg = llama.LlamaConfig(
        vocab_size=c["vocab_size"],
        dim=c["hidden_size"],
        n_layers=c["num_hidden_layers"],
        n_heads=c["num_attention_heads"],
        n_kv_heads=c.get("num_key_value_heads", c["num_attention_heads"]),
        head_dim=c.get("head_dim", c["hidden_size"] // c["num_attention_heads"]),
        ffn_dim=c["intermediate_size"],
        norm_eps=c.get("rms_norm_eps", 1e-5),
        rope_theta=c.get("rope_theta", 10000.0),
        use_llama3_rope_scaling=rope_scaling.get("rope_type") == "llama3",
        max_seq_len=c.get("max_position_embeddings", 2048),
        tie_embeddings=c.get("tie_word_embeddings", False),
    )
    return dataclasses.replace(cfg, **over) if over else cfg


def import_llama(sd: dict[str, torch.Tensor], cfg: llama.LlamaConfig,
                 device="cuda") -> Any:
    """HF Llama state dict -> stacked parameter dict on ``device``: matmul
    kernels (``[in, out]``, the transpose of HF's ``[out, in]``) and the
    embedding in ``cfg.dtype``, norm scales in fp32. HF stores q/k rows in
    the half-split RoPE order ``apply_rope`` uses, so import is
    transposition only."""
    dev = resolve_device(device)

    def g(name: str) -> torch.Tensor:
        for p in ("", "model."):
            if p + name in sd:
                return sd[p + name]
        raise KeyError(name)

    def to(t: torch.Tensor, dtype) -> torch.Tensor:
        return t.to(device=dev, dtype=dtype).contiguous()

    def kernel(fmt: str) -> dict:
        stacked = torch.stack([g(fmt.format(i)).T for i in range(cfg.n_layers)])
        return {"kernel": to(stacked, cfg.dtype)}

    def scale(fmt: str) -> dict:
        return {"scale": to(torch.stack([g(fmt.format(i)) for i in range(cfg.n_layers)]),
                            torch.float32)}

    params: dict[str, Any] = {
        "embed": {"embedding": to(g("embed_tokens.weight"), cfg.dtype)},
        "layers": {
            "attn_norm": scale("layers.{}.input_layernorm.weight"),
            "mlp_norm": scale("layers.{}.post_attention_layernorm.weight"),
            "attn": {
                "wq": kernel("layers.{}.self_attn.q_proj.weight"),
                "wk": kernel("layers.{}.self_attn.k_proj.weight"),
                "wv": kernel("layers.{}.self_attn.v_proj.weight"),
                "wo": kernel("layers.{}.self_attn.o_proj.weight"),
            },
            "mlp": {
                "w_gate": kernel("layers.{}.mlp.gate_proj.weight"),
                "w_up": kernel("layers.{}.mlp.up_proj.weight"),
                "w_down": kernel("layers.{}.mlp.down_proj.weight"),
            },
        },
        "norm": {"scale": to(g("norm.weight"), torch.float32)},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"kernel": to(g("lm_head.weight").T, cfg.dtype)}
    emb = params["embed"]["embedding"]
    if emb.shape != (cfg.vocab_size, cfg.dim):
        raise ValueError(f"embedding {tuple(emb.shape)} does not fit the config "
                         f"({cfg.vocab_size}, {cfg.dim})")
    return params


def export_llama(params: Any, cfg: llama.LlamaConfig) -> dict[str, torch.Tensor]:
    """Inverse of ``import_llama``: HF names and ``[out, in]`` layouts, as
    (transposed) views of the parameters."""
    sd = {
        "model.embed_tokens.weight": params["embed"]["embedding"],
        "model.norm.weight": params["norm"]["scale"],
    }
    lyr = params["layers"]
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}"
        sd[f"{p}.input_layernorm.weight"] = lyr["attn_norm"]["scale"][i]
        sd[f"{p}.post_attention_layernorm.weight"] = lyr["mlp_norm"]["scale"][i]
        for ours, hf in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"),
                         ("wo", "o_proj")):
            sd[f"{p}.self_attn.{hf}.weight"] = lyr["attn"][ours]["kernel"][i].T
        for ours, hf in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                         ("w_down", "down_proj")):
            sd[f"{p}.mlp.{hf}.weight"] = lyr["mlp"][ours]["kernel"][i].T
    if "lm_head" in params:
        sd["lm_head.weight"] = params["lm_head"]["kernel"].T
    return sd


def resize_embeddings(params: Any, cfg: llama.LlamaConfig, new_vocab_size: int,
                      seed: int = 0) -> tuple[Any, llama.LlamaConfig]:
    """Resize the embedding (and lm_head) to ``new_vocab_size``; new rows are
    the mean of the old ones plus 0.02 * standard normals from numpy's
    ``default_rng(seed)``, computed in numpy fp32 in the JAX package's order
    (embedding rows first, then lm_head columns of the ``[D, V]`` kernel,
    laid out as JAX holds it), so the new rows are bitwise equal to JAX's
    when the parameters are fp32. Results keep each tensor's dtype and
    device."""
    emb_t = params["embed"]["embedding"]
    old_v, d = emb_t.shape
    if new_vocab_size == old_v:
        return params, cfg
    rng = np.random.default_rng(seed)
    emb = emb_t.detach().float().cpu().numpy()
    if new_vocab_size > old_v:
        mean = emb.mean(axis=0)
        new_rows = mean[None, :] + rng.standard_normal(
            (new_vocab_size - old_v, d)).astype(emb.dtype) * 0.02
        new_emb = np.concatenate([emb, new_rows], axis=0)
    else:
        new_emb = emb[:new_vocab_size]
    params = dict(params)
    params["embed"] = {"embedding": torch.from_numpy(np.ascontiguousarray(new_emb)).to(
        device=emb_t.device, dtype=emb_t.dtype)}
    if "lm_head" in params:
        head_t = params["lm_head"]["kernel"]  # [D, V]
        # JAX holds the kernel as the transpose of HF's [V, D] array, a
        # Fortran-order view; numpy's mean sums in the order of the layout
        head = np.asfortranarray(head_t.detach().float().cpu().numpy())
        if new_vocab_size > old_v:
            mean = head.mean(axis=1, keepdims=True)
            new_cols = mean + rng.standard_normal(
                (d, new_vocab_size - old_v)).astype(head.dtype) * 0.02
            new_head = np.concatenate([head, new_cols], axis=1)
        else:
            new_head = head[:, :new_vocab_size]
        params["lm_head"] = {"kernel": torch.from_numpy(np.ascontiguousarray(new_head)).to(
            device=head_t.device, dtype=head_t.dtype)}
    return params, dataclasses.replace(cfg, vocab_size=new_vocab_size)


def load_model_from_hf_dir(model_dir: str, vocab_size: int | None = None, device="cuda",
                           **cfg_over) -> tuple[Any, llama.LlamaConfig]:
    """One-call load: config + weights + optional vocab resize, the weights
    on ``device`` in ``cfg.dtype``. A resize draws its rows from the fp32
    weights (as JAX does, which imports fp32) before the cast."""
    cfg = config_from_hf(model_dir, **cfg_over)
    sd = _load_hf_state_dict(model_dir)
    if vocab_size is None or vocab_size == cfg.vocab_size:
        return import_llama(sd, cfg, device), cfg
    fp32 = dataclasses.replace(cfg, dtype=torch.float32)
    params, fp32 = resize_embeddings(import_llama(sd, fp32, "cpu"), fp32, vocab_size)
    cfg = dataclasses.replace(fp32, dtype=cfg.dtype)
    dev = resolve_device(device)

    def cast(tree, key=None):
        if isinstance(tree, dict):
            return {k: cast(v, k) for k, v in tree.items()}
        return tree.to(device=dev, dtype=cfg.dtype if key in ("kernel", "embedding")
                       else torch.float32)

    return cast(params), cfg


def save_model_to_hf_dir(params: Any, cfg: llama.LlamaConfig, output_dir: str,
                         eos_token_id: int | None = None, extra_config: dict | None = None,
                         dtype: torch.dtype = torch.float32) -> None:
    """Serving export: ``model.safetensors`` (every tensor in ``dtype``,
    fp32 by default as the JAX package writes; bf16 as a real HF checkpoint
    stores it) + an HF ``config.json``; ``eos_token_id`` set to
    <|speech_end|> so generation stops at end-of-speech. Tensors are written
    in C order (the JAX package records the bug a transposed view caused)."""
    os.makedirs(output_dir, exist_ok=True)
    sd = {k: v.to(dtype) for k, v in export_llama(params, cfg).items()}
    safetensors_io.save_file(sd, os.path.join(output_dir, "model.safetensors"),
                             metadata={"format": "pt"})
    config = {
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.dim,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim,
        "intermediate_size": cfg.ffn_dim,
        "rms_norm_eps": cfg.norm_eps,
        "rope_theta": cfg.rope_theta,
        "max_position_embeddings": cfg.max_seq_len,
        "tie_word_embeddings": cfg.tie_embeddings,
        "torch_dtype": _DTYPE_NAMES[dtype],
    }
    if cfg.use_llama3_rope_scaling:
        config["rope_scaling"] = {
            "rope_type": "llama3",
            "factor": 32.0,
            "low_freq_factor": 1.0,
            "high_freq_factor": 4.0,
            "original_max_position_embeddings": 8192,
        }
    if eos_token_id is not None:
        config["eos_token_id"] = eos_token_id
    if extra_config:
        config.update(extra_config)
    with open(os.path.join(output_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)


# --- pre-quantized serving dirs -----------------------------------------------
# int8/int4 levels straight from disk: 2x/4x smaller artifacts and loads, and
# no quantization pass at start-up.

_QUANT_WEIGHTS = "model.quant.safetensors"


def _flatten_tree(tree: Any, prefix: str = "") -> dict[str, torch.Tensor]:
    out: dict[str, torch.Tensor] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten_tree(v, f"{prefix}{k}/"))
        return out
    out[prefix[:-1]] = tree
    return out


def _unflatten_tree(flat: dict[str, Any]) -> Any:
    root: dict = {}
    for path, v in flat.items():
        node = root
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def save_quantized_dir(params: Any, cfg: llama.LlamaConfig, output_dir: str,
                       bits: int) -> None:
    """Write a quantized serving dir: the flattened parameter tree (int8
    ``q`` levels, nibble-packed uint8 ``q4`` levels, fp32 scales and norms)
    in ``model.quant.safetensors`` and the geometry in
    ``quantized_config.json``."""
    os.makedirs(output_dir, exist_ok=True)
    safetensors_io.save_file(_flatten_tree(params), os.path.join(output_dir, _QUANT_WEIGHTS),
                             metadata={"format": "np"})
    manifest = {
        "bits": bits,
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.dim,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim,
        "intermediate_size": cfg.ffn_dim,
        "rms_norm_eps": cfg.norm_eps,
        "rope_theta": cfg.rope_theta,
        "max_position_embeddings": cfg.max_seq_len,
        "tie_word_embeddings": cfg.tie_embeddings,
        "use_llama3_rope_scaling": cfg.use_llama3_rope_scaling,
    }
    with open(os.path.join(output_dir, _QUANT_MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)


def is_quantized_dir(model_dir: str) -> bool:
    return os.path.exists(os.path.join(model_dir, _QUANT_MANIFEST))


def load_quantized_dir(model_dir: str, device="cuda", **cfg_over
                       ) -> tuple[Any, llama.LlamaConfig]:
    """(params on ``device``, cfg) of a quantized serving dir: the levels
    as stored (int8, uint8), scales and norms in fp32, any unquantized
    kernel in ``cfg.dtype``; ``cfg_over`` replaces config fields (e.g. the
    compute ``dtype``)."""
    with open(os.path.join(model_dir, _QUANT_MANIFEST)) as f:
        m = json.load(f)
    cfg = llama.LlamaConfig(
        vocab_size=m["vocab_size"],
        dim=m["hidden_size"],
        n_layers=m["num_hidden_layers"],
        n_heads=m["num_attention_heads"],
        n_kv_heads=m["num_key_value_heads"],
        head_dim=m["head_dim"],
        ffn_dim=m["intermediate_size"],
        norm_eps=m["rms_norm_eps"],
        rope_theta=m["rope_theta"],
        max_seq_len=m["max_position_embeddings"],
        tie_embeddings=m["tie_word_embeddings"],
        use_llama3_rope_scaling=m["use_llama3_rope_scaling"],
    )
    if cfg_over:
        cfg = dataclasses.replace(cfg, **cfg_over)
    flat = safetensors_io.load_file(os.path.join(model_dir, _QUANT_WEIGHTS))
    tree = _unflatten_tree({k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
                            for k, v in flat.items()})
    return convert.llama_from_numpy(tree, cfg, device), cfg


def load_serving_model(model_dir: str, device="cuda", **cfg_over
                       ) -> tuple[Any, llama.LlamaConfig]:
    """Load either a quantized serving dir or a standard HF dir, on
    ``device``; ``cfg_over`` replaces config fields (e.g. ``dtype``)."""
    if is_quantized_dir(model_dir):
        return load_quantized_dir(model_dir, device=device, **cfg_over)
    return load_model_from_hf_dir(model_dir, device=device, **cfg_over)
