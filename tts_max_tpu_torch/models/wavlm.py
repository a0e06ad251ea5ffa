"""WavLM encoder for speaker-similarity features (counterpart of
``tts_max_tpu/models/wavlm.py``).

The WavLM architecture as the JAX module builds it:

- a layer-normed conv feature extractor (7 strided convs, 16 kHz -> 50 Hz);
- feature projection 512 -> 1024;
- a grouped, weight-normed conv positional embedding (k = 128, 16 groups);
- 24 pre-LN transformer layers with WavLM's gated relative position bias:
  one T5-style bucketed bias from layer 0's embedding (the bucket table in
  numpy), modulated in every layer by a per-head gate from that layer's
  normed hidden states;
- ``encode`` returns the 25-entry hidden-state stack the similarity reward
  consumes, the last entry layer-normed; ``lengths`` masks padded frames
  out of attention.

The parameters keep the JAX tree: dense kernels ``[in, out]``, conv kernels
``[K, Cin/groups, Cout]``, the transformer layers stacked on a leading
``L``. Weights load from a local HF ``WavLMModel`` directory through the
port's safetensors reader; ``save_hf_dir`` writes one (the importer's
inverse), for seeded stand-ins of real checkpoints.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from tts_max_tpu_torch.device import resolve_device

Params = Any


@dataclass(frozen=True)
class WavLMConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    ffn_dim: int = 4096
    conv_dim: tuple = field(default=(512,) * 7)
    conv_kernels: tuple = (10, 3, 3, 3, 3, 2, 2)
    conv_strides: tuple = (5, 2, 2, 2, 2, 2, 2)
    num_buckets: int = 320
    max_distance: int = 800
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    layer_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def tiny_wavlm_config() -> WavLMConfig:
    return WavLMConfig(
        hidden_size=32,
        num_layers=3,
        num_heads=4,
        ffn_dim=64,
        conv_dim=(16, 16, 16),
        conv_kernels=(10, 3, 2),
        conv_strides=(5, 2, 2),
        num_buckets=40,
        max_distance=100,
        pos_conv_kernel=16,
        pos_conv_groups=2,
    )


def frame_count(cfg: WavLMConfig, n_samples: int) -> int:
    t = n_samples
    for k, s in zip(cfg.conv_kernels, cfg.conv_strides):
        t = (t - k) // s + 1
    return t


def frame_count_dynamic(cfg: WavLMConfig, n: torch.Tensor) -> torch.Tensor:
    """``frame_count`` of a tensor of sample counts (floor division)."""
    t = n
    for k, s in zip(cfg.conv_kernels, cfg.conv_strides):
        t = torch.div(t - k, s, rounding_mode="floor") + 1
    return t


# --- init ---------------------------------------------------------------------


def init_params(cfg: WavLMConfig, seed: int = 0, dtype=torch.float32, device="cuda") -> Params:
    """Random parameters with the JAX module's distributions (normal *
    fan_in^-1/2 kernels, zero biases, unit layer norms, unit gate
    constants), drawn from a ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    D, F_, L, H = cfg.hidden_size, cfg.ffn_dim, cfg.num_layers, cfg.num_heads

    def dense(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=dev) * fan_in ** -0.5).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def ln(*shape):
        return {"scale": torch.ones(shape, dtype=dtype, device=dev), "bias": zeros(*shape)}

    convs, cin = [], 1
    for cout, k in zip(cfg.conv_dim, cfg.conv_kernels):
        convs.append({"kernel": dense((k, cin, cout), k * cin), "bias": zeros(cout),
                      "ln": ln(cout)})
        cin = cout

    def stacked_dense(shape, fan_in):
        return {"kernel": dense((L,) + shape, fan_in), "bias": zeros(L, shape[-1])}

    g = cfg.pos_conv_groups
    return {
        "convs": convs,
        "proj": {"ln": ln(cfg.conv_dim[-1]),
                 "kernel": dense((cfg.conv_dim[-1], D), cfg.conv_dim[-1]), "bias": zeros(D)},
        "pos_conv": {"kernel": dense((cfg.pos_conv_kernel, D // g, D),
                                     cfg.pos_conv_kernel * D // g),
                     "bias": zeros(D)},
        "rel_attn_embed": dense((cfg.num_buckets, H), cfg.num_buckets),
        "layers": {
            "attn_ln": ln(L, D),
            "q": stacked_dense((D, D), D),
            "k": stacked_dense((D, D), D),
            "v": stacked_dense((D, D), D),
            "out": stacked_dense((D, D), D),
            "gate": stacked_dense((cfg.head_dim, 8), cfg.head_dim),
            "gate_const": torch.ones(L, H, dtype=dtype, device=dev),
            "ffn_ln": ln(L, D),
            "fc1": stacked_dense((D, F_), D),
            "fc2": stacked_dense((F_, D), F_),
        },
        "final_ln": ln(D),
    }


# --- relative position bias (T5-style buckets, HF WavLMAttention semantics) ---


def relative_position_buckets(cfg: WavLMConfig, t: int) -> np.ndarray:
    """[T, T] bucket ids for (query, key) relative positions."""
    nb = cfg.num_buckets // 2
    rel = np.arange(t)[None, :] - np.arange(t)[:, None]  # memory - context
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    is_small = rel < max_exact
    large = (
        max_exact
        + np.log(np.maximum(rel, 1) / max_exact)
        / math.log(cfg.max_distance / max_exact)
        * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return buckets + np.where(is_small, rel, large)


def compute_position_bias(params, cfg: WavLMConfig, t: int) -> torch.Tensor:
    """[H, T, T] shared bias from the layer-0 relative-position embedding."""
    emb = params["rel_attn_embed"]
    buckets = torch.from_numpy(relative_position_buckets(cfg, t)).to(emb.device)
    return emb[buckets].permute(2, 0, 1)


# --- building blocks ------------------------------------------------------------


def _layer_norm(x, p, eps):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def _conv(x, p, stride: int = 1, padding: int = 0, groups: int = 1):
    """Conv over channel-last [B, T, C] with the kernel in x's dtype."""
    y = F.conv1d(x.transpose(1, 2), p["kernel"].to(x.dtype).permute(2, 1, 0), stride=stride,
                 padding=padding, groups=groups).transpose(1, 2)
    return y + p["bias"]


def feature_encoder(params, cfg: WavLMConfig, wav: torch.Tensor) -> torch.Tensor:
    """wav [B, L] -> features [B, T, conv_dim[-1]] (layer-norm conv stack)."""
    x = wav[..., None]
    for p, stride in zip(params["convs"], cfg.conv_strides):
        x = _conv(x, p, stride)
        x = F.gelu(_layer_norm(x, p["ln"], cfg.layer_norm_eps))
    return x


def _pos_conv(params, cfg: WavLMConfig, x: torch.Tensor) -> torch.Tensor:
    k = cfg.pos_conv_kernel
    y = _conv(x, params, padding=k // 2, groups=cfg.pos_conv_groups)
    if k % 2 == 0:  # HF WavLMSamePadLayer trims the trailing frame
        y = y[:, :-1]
    return F.gelu(y)


def _layer(stacked, i: int):
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i]


def encode(params: Params, cfg: WavLMConfig, wav: torch.Tensor,
           lengths: torch.Tensor | None = None) -> torch.Tensor:
    """wav [B, L] (16 kHz) -> hidden-state stack [num_layers+1, B, T, D].

    Entry 0 is the post-positional-conv input to layer 0; entry i is the
    input to layer i; the final entry is the layer-normed output, HF
    ``WavLMModel(..., output_hidden_states=True)``'s order. ``lengths``
    ([B], samples) masks padded frames out of attention.
    """
    D, H, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    feats = feature_encoder(params, cfg, wav)
    x = _layer_norm(feats, params["proj"]["ln"], cfg.layer_norm_eps)
    x = x @ params["proj"]["kernel"] + params["proj"]["bias"]

    frame_mask = None
    if lengths is not None:
        n_frames = frame_count_dynamic(cfg, torch.as_tensor(lengths, device=x.device))
        frame_mask = torch.arange(x.shape[1], device=x.device)[None, :] < n_frames[:, None]
        x = torch.where(frame_mask[..., None], x, 0.0)

    x = x + _pos_conv(params["pos_conv"], cfg, x)
    b, t = x.shape[:2]
    position_bias = compute_position_bias(params, cfg, t)  # [H, T, T]
    scale = hd ** -0.5
    hidden = [x]
    h = x
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        a = _layer_norm(h, lp["attn_ln"], cfg.layer_norm_eps)
        q = (a @ lp["q"]["kernel"] + lp["q"]["bias"]).reshape(b, t, H, hd)
        k = (a @ lp["k"]["kernel"] + lp["k"]["bias"]).reshape(b, t, H, hd)
        v = (a @ lp["v"]["kernel"] + lp["v"]["bias"]).reshape(b, t, H, hd)
        # gated relative position bias (HF WavLMAttention.forward steps 1-4)
        gh = a.reshape(b, t, H, hd)
        gp = (gh @ lp["gate"]["kernel"] + lp["gate"]["bias"]).reshape(b, t, H, 2, 4).sum(-1)
        gate_a, gate_b = torch.sigmoid(gp).split(1, dim=-1)  # [B, T, H, 1] each
        gate = gate_a * (gate_b * lp["gate_const"][None, None, :, None] - 1.0) + 2.0
        gated_bias = gate.permute(0, 2, 1, 3) * position_bias[None]  # [B, H, T, T]
        logits = (torch.einsum("bshd,bthd->bhst", q * scale, k).float()
                  + gated_bias.float())
        if frame_mask is not None:
            logits = torch.where(frame_mask[:, None, None, :], logits, -1e30)
        w = torch.softmax(logits, dim=-1).to(h.dtype)
        o = torch.einsum("bhst,bthd->bshd", w, v).reshape(b, t, D)
        h = h + (o @ lp["out"]["kernel"] + lp["out"]["bias"])
        f = _layer_norm(h, lp["ffn_ln"], cfg.layer_norm_eps)
        f = F.gelu(f @ lp["fc1"]["kernel"] + lp["fc1"]["bias"])
        h = h + (f @ lp["fc2"]["kernel"] + lp["fc2"]["bias"])
        if i < cfg.num_layers - 1:
            hidden.append(h)
    hidden.append(_layer_norm(h, params["final_ln"], cfg.layer_norm_eps))
    return torch.stack(hidden)


# --- HF import ------------------------------------------------------------------


def import_hf_state_dict(sd: Mapping[str, Any], cfg: WavLMConfig, device="cuda",
                         dtype=torch.float32) -> Params:
    """Map an HF ``WavLMModel`` state dict (torch tensors or numpy arrays)
    into the tree (transformer layers stacked), on ``device`` in ``dtype``.
    Reads both the legacy ``weight_g``/``weight_v`` and the
    ``parametrizations`` weight-norm keys of the positional conv."""
    dev = resolve_device(device)

    def a(name):
        for prefix in ("", "wavlm."):
            key = prefix + name
            if key in sd:
                v = sd[key]
                return (v.float() if isinstance(v, torch.Tensor)
                        else torch.from_numpy(np.asarray(v, dtype=np.float32)))
        raise KeyError(name)

    def has(name):
        return name in sd or "wavlm." + name in sd

    def put(t):
        return t.contiguous().to(device=dev, dtype=dtype)

    def stack(fmt, n):
        return put(torch.stack([a(fmt.format(i)) for i in range(n)]))

    def stacked_dense(fmt, n):
        return {"kernel": put(torch.stack([a(fmt.format(i) + ".weight")
                                           for i in range(n)]).transpose(-1, -2)),
                "bias": stack(fmt + ".bias", n)}

    convs = []
    for i in range(len(cfg.conv_dim)):
        base = f"feature_extractor.conv_layers.{i}"
        convs.append({
            # torch conv [out, in, k] -> [k, in, out]
            "kernel": put(a(base + ".conv.weight").permute(2, 1, 0)),
            "bias": (put(a(base + ".conv.bias")) if has(base + ".conv.bias")
                     else torch.zeros(cfg.conv_dim[i], dtype=dtype, device=dev)),
            "ln": {"scale": put(a(base + ".layer_norm.weight")),
                   "bias": put(a(base + ".layer_norm.bias"))},
        })
    proj = {
        "ln": {"scale": put(a("feature_projection.layer_norm.weight")),
               "bias": put(a("feature_projection.layer_norm.bias"))},
        "kernel": put(a("feature_projection.projection.weight").T),
        "bias": put(a("feature_projection.projection.bias")),
    }
    pc = "encoder.pos_conv_embed.conv"
    if has(pc + ".weight_g"):
        g, v = a(pc + ".weight_g").numpy(), a(pc + ".weight_v").numpy()
    else:
        g = a(pc + ".parametrizations.weight.original0").numpy()
        v = a(pc + ".parametrizations.weight.original1").numpy()
    # torch weight norm over dims (0, 1) of [out, in/groups, k], in numpy as JAX computes it
    w = v * (g / np.maximum(np.linalg.norm(v, axis=(0, 1), keepdims=True), 1e-12))
    pos_conv = {"kernel": put(torch.from_numpy(w).permute(2, 1, 0)),
                "bias": put(a(pc + ".bias"))}
    L = cfg.num_layers
    lyr = "encoder.layers.{}."
    layers = {
        "attn_ln": {"scale": stack(lyr + "layer_norm.weight", L),
                    "bias": stack(lyr + "layer_norm.bias", L)},
        "q": stacked_dense(lyr + "attention.q_proj", L),
        "k": stacked_dense(lyr + "attention.k_proj", L),
        "v": stacked_dense(lyr + "attention.v_proj", L),
        "out": stacked_dense(lyr + "attention.out_proj", L),
        "gate": stacked_dense(lyr + "attention.gru_rel_pos_linear", L),
        "gate_const": put(torch.stack([a(f"encoder.layers.{i}.attention.gru_rel_pos_const")
                                       for i in range(L)]).reshape(L, cfg.num_heads)),
        "ffn_ln": {"scale": stack(lyr + "final_layer_norm.weight", L),
                   "bias": stack(lyr + "final_layer_norm.bias", L)},
        "fc1": stacked_dense(lyr + "feed_forward.intermediate_dense", L),
        "fc2": stacked_dense(lyr + "feed_forward.output_dense", L),
    }
    return {
        "convs": convs,
        "proj": proj,
        "pos_conv": pos_conv,
        "rel_attn_embed": put(a("encoder.layers.0.attention.rel_attn_embed.weight")),
        "layers": layers,
        "final_ln": {"scale": put(a("encoder.layer_norm.weight")),
                     "bias": put(a("encoder.layer_norm.bias"))},
    }


def config_from_hf_dir(model_dir: str) -> WavLMConfig:
    with open(os.path.join(model_dir, "config.json")) as f:
        c = json.load(f)
    return WavLMConfig(
        hidden_size=c["hidden_size"],
        num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"],
        ffn_dim=c["intermediate_size"],
        conv_dim=tuple(c["conv_dim"]),
        conv_kernels=tuple(c["conv_kernel"]),
        conv_strides=tuple(c["conv_stride"]),
        num_buckets=c.get("num_buckets", 320),
        max_distance=c.get("max_bucket_distance", 800),
        pos_conv_kernel=c["num_conv_pos_embeddings"],
        pos_conv_groups=c["num_conv_pos_embedding_groups"],
        layer_norm_eps=c.get("layer_norm_eps", 1e-5),
    )


def load_wavlm(model_dir: str, dtype=torch.float32, device="cuda"):
    """(params, cfg) from a local HF WavLM dir."""
    from tts_max_tpu_torch.models.hf_import import _load_hf_state_dict

    cfg = config_from_hf_dir(model_dir)
    sd = _load_hf_state_dict(model_dir)
    return import_hf_state_dict(sd, cfg, device, dtype), cfg


def export_hf_state_dict(params: Params, cfg: WavLMConfig) -> dict[str, torch.Tensor]:
    """The inverse of ``import_hf_state_dict``: HF ``WavLMModel`` names and
    torch layouts; the positional conv as a weight norm (``original0`` the
    norm over dims (0, 1), ``original1`` the weight itself)."""
    sd = {}
    for i, p in enumerate(params["convs"]):
        base = f"feature_extractor.conv_layers.{i}"
        sd[base + ".conv.weight"] = p["kernel"].permute(2, 1, 0)
        sd[base + ".conv.bias"] = p["bias"]
        sd[base + ".layer_norm.weight"] = p["ln"]["scale"]
        sd[base + ".layer_norm.bias"] = p["ln"]["bias"]
    proj = params["proj"]
    sd["feature_projection.layer_norm.weight"] = proj["ln"]["scale"]
    sd["feature_projection.layer_norm.bias"] = proj["ln"]["bias"]
    sd["feature_projection.projection.weight"] = proj["kernel"].T
    sd["feature_projection.projection.bias"] = proj["bias"]
    w = params["pos_conv"]["kernel"].permute(2, 1, 0)  # [out, in/groups, k]
    pc = "encoder.pos_conv_embed.conv"
    sd[pc + ".parametrizations.weight.original0"] = torch.linalg.vector_norm(
        w.float(), dim=(0, 1), keepdim=True).to(w.dtype)
    sd[pc + ".parametrizations.weight.original1"] = w
    sd[pc + ".bias"] = params["pos_conv"]["bias"]
    sd["encoder.layers.0.attention.rel_attn_embed.weight"] = params["rel_attn_embed"]
    lp = params["layers"]
    names = {"q": "attention.q_proj", "k": "attention.k_proj", "v": "attention.v_proj",
             "out": "attention.out_proj", "gate": "attention.gru_rel_pos_linear",
             "fc1": "feed_forward.intermediate_dense", "fc2": "feed_forward.output_dense"}
    for i in range(cfg.num_layers):
        lyr = f"encoder.layers.{i}."
        for ours, hf in names.items():
            sd[lyr + hf + ".weight"] = lp[ours]["kernel"][i].T
            sd[lyr + hf + ".bias"] = lp[ours]["bias"][i]
        sd[lyr + "attention.gru_rel_pos_const"] = lp["gate_const"][i].reshape(1, -1, 1, 1)
        for ours, hf in (("attn_ln", "layer_norm"), ("ffn_ln", "final_layer_norm")):
            sd[lyr + hf + ".weight"] = lp[ours]["scale"][i]
            sd[lyr + hf + ".bias"] = lp[ours]["bias"][i]
    sd["encoder.layer_norm.weight"] = params["final_ln"]["scale"]
    sd["encoder.layer_norm.bias"] = params["final_ln"]["bias"]
    return {k: v.contiguous() for k, v in sd.items()}


def hf_config(cfg: WavLMConfig) -> dict:
    """The ``config.json`` fields ``config_from_hf_dir`` reads."""
    return {"model_type": "wavlm", "hidden_size": cfg.hidden_size,
            "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
            "intermediate_size": cfg.ffn_dim, "conv_dim": list(cfg.conv_dim),
            "conv_kernel": list(cfg.conv_kernels), "conv_stride": list(cfg.conv_strides),
            "num_buckets": cfg.num_buckets, "max_bucket_distance": cfg.max_distance,
            "num_conv_pos_embeddings": cfg.pos_conv_kernel,
            "num_conv_pos_embedding_groups": cfg.pos_conv_groups,
            "layer_norm_eps": cfg.layer_norm_eps}


def save_hf_dir(params: Params, cfg: WavLMConfig, model_dir: str) -> None:
    """``config.json`` and ``model.safetensors`` (the params' dtype) that
    ``load_wavlm`` reads back."""
    from tts_max_tpu_torch.models import safetensors_io

    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(hf_config(cfg), f, indent=1)
    safetensors_io.save_file({k: v.cpu() for k, v in export_hf_state_dict(params, cfg).items()},
                             os.path.join(model_dir, "model.safetensors"))
