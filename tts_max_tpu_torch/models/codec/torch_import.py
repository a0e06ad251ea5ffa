"""xcodec2 torch checkpoints -> the port's codec parameters (counterpart of
``tts_max_tpu/models/codec/torch_import.py``).

Maps the prefix-filtered state dict into the channel-last parameter trees
of ``encoder.py`` and ``vocos.py``:

- ``CodecEnc.*``               -> acoustic encoder
- ``SemanticEncoder_module.*`` -> semantic encoder
- ``fc_prior.*``               -> fusion linear
- ``generator.quantizer.*``    -> FSQ project_in / project_out
- ``generator.backbone.*``     -> Vocos backbone (embed/prior/transformers/post)
- ``generator.head.*``         -> ISTFT head
- ``fc_post_a.*``              -> post-FSQ linear

Weight norm (``weight_g``/``weight_v``, or the newer
``parametrizations.weight.original0``/``original1``) is fused into plain
weights, and layouts are transposed: Conv1d [Cout, Cin, K] -> [K, Cin,
Cout], ConvTranspose1d [Cin, Cout, K] -> [K, Cout, Cin], Linear [out, in]
-> [in, out]. The trees are built in numpy and handed to ``convert``, which
returns fp32 tensors on ``device``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from tts_max_tpu_torch import convert
from tts_max_tpu_torch.models.codec.encoder import EncoderConfig
from tts_max_tpu_torch.models.codec.vocos import VocosConfig


def _np(x) -> np.ndarray:
    return x if isinstance(x, np.ndarray) else x.detach().cpu().numpy()


def load_torch_checkpoint(path: str) -> dict[str, np.ndarray]:
    """A torch file of a state dict (or of ``{"state_dict": ...}`` /
    ``{"model": ...}``) -> name -> numpy array."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    elif "model" in ckpt:
        ckpt = ckpt["model"]
    return {k: _np(v) for k, v in ckpt.items()}


def filter_prefix(sd: Mapping, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def fuse_weight_norm(sd: Mapping, base: str) -> np.ndarray:
    """The effective weight of ``base``: plain, or weight norm (dim 0)
    fused in float64."""
    if f"{base}.weight" in sd:
        return _np(sd[f"{base}.weight"])
    for g_key, v_key in ((f"{base}.weight_g", f"{base}.weight_v"),
                         (f"{base}.parametrizations.weight.original0",
                          f"{base}.parametrizations.weight.original1")):
        if g_key in sd:
            g = _np(sd[g_key]).astype(np.float64)
            v = _np(sd[v_key]).astype(np.float64)
            norm = np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
            return (g * v / norm).astype(np.float32)
    raise KeyError(f"no weight found for {base} (tried .weight, weight_g/v)")


def conv_params(sd, base: str) -> dict[str, np.ndarray]:
    """Conv1d [Cout, Cin, K] (or ConvTranspose1d [Cin, Cout, K]) ->
    {"kernel": [K, Cin, Cout] (or [K, Cout, Cin]), "bias"?}."""
    p = {"kernel": np.transpose(fuse_weight_norm(sd, base), (2, 1, 0)).astype(np.float32)}
    if f"{base}.bias" in sd:
        p["bias"] = _np(sd[f"{base}.bias"]).astype(np.float32)
    return p


def linear_params(sd, base: str) -> dict[str, np.ndarray]:
    """Linear [out, in] -> {"kernel": [in, out], "bias"?}."""
    p = {"kernel": _np(sd[f"{base}.weight"]).T.astype(np.float32)}
    if f"{base}.bias" in sd:
        p["bias"] = _np(sd[f"{base}.bias"]).astype(np.float32)
    return p


def norm_params(sd, base: str) -> dict[str, np.ndarray]:
    return {"scale": _np(sd[f"{base}.weight"]).astype(np.float32),
            "bias": _np(sd[f"{base}.bias"]).astype(np.float32)}


def snake_params(sd, base: str) -> dict[str, np.ndarray]:
    """Activation1d(SnakeBeta) at ``base`` -> {"alpha", "beta"}."""
    return {"alpha": _np(sd[f"{base}.act.alpha"]).astype(np.float32),
            "beta": _np(sd[f"{base}.act.beta"]).astype(np.float32)}


def fsq_params(sd, base: str = "") -> dict[str, Any]:
    pre = f"{base}." if base else ""
    return {"project_in": linear_params(sd, f"{pre}project_in"),
            "project_out": linear_params(sd, f"{pre}project_out")}


def resnet_params(sd, base: str) -> dict[str, Any]:
    p = {"norm1": norm_params(sd, f"{base}.norm1"), "conv1": conv_params(sd, f"{base}.conv1"),
         "norm2": norm_params(sd, f"{base}.norm2"), "conv2": conv_params(sd, f"{base}.conv2")}
    if f"{base}.nin_shortcut.weight" in sd or f"{base}.nin_shortcut.weight_g" in sd:
        p["nin_shortcut"] = conv_params(sd, f"{base}.nin_shortcut")
    return p


# --- decoder ----------------------------------------------------------------------


def import_decoder(sd: Mapping, cfg: VocosConfig, device="cuda") -> dict[str, Any]:
    """Full xcodec2 state dict -> ``vocos.init_decoder``-shaped parameters
    on ``device`` (``cfg.depth`` transformer layers, an upsampler when
    ``cfg.upsample_factors`` is set)."""
    gen = (filter_prefix(sd, "generator.") if any(k.startswith("generator.") for k in sd)
           else dict(sd))
    bb = "backbone"

    def stack(name):
        return np.stack([_np(gen[f"{bb}.transformers.{i}.{name}"]) for i in range(cfg.depth)])

    def stack_t(name):
        return np.stack([_np(gen[f"{bb}.transformers.{i}.{name}"]).T for i in range(cfg.depth)])

    blocks = {
        "att_norm": {"scale": stack("att_norm.weight")},
        "ffn_norm": {"scale": stack("ffn_norm.weight")},
        "att": {"c_attn": {"kernel": stack_t("att.c_attn.weight")},
                "c_proj": {"kernel": stack_t("att.c_proj.weight")}},
        "mlp": {"fc1": {"kernel": stack_t("mlp.fc1.weight")},
                "fc2": {"kernel": stack_t("mlp.fc2.weight")}},
    }
    params: dict[str, Any] = {
        "quantizer": fsq_params(gen, "quantizer"),
        "fc_post_a": linear_params(sd if "fc_post_a.weight" in sd else gen, "fc_post_a"),
        "backbone": {
            "embed": conv_params(gen, f"{bb}.embed"),
            "prior": [resnet_params(gen, f"{bb}.prior_net.{i}") for i in range(2)],
            "blocks": blocks,
            "post": [resnet_params(gen, f"{bb}.post_net.{i}") for i in range(2)],
            "final_norm": norm_params(gen, f"{bb}.final_layer_norm"),
        },
        "head": {"out": linear_params(gen, "head.out")},
    }
    if cfg.upsample_factors:
        ups = filter_prefix(sd, "upsampler.")
        params["upsampler"] = {
            "layers": [{"up": conv_params(ups, f"upsample_layers.{i}"),
                        "resnet": resnet_params(ups, f"resnet_blocks.{i}")}
                       for i in range(len(cfg.upsample_factors))],
            "out_proj": linear_params(ups, "out_proj"),
        }
    return convert.vocos_from_numpy(params, cfg, device=device)


# --- encoder ----------------------------------------------------------------------


def _encoder_block_params(sd, base: str, n_units: int) -> dict[str, Any]:
    """EncoderBlock.block = Sequential(ResidualUnit x n_units, Act1d,
    strided conv); ResidualUnit.block = Sequential(Act1d, conv, Act1d,
    1x1 conv)."""
    return {
        "units": [{"act1": snake_params(sd, f"{base}.block.{i}.block.0"),
                   "conv1": conv_params(sd, f"{base}.block.{i}.block.1"),
                   "act2": snake_params(sd, f"{base}.block.{i}.block.2"),
                   "conv2": conv_params(sd, f"{base}.block.{i}.block.3")}
                  for i in range(n_units)],
        "act": snake_params(sd, f"{base}.block.{n_units}"),
        "down": conv_params(sd, f"{base}.block.{n_units + 1}"),
    }


def import_encoder(sd: Mapping, cfg: EncoderConfig, device="cuda") -> dict[str, Any]:
    """Full xcodec2 state dict -> ``encoder.init_encoder``-shaped parameters
    on ``device`` (one block per ``cfg.up_ratios`` entry, one residual unit
    per ``cfg.dilations`` entry)."""
    ac = filter_prefix(sd, "CodecEnc.")
    se = filter_prefix(sd, "SemanticEncoder_module.")
    n_units = len(cfg.dilations)
    params = {
        "acoustic": {
            "initial": conv_params(ac, "conv_blocks.0"),
            "blocks": [_encoder_block_params(ac, f"conv_blocks.{i + 1}", n_units)
                       for i in range(len(cfg.up_ratios))],
            "final_act": snake_params(ac, "conv_final_block.0"),
            "final": conv_params(ac, "conv_final_block.1"),
        },
        "semantic": {
            "initial": conv_params(se, "initial_conv"),
            "res1": conv_params(se, "residual_blocks.1"),
            "res2": conv_params(se, "residual_blocks.3"),
            "final": conv_params(se, "final_conv"),
        },
        "fusion": linear_params(sd, "fc_prior"),
        "quantizer": fsq_params(filter_prefix(sd, "generator.quantizer.")),
    }
    return convert.encoder_from_numpy(params, cfg, device=device)
