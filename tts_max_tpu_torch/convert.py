"""Carry the JAX package's parameters across to the port.

Each function takes the JAX parameter pytree as nested dicts (and lists) of
numpy arrays — e.g. ``jax.tree_util.tree_map(np.asarray, params)`` made by
the caller — so the port itself never sees JAX. The port keeps the JAX
names and layouts (dense kernels ``[in, out]``, layers stacked on a leading
``L``, conv kernels ``[K, Cin, Cout]``, the Vocos ``c_attn`` fused qkv, the
tied embedding as LM head), so converting is a copy to ``device`` in the
right dtype. The RLHF reward models (Whisper, WavLM, ECAPA) keep the JAX
trees too (conv kernels ``[K, Cin, Cout]``, transformer layers stacked), so
their converters are fp32 copies with a shape check.
"""

from __future__ import annotations

import numpy as np
import torch

from tts_max_tpu_torch.device import resolve_device
from tts_max_tpu_torch.models.codec.discriminator import MPDConfig, MSDConfig
from tts_max_tpu_torch.models.codec.encoder import EncoderConfig
from tts_max_tpu_torch.models.codec.vocos import VocosConfig
from tts_max_tpu_torch.models.codec.w2vbert import W2VBertConfig
from tts_max_tpu_torch.models.wavlm import WavLMConfig
from tts_max_tpu_torch.models.whisper import WhisperConfig
from tts_max_tpu_torch.models import llama
from tts_max_tpu_torch.models.llama import LlamaConfig


def _tree(tree, leaf, key=None):
    if isinstance(tree, dict):
        return {k: _tree(v, leaf, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v, leaf, key) for v in tree]
    return leaf(np.asarray(tree), key)


# the integer levels of quantized leaves (models/quantization.py), kept as they are
_LEVELS = {"q": np.int8, "q4": np.uint8}


def llama_from_numpy(tree, cfg: LlamaConfig, device="cuda"):
    """SpeechLM parameters: matmul kernels and the embedding in
    ``cfg.dtype``, norm scales in fp32; quantized leaves carried across as
    int8 ``q`` and nibble-packed uint8 ``q4`` levels with fp32 scales."""
    dev = resolve_device(device)

    def leaf(a, key):
        if key in _LEVELS:
            if a.dtype != _LEVELS[key]:
                raise ValueError(f"quantized levels {key!r} are {a.dtype}, not "
                                 f"{np.dtype(_LEVELS[key])}")
            return torch.from_numpy(np.array(a)).to(dev)
        dtype = cfg.dtype if key in ("kernel", "embedding") else torch.float32
        return torch.from_numpy(a.astype(np.float32)).to(device=dev, dtype=dtype)

    params = _tree(tree, leaf)
    shape = llama.embedding_shape(params)
    if shape != (cfg.vocab_size, cfg.dim):
        raise ValueError(f"embedding {shape} does not fit the config")
    if cfg.tie_embeddings == ("lm_head" in params):
        raise ValueError("tie_embeddings disagrees with the presence of lm_head")
    return params


def _fp32(tree, device):
    dev = resolve_device(device)
    return _tree(tree, lambda a, key: torch.from_numpy(a.astype(np.float32)).to(dev))


def _check(what: str, got: torch.Tensor, want: tuple) -> None:
    if tuple(got.shape) != want:
        raise ValueError(f"{what} {tuple(got.shape)} does not fit the config {want}")


def vocos_from_numpy(tree, cfg: VocosConfig, device="cuda"):
    """Codec decoder parameters, all fp32."""
    params = _fp32(tree, device)
    _check("fc_post_a kernel", params["fc_post_a"]["kernel"], (cfg.vq_dim, cfg.hidden_dim))
    return params


def encoder_from_numpy(tree, cfg: EncoderConfig, device="cuda"):
    """Codec encoder parameters (acoustic, semantic, fusion, quantizer), all
    fp32."""
    params = _fp32(tree, device)
    ac = params["acoustic"]
    _check("acoustic initial kernel", ac["initial"]["kernel"],
           (cfg.initial_conv_kernel_size, 1, cfg.num_generator_features))
    if len(ac["blocks"]) != len(cfg.up_ratios):
        raise ValueError(f"{len(ac['blocks'])} encoder blocks, config has "
                         f"{len(cfg.up_ratios)}")
    d = cfg.num_generator_features * 2 ** len(cfg.up_ratios)
    _check("acoustic final kernel", ac["final"]["kernel"],
           (cfg.final_conv_kernel_size, d, cfg.acoustic_dim))
    _check("semantic initial kernel", params["semantic"]["initial"]["kernel"],
           (cfg.semantic_kernel_size, cfg.semantic_input_dim, cfg.semantic_dim))
    _check("fusion kernel", params["fusion"]["kernel"], (cfg.fused_dim, cfg.fused_dim))
    _check("project_in kernel", params["quantizer"]["project_in"]["kernel"],
           (cfg.fsq.dim, cfg.fsq.codebook_dim))
    return params


def w2vbert_from_numpy(tree, cfg: W2VBertConfig, device="cuda"):
    """wav2vec-BERT parameters (layers stacked), all fp32."""
    params = _fp32(tree, device)
    _check("feature projection kernel", params["feature_projection"]["projection"]["kernel"],
           (cfg.feature_dim, cfg.hidden_size))
    _check("stacked q kernel", params["layers"]["attn"]["q"]["kernel"],
           (cfg.num_layers, cfg.hidden_size, cfg.hidden_size))
    _check("distance embedding", params["layers"]["attn"]["distance_embedding"],
           (cfg.num_layers, cfg.num_distance_embeddings, cfg.head_size))
    return params


def _conv2d_tree(tree, device):
    """fp32, with 4-D conv kernels permuted [kh, kw, Cin, Cout] -> [Cout, Cin, kh, kw]."""
    dev = resolve_device(device)

    def leaf(a, key):
        t = torch.from_numpy(a.astype(np.float32))
        return (t.permute(3, 2, 0, 1) if key == "kernel" else t).contiguous().to(dev)

    return _tree(tree, leaf)


def mpd_from_numpy(tree, cfg: MPDConfig, device="cuda"):
    """Multi-period discriminator parameters (a list, one per period)."""
    params = _conv2d_tree(tree, device)
    if len(params) != len(cfg.periods):
        raise ValueError(f"{len(params)} period discriminators, config has "
                         f"{len(cfg.periods)}")
    _check("first period conv kernel", params[0]["convs"][0]["kernel"],
           (cfg.channels, 1, cfg.kernel_sizes[0], 1))
    return params


def msd_from_numpy(tree, cfg: MSDConfig, device="cuda"):
    """Multi-resolution spectral discriminator parameters (a list, one per
    resolution)."""
    params = _conv2d_tree(tree, device)
    if len(params) != len(cfg.fft_sizes):
        raise ValueError(f"{len(params)} spectral discriminators, config has "
                         f"{len(cfg.fft_sizes)}")
    _check("first spectral conv kernel", params[0]["layers"][0]["kernel"],
           (cfg.channels, 1, cfg.kernel_sizes[0], cfg.kernel_sizes[0]))
    return params


def whisper_from_numpy(tree, cfg: WhisperConfig, device="cuda", dtype=torch.float32):
    """Whisper parameters (``models/whisper.py``), in ``dtype``."""
    dev = resolve_device(device)
    params = _tree(tree, lambda a, key: torch.from_numpy(a.astype(np.float32)).to(dev, dtype))
    _check("conv1 kernel", params["encoder"]["conv1"]["kernel"], (3, cfg.n_mels, cfg.d_model))
    _check("decoder embedding", params["decoder"]["embed"], (cfg.vocab_size, cfg.d_model))
    _check("stacked decoder fc1 kernel", params["decoder"]["layers"]["fc1"]["kernel"],
           (cfg.decoder_layers, cfg.d_model, cfg.ffn_dim))
    return params


def wavlm_from_numpy(tree, cfg: WavLMConfig, device="cuda"):
    """WavLM parameters (``models/wavlm.py``), all fp32."""
    params = _fp32(tree, device)
    if len(params["convs"]) != len(cfg.conv_dim):
        raise ValueError(f"{len(params['convs'])} feature convs, config has "
                         f"{len(cfg.conv_dim)}")
    _check("stacked q kernel", params["layers"]["q"]["kernel"],
           (cfg.num_layers, cfg.hidden_size, cfg.hidden_size))
    _check("relative position embedding", params["rel_attn_embed"],
           (cfg.num_buckets, cfg.num_heads))
    return params


def ecapa_from_numpy(tree, cfg, device="cuda"):
    """ECAPA-TDNN parameters (``training/rlhf/ecapa.py``'s ``ECAPAConfig``),
    all fp32."""
    params = _fp32(tree, device)
    _check("layer1 kernel", params["layer1"]["conv"]["kernel"], (5, cfg.feat_dim, cfg.channels))
    _check("embedding kernel", params["linear"]["kernel"], (2 * cfg.cat_channels, cfg.emb_dim))
    return params
