"""wav2vec-BERT 2.0 conformer encoder (counterpart of
``tts_max_tpu/models/codec/w2vbert.py``).

The codec's semantic stream is the hidden state after layer 16 of
facebook/w2v-bert-2.0: an HF ``Wav2Vec2BertModel`` (relative_key position
embeddings, conformer blocks with half-step FFN residuals and a causal
depthwise conv) run over its first ``num_layers_to_run`` layers, a plain
loop over the layers' stacked parameters.

The log-mel features are computed on the host in numpy by
``extract_features``, the port's own copy of transformers'
``SeamlessM4TFeatureExtractor`` recipe (the port does not import
transformers).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from tts_max_tpu_torch.core.constants import CODEC_HOP_LENGTH
from tts_max_tpu_torch.device import resolve_device
from tts_max_tpu_torch.models.codec.vocos import conv1d
from tts_max_tpu_torch.ops.norms import layer_norm


@dataclass(frozen=True)
class W2VBertConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    feature_dim: int = 160  # 80 mels x 2 stacked frames
    left_max_pos: int = 64
    right_max_pos: int = 8
    conv_kernel: int = 31
    layer_norm_eps: float = 1e-5
    num_layers_to_run: int = 16  # the codec uses hidden_states[16]

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_distance_embeddings(self) -> int:
        return self.left_max_pos + self.right_max_pos + 1


def tiny_w2vbert_config() -> W2VBertConfig:
    return W2VBertConfig(
        hidden_size=32,
        num_layers=3,
        num_heads=4,
        intermediate_size=64,
        feature_dim=16,
        left_max_pos=8,
        right_max_pos=2,
        conv_kernel=7,
        num_layers_to_run=2,
    )


def init_params(cfg: W2VBertConfig, seed: int = 0, device="cuda"):
    """Random fp32 parameters, layers stacked on a leading ``num_layers``
    axis: normal * fan_in^-1/2 kernels, zero biases, unit norm scales, drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    L, D, Fd, I = cfg.num_layers, cfg.hidden_size, cfg.feature_dim, cfg.intermediate_size

    def dense(shape, fan_in):
        return torch.randn(shape, generator=gen, device=dev) * fan_in ** -0.5

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    def ln(*lead, d=D):
        return {"scale": torch.ones(*lead, d, device=dev), "bias": zeros(*lead, d)}

    def lin(cin, cout):
        return {"kernel": dense((L, cin, cout), cin), "bias": zeros(L, cout)}

    def ffn():
        return {"intermediate": lin(D, I), "output": lin(I, D)}

    layers = {
        "ffn1_ln": ln(L),
        "ffn1": ffn(),
        "attn_ln": ln(L),
        "attn": {
            "q": lin(D, D), "k": lin(D, D), "v": lin(D, D), "out": lin(D, D),
            "distance_embedding": dense(
                (L, cfg.num_distance_embeddings, cfg.head_size), cfg.head_size),
        },
        "conv_ln": ln(L),
        "conv": {
            "pw1": {"kernel": dense((L, 1, D, 2 * D), D)},
            "dw": {"kernel": dense((L, cfg.conv_kernel, 1, D), cfg.conv_kernel)},
            "dw_ln": ln(L),
            "pw2": {"kernel": dense((L, 1, D, D), D)},
        },
        "ffn2_ln": ln(L),
        "ffn2": ffn(),
        "final_ln": ln(L),
    }
    return {
        "feature_projection": {
            "layer_norm": ln(d=Fd),
            "projection": {"kernel": dense((Fd, D), Fd), "bias": zeros(D)},
        },
        "layers": layers,
    }


# --- forward ----------------------------------------------------------------------


def _linear(x, p):
    return x @ p["kernel"] + p["bias"]


def _ffn(x, p):
    return _linear(F.silu(_linear(x, p["intermediate"])), p["output"])


def _attention(x, lp, cfg: W2VBertConfig):
    """Self-attention with the relative_key term: q . E[clip(k - q)] per
    (query, key), computed as q against the ``num_distance_embeddings``
    rows of E, then gathered per (query, key) distance (the same products
    as a [T, T, head_size] table, without building it)."""
    b, t, d = x.shape
    h, hs = cfg.num_heads, cfg.head_size
    q, k, v = (_linear(x, lp[n]).view(b, t, h, hs) for n in ("q", "k", "v"))
    scale = hs ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    pos = torch.arange(t, device=x.device)
    distance = (pos[None, :] - pos[:, None]).clamp(-cfg.left_max_pos, cfg.right_max_pos)
    rel = torch.einsum("bqhd,nd->bhqn", q.float(), lp["distance_embedding"].float())
    idx = (distance + cfg.left_max_pos).expand(b, h, t, t)
    scores = scores + torch.gather(rel, 3, idx) * scale
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, d)
    return _linear(o, lp["out"])


def _conv_module(x, lp, cfg: W2VBertConfig, eps):
    h = conv1d(x, lp["pw1"])  # [B, T, 2D]
    a, g = h.chunk(2, dim=-1)
    h = a * torch.sigmoid(g)  # GLU
    h = F.pad(h, (0, 0, cfg.conv_kernel - 1, 0))  # causal left pad
    h = conv1d(h, lp["dw"], groups=cfg.hidden_size)
    h = F.silu(layer_norm(h, lp["dw_ln"]["scale"], lp["dw_ln"]["bias"], eps))
    return conv1d(h, lp["pw2"])


def _layer(stacked, i: int):
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i]


def encode(params, feats: torch.Tensor, cfg: W2VBertConfig,
           num_layers: int | None = None) -> torch.Tensor:
    """feats [B, T, feature_dim] -> hidden states [B, T, hidden] after
    ``num_layers`` conformer layers (default ``cfg.num_layers_to_run``,
    i.e. ``hidden_states[16]``)."""
    num_layers = cfg.num_layers_to_run if num_layers is None else num_layers
    eps = cfg.layer_norm_eps
    fp = params["feature_projection"]
    x = layer_norm(feats, fp["layer_norm"]["scale"], fp["layer_norm"]["bias"], eps)
    x = _linear(x, fp["projection"])
    for i in range(num_layers):
        lp = _layer(params["layers"], i)

        def ln(y, name):
            return layer_norm(y, lp[name]["scale"], lp[name]["bias"], eps)

        x = x + 0.5 * _ffn(ln(x, "ffn1_ln"), lp["ffn1"])
        x = x + _attention(ln(x, "attn_ln"), lp["attn"], cfg)
        x = x + _conv_module(ln(x, "conv_ln"), lp["conv"], cfg, eps)
        x = x + 0.5 * _ffn(ln(x, "ffn2_ln"), lp["ffn2"])
        x = ln(x, "final_ln")
    return x


# --- HF weight import -------------------------------------------------------------


def import_hf_state_dict(sd: Mapping, cfg: W2VBertConfig) -> dict:
    """HF ``Wav2Vec2BertModel`` state dict (tensors or arrays) -> the stacked
    parameter tree as numpy (first ``cfg.num_layers`` layers); hand it to
    ``convert.w2vbert_from_numpy``."""

    def g(name):
        for prefix in ("", "wav2vec2_bert.", "model."):
            if prefix + name in sd:
                v = sd[prefix + name]
                return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
        raise KeyError(name)

    def stack(fmt, transform=lambda w: w):
        return np.stack([transform(g(fmt.format(i))) for i in range(cfg.num_layers)])

    def st_ln(base):
        return {"scale": stack(base + ".weight"), "bias": stack(base + ".bias")}

    def st_linear(base):
        return {"kernel": stack(base + ".weight", lambda w: w.T),
                "bias": stack(base + ".bias")}

    def st_conv(base):  # torch Conv1d [Cout, Cin, K] -> [K, Cin, Cout]
        return {"kernel": stack(base + ".weight", lambda w: np.transpose(w, (2, 1, 0)))}

    lyr = "encoder.layers.{}"
    layers = {
        "ffn1_ln": st_ln(lyr + ".ffn1_layer_norm"),
        "ffn1": {"intermediate": st_linear(lyr + ".ffn1.intermediate_dense"),
                 "output": st_linear(lyr + ".ffn1.output_dense")},
        "attn_ln": st_ln(lyr + ".self_attn_layer_norm"),
        "attn": {
            "q": st_linear(lyr + ".self_attn.linear_q"),
            "k": st_linear(lyr + ".self_attn.linear_k"),
            "v": st_linear(lyr + ".self_attn.linear_v"),
            "out": st_linear(lyr + ".self_attn.linear_out"),
            "distance_embedding": stack(lyr + ".self_attn.distance_embedding.weight"),
        },
        "conv_ln": st_ln(lyr + ".conv_module.layer_norm"),
        "conv": {
            "pw1": st_conv(lyr + ".conv_module.pointwise_conv1"),
            "dw": st_conv(lyr + ".conv_module.depthwise_conv"),
            "dw_ln": st_ln(lyr + ".conv_module.depthwise_layer_norm"),
            "pw2": st_conv(lyr + ".conv_module.pointwise_conv2"),
        },
        "ffn2_ln": st_ln(lyr + ".ffn2_layer_norm"),
        "ffn2": {"intermediate": st_linear(lyr + ".ffn2.intermediate_dense"),
                 "output": st_linear(lyr + ".ffn2.output_dense")},
        "final_ln": st_ln(lyr + ".final_layer_norm"),
    }
    return {
        "feature_projection": {
            "layer_norm": {"scale": g("feature_projection.layer_norm.weight"),
                           "bias": g("feature_projection.layer_norm.bias")},
            "projection": {"kernel": g("feature_projection.projection.weight").T,
                           "bias": g("feature_projection.projection.bias")},
        },
        "layers": layers,
    }


# --- host-side feature extraction -------------------------------------------------

_FRAME, _SHIFT, _NFFT, _NMEL, _STACK = 400, 160, 512, 80, 2
_PREEMPHASIS = 0.97
_MEL_FLOOR = 1.192092955078125e-07


@functools.lru_cache(maxsize=1)
def _povey_window() -> np.ndarray:
    return np.power(np.hanning(_FRAME), 0.85)


@functools.lru_cache(maxsize=1)
def _kaldi_mel_filters(sample_rate: int = 16000) -> np.ndarray:
    """[257, 80] float64 triangular filters on the kaldi mel scale
    (1127 ln(1 + f/700)) from 20 Hz to Nyquist, triangular in mel space."""

    def mel(f):
        return 1127.0 * np.log(1.0 + f / 700.0)

    mel_freqs = np.linspace(mel(20.0), mel(sample_rate // 2), _NMEL + 2)
    fft_mels = mel(sample_rate / _NFFT * np.arange(_NFFT // 2 + 1))
    diff = np.diff(mel_freqs)
    slopes = mel_freqs[None, :] - fft_mels[:, None]
    down = -slopes[:, :-2] / diff[:-1]
    up = slopes[:, 2:] / diff[1:]
    return np.maximum(np.zeros(1), np.minimum(down, up))


def _log_mel(wav: np.ndarray, sample_rate: int) -> np.ndarray:
    """One waveform [L] -> kaldi log-mel fbank [frames, 80] float32."""
    w = (np.asarray(wav, dtype=np.float32) * (2 ** 15)).astype(np.float64)
    n = 1 + (w.size - _FRAME) // _SHIFT
    frames = np.lib.stride_tricks.sliding_window_view(w, _FRAME)[::_SHIFT][:n]
    frames = frames - frames.mean(axis=1, keepdims=True)  # DC offset
    pre = np.empty_like(frames)
    pre[:, 1:] = frames[:, 1:] - _PREEMPHASIS * frames[:, :-1]
    pre[:, 0] = frames[:, 0] * (1 - _PREEMPHASIS)
    spec = np.fft.rfft(pre * _povey_window(), n=_NFFT, axis=1).astype(np.complex64)
    power = np.abs(spec, dtype=np.float64) ** 2.0
    mel = np.maximum(_MEL_FLOOR, np.dot(_kaldi_mel_filters(sample_rate).T, power.T))
    return np.log(mel).astype(np.float32).T


def extract_features(wav: np.ndarray, sample_rate: int = 16000) -> np.ndarray:
    """waveform [B, L] float -> stacked log-mel features [B, T, 160] float32,
    as ``SeamlessM4TFeatureExtractor()(list(wav), sampling_rate=16000)``
    computes them: the wav scaled by 2**15; 400-sample povey frames every
    160 samples with the DC offset removed and preemphasis 0.97; the
    512-point power spectrum through 80 kaldi mel bins; log with a floor of
    2**-23; each mel bin normalized over time (variance with ddof=1, +1e-7);
    zero frames padding the count to even; pairs of frames stacked."""
    if sample_rate != 16000:
        raise ValueError(f"features are defined at 16000 Hz, got {sample_rate}")
    feats = []
    for row in np.asarray(wav, dtype=np.float32):
        x = _log_mel(row, sample_rate)
        x = (x - x.mean(0)[None]) / np.sqrt(x.var(0, ddof=1)[None] + 1e-7)
        if len(x) % _STACK:
            x = np.concatenate([x, np.zeros((_STACK - len(x) % _STACK, _NMEL), x.dtype)])
        feats.append(x.reshape(len(x) // _STACK, _NMEL * _STACK))
    return np.stack(feats)


def default_semantic_fn(checkpoint_path: str | None = None, params=None,
                        cfg: W2VBertConfig | None = None, device="cuda"):
    """``semantic_fn(padded_wav [B, L] numpy) -> feats [B, T, hidden]`` on
    ``device`` for the codec ``AudioEncoder``: a zero pad of half a hop on
    each side (as the JAX package pads), features on the host, then the
    conformer layers on ``device``. ``params`` are port parameters on
    ``device``; without them, ``checkpoint_path`` is a torch file of an HF
    state dict."""
    from tts_max_tpu_torch import convert

    cfg = cfg or W2VBertConfig()
    dev = resolve_device(device)
    if params is None:
        if checkpoint_path is None:
            raise ValueError("w2v-bert weights required: pass params or a checkpoint path")
        sd = torch.load(checkpoint_path, map_location="cpu", weights_only=False)
        params = convert.w2vbert_from_numpy(import_hf_state_dict(sd, cfg), cfg, device=dev)
    half_hop = CODEC_HOP_LENGTH // 2

    @torch.inference_mode()
    def semantic_fn(wav: np.ndarray) -> torch.Tensor:
        padded = np.pad(wav, ((0, 0), (half_hop, half_hop)))
        feats = torch.from_numpy(extract_features(padded)).to(dev)
        return encode(params, feats, cfg)

    return semantic_fn
