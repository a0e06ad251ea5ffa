"""Whisper ASR for the WER reward (counterpart of
``tts_max_tpu/models/whisper.py``).

The log-mel frontend (Slaney filter bank, ``ops/stft.py``), the conv-stem
and bidirectional transformer encoder, the causal decoder with
cross-attention, and a greedy decode with a self-attention KV cache written
in place and the cross-attention K/V computed once. The decode is a Python
loop that reads the ``finished`` flags on the host once a step to stop
early, as ``inference/generate.py`` does.

The parameters keep the JAX tree: dense kernels ``[in, out]``, conv
kernels ``[K, Cin, Cout]``, each stack's layers stacked on a leading ``L``.
Products follow JAX's type promotion: a product of an fp32 activation and a
bf16 weight runs in fp32 (the weight widened), so with bf16 weights the
encoder and, from the first cross-attention on, the decoder compute in
fp32, and the self-attention cache holds bf16, as in the JAX module; the
greedy decode widens each weight once for each loaded model (``Widen``),
not once a step.
Softmaxes run in fp32 and are cast back to the query's dtype; q is scaled
by ``head_dim ** -0.5`` before the product; k projections have no bias.

Weights load from a local HF ``WhisperForConditionalGeneration`` directory
through the port's own safetensors reader; ``save_hf_dir`` writes one (the
importer's inverse), for seeded stand-ins of real checkpoints.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from tts_max_tpu_torch.device import cached_constant, resolve_device
from tts_max_tpu_torch.ops import stft as stft_ops

Params = Any

# whisper audio frontend constants (all model sizes)
SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_SECONDS = 30
N_SAMPLES = SAMPLE_RATE * CHUNK_SECONDS  # 480000
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000


@dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 128  # large-v3 (80 for <= large-v2)
    vocab_size: int = 51866
    d_model: int = 1280
    encoder_layers: int = 32
    decoder_layers: int = 32
    num_heads: int = 20
    ffn_dim: int = 5120
    max_source_positions: int = 1500
    max_target_positions: int = 448
    decoder_start_token_id: int = 50258  # <|startoftranscript|>
    eos_token_id: int = 50257

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def tiny_whisper_config() -> WhisperConfig:
    return WhisperConfig(
        n_mels=16,
        vocab_size=128,
        d_model=32,
        encoder_layers=2,
        decoder_layers=2,
        num_heads=4,
        ffn_dim=64,
        max_source_positions=24,
        max_target_positions=32,
        decoder_start_token_id=1,
        eos_token_id=2,
    )


# --- log-mel frontend ---------------------------------------------------------

_mel_fb = cached_constant(stft_ops.mel_filterbank)  # (device, sample_rate, n_fft, n_mels)


def log_mel_spectrogram(wav: torch.Tensor, n_mels: int) -> torch.Tensor:
    """Whisper's log-mel: |STFT|^2 (last frame dropped) -> slaney mel ->
    log10 clamped at per-sample max-8 -> (x+4)/4. wav: [B, L] fp32 ->
    [B, T, n_mels] (channel-last)."""
    spec = stft_ops.stft(wav, N_FFT, HOP_LENGTH)  # [B, F, T]
    mag2 = spec[..., :-1].abs() ** 2
    mel = torch.einsum("bft,fm->btm", mag2, _mel_fb(wav.device, SAMPLE_RATE, N_FFT, n_mels))
    log_spec = torch.log10(torch.clamp_min(mel, 1e-10))
    per_sample_max = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, per_sample_max - 8.0)
    return (log_spec + 4.0) / 4.0


def pad_or_trim(wav: np.ndarray, length: int = N_SAMPLES) -> np.ndarray:
    wav = np.asarray(wav, dtype=np.float32).reshape(-1)
    if wav.shape[0] >= length:
        return wav[:length]
    return np.pad(wav, (0, length - wav.shape[0]))


# --- init ---------------------------------------------------------------------


def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper encoder positional init (imported weights override this)."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def init_params(cfg: WhisperConfig, seed: int = 0, dtype=torch.float32,
                device="cuda") -> Params:
    """Random parameters with the JAX module's distributions (normal *
    fan_in^-1/2 kernels and embeddings, zero biases, unit layer norms,
    sinusoidal encoder positions), drawn from a ``torch.Generator`` seeded
    with ``seed`` on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    D, F_, Le, Ld = cfg.d_model, cfg.ffn_dim, cfg.encoder_layers, cfg.decoder_layers

    def dense(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=dev) * fan_in ** -0.5).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def ln(*lead):
        return {"scale": torch.ones(*lead, D, dtype=dtype, device=dev), "bias": zeros(*lead, D)}

    def attn(n):
        return {"q": {"kernel": dense((n, D, D), D), "bias": zeros(n, D)},
                "k": {"kernel": dense((n, D, D), D)},
                "v": {"kernel": dense((n, D, D), D), "bias": zeros(n, D)},
                "out": {"kernel": dense((n, D, D), D), "bias": zeros(n, D)}}

    def ffn(n):
        return {"fc1": {"kernel": dense((n, D, F_), D), "bias": zeros(n, F_)},
                "fc2": {"kernel": dense((n, F_, D), F_), "bias": zeros(n, D)}}

    encoder = {
        "conv1": {"kernel": dense((3, cfg.n_mels, D), 3 * cfg.n_mels), "bias": zeros(D)},
        "conv2": {"kernel": dense((3, D, D), 3 * D), "bias": zeros(D)},
        "pos": torch.from_numpy(_sinusoids(cfg.max_source_positions, D)).to(dev, dtype),
        "layers": {"attn_ln": ln(Le), "attn": attn(Le), "ffn_ln": ln(Le), **ffn(Le)},
        "ln": ln(),
    }
    decoder = {
        "embed": dense((cfg.vocab_size, D), D),
        "pos": dense((cfg.max_target_positions, D), D),
        "layers": {"self_ln": ln(Ld), "self_attn": attn(Ld), "cross_ln": ln(Ld),
                   "cross_attn": attn(Ld), "ffn_ln": ln(Ld), **ffn(Ld)},
        "ln": ln(),
    }
    return {"encoder": encoder, "decoder": decoder}


# --- building blocks ----------------------------------------------------------


def _layer(stacked: Params, i: int) -> Params:
    """Layer i of a stacked subtree: views into the stacked tensors."""
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i]


class Widen:
    """``w.to(dtype)`` for weights, each (weight, dtype) made once: the
    greedy decode widens its bf16 weights to its fp32 activations' dtype
    (the values JAX's promotion gives) once for the life of this object.
    A weight is known by where its elements lie (storage pointer, shape,
    strides), so every call's views of one stacked layer share one copy;
    the first view is kept beside its copy, so its storage stays alive and
    its pointer its own. Make one for each loaded model (as
    ``training/rlhf/asr.make_transcribe_fn`` does) and pass it to every
    ``greedy_decode`` on that model."""

    def __init__(self):
        self._made = {}

    def __call__(self, w: torch.Tensor, dtype) -> torch.Tensor:
        if w.dtype == dtype:
            return w
        key = (w.data_ptr(), tuple(w.shape), w.stride(), w.dtype, dtype)
        if key not in self._made:
            self._made[key] = (w, w.to(dtype))
        return self._made[key][1]


def _as(w: torch.Tensor, dtype, widen: Widen | None) -> torch.Tensor:
    return w.to(dtype) if widen is None else widen(w, dtype)


def _mm(a: torch.Tensor, w: torch.Tensor, widen: Widen | None = None) -> torch.Tensor:
    """``a @ w`` (w a weight) in the promoted dtype of the two (JAX's
    promotion)."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ _as(w, dt, widen)


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _layer_norm(x, p, widen: Widen | None = None):
    """In fp32 (scale and bias widened), cast back to x's dtype."""
    f32 = torch.float32
    return F.layer_norm(x.float(), x.shape[-1:], _as(p["scale"], f32, widen),
                        _as(p["bias"], f32, widen), 1e-5).to(x.dtype)


def _proj(x, p, widen: Widen | None = None):
    y = _mm(x, p["kernel"], widen)
    if "bias" in p:
        y = y + p["bias"]
    return y


def _heads(x, h):
    return x.reshape(*x.shape[:-1], h, x.shape[-1] // h)


def _attention(q, k, v, mask=None):
    """q: [B, S, H, Dh] (pre-scaled); k, v: [B, T, H, Dh]. fp32 softmax."""
    logits = _einsum("bshd,bthd->bhst", q, k).float()
    if mask is not None:
        logits = torch.where(mask, logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return _einsum("bhst,bthd->bshd", w, v)


def _mha(x, kv, p, cfg: WhisperConfig, mask=None):
    """Full-sequence multi-head attention (HF Whisper semantics: q scaled by
    head_dim**-0.5, k_proj bias-free)."""
    H = cfg.num_heads
    q = _heads(_proj(x, p["q"]) * cfg.head_dim ** -0.5, H)
    k = _heads(_proj(kv, p["k"]), H)
    v = _heads(_proj(kv, p["v"]), H)
    o = _attention(q, k, v, mask)
    return _proj(o.reshape(*o.shape[:-2], -1), p["out"])


def _ffn_block(x, lp, widen: Widen | None = None):
    h = F.gelu(_proj(x, lp["fc1"], widen))
    return _proj(h, lp["fc2"], widen)


def _conv(x, p, stride):
    """Conv over channel-last [B, T, C] with padding 1 and the kernel in x's
    dtype, plus the bias (promoted)."""
    y = F.conv1d(x.transpose(1, 2), p["kernel"].to(x.dtype).permute(2, 1, 0), stride=stride,
                 padding=1).transpose(1, 2)
    return y + p["bias"]


# --- encoder ------------------------------------------------------------------


def encode(params: Params, cfg: WhisperConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel: [B, T, n_mels] -> encoder states [B, T//2, D]."""
    enc = params["encoder"]
    x = F.gelu(_conv(mel, enc["conv1"], 1))
    x = F.gelu(_conv(x, enc["conv2"], 2))
    x = x + enc["pos"][: x.shape[1]].to(x.dtype)
    for i in range(cfg.encoder_layers):
        lp = _layer(enc["layers"], i)
        a = _layer_norm(x, lp["attn_ln"])
        x = x + _mha(a, a, lp["attn"], cfg)  # bidirectional: kv = normed x
        x = x + _ffn_block(_layer_norm(x, lp["ffn_ln"]), lp)
    return _layer_norm(x, enc["ln"])


# --- decoder (teacher-forced) ---------------------------------------------------


def decoder_forward(params: Params, cfg: WhisperConfig, tokens: torch.Tensor,
                    enc_out: torch.Tensor) -> torch.Tensor:
    """tokens: [B, S] -> logits [B, S, V] (full sequence, for teacher
    forcing; generation uses the cached loop below)."""
    dec = params["decoder"]
    S = tokens.shape[1]
    h = dec["embed"][tokens.long()] + dec["pos"][:S]
    causal = torch.tril(torch.ones(S, S, dtype=torch.bool, device=tokens.device))[None, None]
    for i in range(cfg.decoder_layers):
        lp = _layer(dec["layers"], i)
        a = _layer_norm(h, lp["self_ln"])
        h = h + _mha(a, a, lp["self_attn"], cfg, mask=causal)
        c = _layer_norm(h, lp["cross_ln"])
        h = h + _mha(c, enc_out, lp["cross_attn"], cfg)
        h = h + _ffn_block(_layer_norm(h, lp["ffn_ln"]), lp)
    h = _layer_norm(h, dec["ln"])
    return _mm(h, dec["embed"].T)


# --- cached greedy decode -------------------------------------------------------


def init_cross_cache(params: Params, cfg: WhisperConfig, enc_out: torch.Tensor):
    """Per-layer cross-attention K/V: ([B, T, H, Dh] * L, [B, T, H, Dh] * L)."""
    H = cfg.num_heads
    ks, vs = [], []
    for i in range(cfg.decoder_layers):
        ca = _layer(params["decoder"]["layers"]["cross_attn"], i)
        ks.append(_heads(_proj(enc_out, ca["k"]), H))
        vs.append(_heads(_proj(enc_out, ca["v"]), H))
    return ks, vs


@torch.inference_mode()
def greedy_decode(params: Params, cfg: WhisperConfig, enc_out: torch.Tensor,
                  prompt: torch.Tensor, max_len: int,
                  widen: Widen | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy generation.

    prompt: [B, P] forced ids (``<|startoftranscript|><|lang|><|transcribe|>
    <|notimestamps|>`` for pretrained checkpoints). ``widen``: the model's
    ``Widen`` (a new one, which lives for this call, when not given).
    Returns (tokens [B, max_len] int32 with the prompt first, EOS after
    each row finished; lengths [B]: the index of the first EOS after the
    prompt, else max_len).
    """
    dec = params["decoder"]
    dev = enc_out.device
    B, P = prompt.shape
    L, H, Dh = cfg.decoder_layers, cfg.num_heads, cfg.head_dim
    ck, cv = init_cross_cache(params, cfg, enc_out)
    cache_dtype = dec["embed"].dtype
    k_cache = torch.zeros(L, B, max_len, H, Dh, dtype=cache_dtype, device=dev)
    v_cache = torch.zeros_like(k_cache)
    eos = cfg.eos_token_id
    tokens = torch.full((B, max_len), eos, dtype=torch.int32, device=dev)
    tokens[:, :P] = prompt.to(dev, torch.int32)
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    layers = [_layer(dec["layers"], i) for i in range(L)]
    head = dec["embed"].T
    scale = cfg.head_dim ** -0.5
    widen = widen or Widen()

    pos = 0
    while pos < max_len - 1:
        tok = tokens[:, pos].long()
        h = dec["embed"][tok] + dec["pos"][pos]  # [B, D]
        for i, lp in enumerate(layers):
            a = _layer_norm(h, lp["self_ln"], widen)
            q = _heads(_proj(a, lp["self_attn"]["q"], widen) * scale, H)
            k_cache[i, :, pos] = _heads(_proj(a, lp["self_attn"]["k"], widen), H).to(cache_dtype)
            v_cache[i, :, pos] = _heads(_proj(a, lp["self_attn"]["v"], widen), H).to(cache_dtype)
            logits = _einsum("bhd,bthd->bht", q, k_cache[i, :, :pos + 1]).float()
            w = torch.softmax(logits, dim=-1).to(q.dtype)
            o = _einsum("bht,bthd->bhd", w, v_cache[i, :, :pos + 1]).reshape(B, -1)
            h = h + _proj(o, lp["self_attn"]["out"], widen)
            # cross attention against the precomputed encoder K/V
            c = _layer_norm(h, lp["cross_ln"], widen)
            qc = _heads(_proj(c, lp["cross_attn"]["q"], widen) * scale, H)
            cl = _einsum("bhd,bthd->bht", qc, ck[i]).float()
            cw = torch.softmax(cl, dim=-1).to(qc.dtype)
            oc = _einsum("bht,bthd->bhd", cw, cv[i]).reshape(B, -1)
            h = h + _proj(oc, lp["cross_attn"]["out"], widen)
            h = h + _ffn_block(_layer_norm(h, lp["ffn_ln"], widen), lp, widen)
        h = _layer_norm(h, dec["ln"], widen)
        nxt = _mm(h, head, widen).argmax(dim=-1).to(torch.int32)
        # the next token: forced inside the prompt, EOS once finished, else argmax
        if pos + 1 < P:
            out_tok = tokens[:, pos + 1]
        else:
            out_tok = torch.where(finished, eos, nxt).to(torch.int32)
            finished |= out_tok == eos
        tokens[:, pos + 1] = out_tok
        pos += 1
        if pos + 1 >= P and bool(finished.all()):  # one host read a step
            break
    after = torch.arange(max_len, device=dev)[None] >= P
    is_eos = (tokens == eos) & after
    lengths = torch.where(is_eos.any(dim=1), is_eos.int().argmax(dim=1),
                          torch.full((B,), max_len, device=dev))
    return tokens, lengths


# --- HF import ------------------------------------------------------------------


def import_hf_state_dict(sd: Mapping[str, Any], cfg: WhisperConfig, device="cuda",
                         dtype=torch.float32) -> Params:
    """Map a ``WhisperForConditionalGeneration`` (or ``WhisperModel``) state
    dict (torch tensors or numpy arrays) into the stacked tree, read in fp32
    and stored in ``dtype`` on ``device``."""
    dev = resolve_device(device)

    def a(name):
        for prefix in ("model.", ""):
            key = prefix + name
            if key in sd:
                v = sd[key]
                return (v.float() if isinstance(v, torch.Tensor)
                        else torch.from_numpy(np.asarray(v, dtype=np.float32)))
        raise KeyError(name)

    def put(t):
        return t.contiguous().to(device=dev, dtype=dtype)

    def stack(fmt, n):
        return torch.stack([a(fmt.format(i)) for i in range(n)])

    def stacked_ln(fmt, n):
        return {"scale": put(stack(fmt + ".weight", n)), "bias": put(stack(fmt + ".bias", n))}

    def stacked_dense(fmt, n, bias=True):
        p = {"kernel": put(stack(fmt + ".weight", n).transpose(-1, -2))}
        if bias:
            p["bias"] = put(stack(fmt + ".bias", n))
        return p

    def attn(fmt, n):
        return {"q": stacked_dense(fmt + ".q_proj", n),
                "k": stacked_dense(fmt + ".k_proj", n, bias=False),
                "v": stacked_dense(fmt + ".v_proj", n),
                "out": stacked_dense(fmt + ".out_proj", n)}

    def ln(name):
        return {"scale": put(a(name + ".weight")), "bias": put(a(name + ".bias"))}

    Le, Ld = cfg.encoder_layers, cfg.decoder_layers
    e = "encoder.layers.{}."
    d = "decoder.layers.{}."
    encoder = {
        # torch conv1d [out, in, k] -> [k, in, out]
        "conv1": {"kernel": put(a("encoder.conv1.weight").permute(2, 1, 0)),
                  "bias": put(a("encoder.conv1.bias"))},
        "conv2": {"kernel": put(a("encoder.conv2.weight").permute(2, 1, 0)),
                  "bias": put(a("encoder.conv2.bias"))},
        "pos": put(a("encoder.embed_positions.weight")),
        "layers": {
            "attn_ln": stacked_ln(e + "self_attn_layer_norm", Le),
            "attn": attn(e + "self_attn", Le),
            "ffn_ln": stacked_ln(e + "final_layer_norm", Le),
            "fc1": stacked_dense(e + "fc1", Le),
            "fc2": stacked_dense(e + "fc2", Le),
        },
        "ln": ln("encoder.layer_norm"),
    }
    decoder = {
        "embed": put(a("decoder.embed_tokens.weight")),
        "pos": put(a("decoder.embed_positions.weight")),
        "layers": {
            "self_ln": stacked_ln(d + "self_attn_layer_norm", Ld),
            "self_attn": attn(d + "self_attn", Ld),
            "cross_ln": stacked_ln(d + "encoder_attn_layer_norm", Ld),
            "cross_attn": attn(d + "encoder_attn", Ld),
            "ffn_ln": stacked_ln(d + "final_layer_norm", Ld),
            "fc1": stacked_dense(d + "fc1", Ld),
            "fc2": stacked_dense(d + "fc2", Ld),
        },
        "ln": ln("decoder.layer_norm"),
    }
    return {"encoder": encoder, "decoder": decoder}


def config_from_hf_dir(model_dir: str) -> WhisperConfig:
    with open(os.path.join(model_dir, "config.json")) as f:
        c = json.load(f)
    return WhisperConfig(
        n_mels=c["num_mel_bins"],
        vocab_size=c["vocab_size"],
        d_model=c["d_model"],
        encoder_layers=c["encoder_layers"],
        decoder_layers=c["decoder_layers"],
        num_heads=c["encoder_attention_heads"],
        ffn_dim=c["encoder_ffn_dim"],
        max_source_positions=c["max_source_positions"],
        max_target_positions=c["max_target_positions"],
        decoder_start_token_id=c["decoder_start_token_id"],
        eos_token_id=c["eos_token_id"],
    )


def load_whisper(model_dir: str, dtype=torch.float32, device="cuda"):
    """(params, cfg) from a local HF whisper dir, every tensor read in fp32
    and stored in ``dtype`` on ``device``."""
    from tts_max_tpu_torch.models.hf_import import _load_hf_state_dict

    cfg = config_from_hf_dir(model_dir)
    sd = _load_hf_state_dict(model_dir)
    return import_hf_state_dict(sd, cfg, device, dtype), cfg


def export_hf_state_dict(params: Params, cfg: WhisperConfig) -> dict[str, torch.Tensor]:
    """The inverse of ``import_hf_state_dict``: HF ``model.*`` names, torch
    layouts (dense ``[out, in]``, conv ``[out, in, k]``), the params' dtype."""
    sd = {}
    enc, dec = params["encoder"], params["decoder"]
    for name in ("conv1", "conv2"):
        sd[f"model.encoder.{name}.weight"] = enc[name]["kernel"].permute(2, 1, 0)
        sd[f"model.encoder.{name}.bias"] = enc[name]["bias"]
    sd["model.encoder.embed_positions.weight"] = enc["pos"]
    sd["model.decoder.embed_tokens.weight"] = dec["embed"]
    sd["model.decoder.embed_positions.weight"] = dec["pos"]

    def dense(prefix, p, i):
        sd[prefix + ".weight"] = p["kernel"][i].T
        if "bias" in p:
            sd[prefix + ".bias"] = p["bias"][i]

    def ln(prefix, p, i=None):
        sd[prefix + ".weight"] = p["scale"] if i is None else p["scale"][i]
        sd[prefix + ".bias"] = p["bias"] if i is None else p["bias"][i]

    def attn(prefix, p, i):
        for ours, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("out", "out_proj")):
            dense(f"{prefix}.{hf}", p[ours], i)

    for i in range(cfg.encoder_layers):
        e, lp = f"model.encoder.layers.{i}", enc["layers"]
        ln(e + ".self_attn_layer_norm", lp["attn_ln"], i)
        attn(e + ".self_attn", lp["attn"], i)
        ln(e + ".final_layer_norm", lp["ffn_ln"], i)
        dense(e + ".fc1", lp["fc1"], i)
        dense(e + ".fc2", lp["fc2"], i)
    for i in range(cfg.decoder_layers):
        d, lp = f"model.decoder.layers.{i}", dec["layers"]
        ln(d + ".self_attn_layer_norm", lp["self_ln"], i)
        attn(d + ".self_attn", lp["self_attn"], i)
        ln(d + ".encoder_attn_layer_norm", lp["cross_ln"], i)
        attn(d + ".encoder_attn", lp["cross_attn"], i)
        ln(d + ".final_layer_norm", lp["ffn_ln"], i)
        dense(d + ".fc1", lp["fc1"], i)
        dense(d + ".fc2", lp["fc2"], i)
    ln("model.encoder.layer_norm", enc["ln"])
    ln("model.decoder.layer_norm", dec["ln"])
    return {k: v.contiguous() for k, v in sd.items()}


def hf_config(cfg: WhisperConfig) -> dict:
    """The ``config.json`` fields ``config_from_hf_dir`` reads."""
    return {"model_type": "whisper", "num_mel_bins": cfg.n_mels, "vocab_size": cfg.vocab_size,
            "d_model": cfg.d_model, "encoder_layers": cfg.encoder_layers,
            "decoder_layers": cfg.decoder_layers, "encoder_attention_heads": cfg.num_heads,
            "decoder_attention_heads": cfg.num_heads, "encoder_ffn_dim": cfg.ffn_dim,
            "decoder_ffn_dim": cfg.ffn_dim, "max_source_positions": cfg.max_source_positions,
            "max_target_positions": cfg.max_target_positions,
            "decoder_start_token_id": cfg.decoder_start_token_id,
            "eos_token_id": cfg.eos_token_id, "pad_token_id": cfg.eos_token_id}


def save_hf_dir(params: Params, cfg: WhisperConfig, model_dir: str) -> None:
    """``config.json`` and ``model.safetensors`` (the params' dtype) that
    ``load_whisper`` reads back."""
    from tts_max_tpu_torch.models import safetensors_io

    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(hf_config(cfg), f, indent=1)
    safetensors_io.save_file({k: v.cpu() for k, v in export_hf_state_dict(params, cfg).items()},
                             os.path.join(model_dir, "model.safetensors"))
