"""ECAPA-TDNN speaker-verification embedder, channel-last (counterpart of
``tts_max_tpu/training/rlhf/ecapa.py``).

Res2Net SE blocks (scale 8, dilations 2/3/4), multi-layer feature
concatenation, attentive statistics pooling, a 256-d embedding; the
features are instance-normalized over time first. BatchNorms run in
inference mode (running statistics): the model is used frozen for the
similarity reward. Features are log-mel fbanks (``fbank_features``) or
WavLM hidden states combined with the softmax of ``feature_weight``
(``make_wavlm_embed_fn``, the reference's default). Parameters keep the JAX
tree (conv kernels ``[K, Cin, Cout]``, dense kernels ``[in, out]``);
``import_torch_state_dict`` reads a UniSpeech ECAPA checkpoint and
``export_torch_state_dict`` writes its names (for seeded stand-ins).

Each embed function counts its calls (``calls``) and the calls that
returned an embedding (``completed``), so that a caller can tell an
embedding from the reward's default.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from tts_max_tpu_torch.device import resolve_device
from tts_max_tpu_torch.models.codec.vocos import conv1d
from tts_max_tpu_torch.ops.stft import mel_spectrogram


@dataclass(frozen=True)
class ECAPAConfig:
    feat_dim: int = 80
    channels: int = 512
    emb_dim: int = 256
    scale: int = 8
    se_bottleneck_dim: int = 128
    attention_channels: int = 128
    cat_channels: int = 1536  # conv output before pooling

    @property
    def width(self) -> int:
        return self.channels // self.scale


def tiny_ecapa_config() -> ECAPAConfig:
    return ECAPAConfig(feat_dim=16, channels=32, emb_dim=8, scale=4,
                       se_bottleneck_dim=8, attention_channels=8,
                       cat_channels=48)


# --- init -------------------------------------------------------------------


def init_params(cfg: ECAPAConfig, seed: int = 0, dtype=torch.float32, device="cuda"):
    """Random parameters with the JAX module's distributions (normal *
    fan_in^-1/2 kernels, zero biases, identity BatchNorms), drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    C, W, CC = cfg.channels, cfg.width, cfg.cat_channels

    def normal(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=dev) * fan_in ** -0.5).to(dtype)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=dev)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=dev)

    def bn(n):
        return {"scale": ones(n), "bias": zeros(n), "mean": zeros(n), "var": ones(n)}

    def conv_bn(cin, cout, k):
        return {"conv": {"kernel": normal((k, cin, cout), cin * k), "bias": zeros(cout)},
                "bn": bn(cout)}

    def dense(cin, cout, lead=()):
        return {"kernel": normal(lead + (cin, cout), cin), "bias": zeros(cout)}

    def se_res2_block():
        return {
            "conv1": conv_bn(C, C, 1),
            "res2": {"convs": [conv_bn(W, W, 3) for _ in range(cfg.scale - 1)]},
            "conv2": conv_bn(C, C, 1),
            "se": {"linear1": dense(C, cfg.se_bottleneck_dim),
                   "linear2": dense(cfg.se_bottleneck_dim, C)},
        }

    return {
        "layer1": conv_bn(cfg.feat_dim, C, 5),
        "layer2": se_res2_block(),
        "layer3": se_res2_block(),
        "layer4": se_res2_block(),
        "conv": dense(3 * C, CC, (1,)),
        "pooling": {"linear1": dense(CC, cfg.attention_channels, (1,)),
                    "linear2": dense(cfg.attention_channels, CC, (1,))},
        "bn": bn(2 * CC),
        "linear": dense(2 * CC, cfg.emb_dim),
    }


# --- forward ----------------------------------------------------------------


def _bn(x, p, eps=1e-5):
    """Inference-mode BatchNorm over the channel (last) axis."""
    return (x - p["mean"]) * torch.rsqrt(p["var"] + eps) * p["scale"] + p["bias"]


def _conv_relu_bn(x, p, padding=0, dilation=1):
    """conv -> relu -> bn (the reference's Conv1dReluBn)."""
    x = conv1d(x, p["conv"], padding=padding, dilation=dilation)
    return _bn(torch.relu(x), p["bn"])


def _res2(x, p, cfg: ECAPAConfig, padding, dilation):
    """Res2Net hierarchy (the reference's Res2Conv1dReluBn)."""
    spx = x.chunk(cfg.scale, dim=-1)
    out = []
    sp = None
    for i, cp in enumerate(p["convs"]):
        sp = spx[i] if i == 0 else sp + spx[i]
        sp = conv1d(sp, cp["conv"], padding=padding, dilation=dilation)
        sp = _bn(torch.relu(sp), cp["bn"])
        out.append(sp)
    out.append(spx[-1])
    return torch.cat(out, dim=-1)


def _se(x, p):
    """Squeeze-excitation (the reference's SE_Connect)."""
    s = x.mean(dim=1)  # [B, C]
    s = torch.relu(s @ p["linear1"]["kernel"] + p["linear1"]["bias"])
    s = torch.sigmoid(s @ p["linear2"]["kernel"] + p["linear2"]["bias"])
    return x * s[:, None, :]


def _se_res2_block(x, p, cfg: ECAPAConfig, padding, dilation):
    residual = x  # in == out channels in this topology
    x = _conv_relu_bn(x, p["conv1"])
    x = _res2(x, p["res2"], cfg, padding, dilation)
    x = _conv_relu_bn(x, p["conv2"])
    x = _se(x, p["se"])
    return x + residual


def _attentive_stats_pool(x, p):
    """Attentive weighted mean/std pooling. x: [B, T, C] -> [B, 2C]."""
    alpha = torch.tanh(conv1d(x, p["linear1"]))
    alpha = torch.softmax(conv1d(alpha, p["linear2"]), dim=1)
    mean = (alpha * x).sum(dim=1)
    var = (alpha * x ** 2).sum(dim=1) - mean ** 2
    std = torch.sqrt(torch.clamp_min(var, 1e-9))
    return torch.cat([mean, std], dim=-1)


def embed_features(params, feats: torch.Tensor, cfg: ECAPAConfig) -> torch.Tensor:
    """feats [B, T, feat_dim] -> embeddings [B, emb_dim]; the features are
    instance-normalized over time per channel first."""
    mean = feats.mean(dim=1, keepdim=True)
    var = feats.var(dim=1, unbiased=False, keepdim=True)
    x = (feats - mean) * torch.rsqrt(var + 1e-5)

    out1 = _conv_relu_bn(x, params["layer1"], padding=2)
    out2 = _se_res2_block(out1, params["layer2"], cfg, padding=2, dilation=2)
    out3 = _se_res2_block(out2, params["layer3"], cfg, padding=3, dilation=3)
    out4 = _se_res2_block(out3, params["layer4"], cfg, padding=4, dilation=4)
    out = torch.cat([out2, out3, out4], dim=-1)
    out = torch.relu(conv1d(out, params["conv"]))
    out = _bn(_attentive_stats_pool(out, params["pooling"]), params["bn"])
    return out @ params["linear"]["kernel"] + params["linear"]["bias"]


def fbank_features(wav: torch.Tensor, sample_rate: int = 16000,
                   n_mels: int = 80) -> torch.Tensor:
    """log-mel fbank features [B, T, n_mels] (the reference's feat_type
    'fbank'): the mel of the power spectrum."""
    mel = mel_spectrogram(wav, sample_rate, 400, 160, n_mels, power=2.0)
    return torch.log(mel + 1e-6).transpose(1, 2)


def _counted(run):
    def embed(audio: np.ndarray) -> np.ndarray:
        embed.calls += 1
        out = run(np.asarray(audio, dtype=np.float32).reshape(-1))
        embed.completed += 1
        return out

    embed.calls = 0
    embed.completed = 0
    return embed


def make_embed_fn(params=None, cfg: ECAPAConfig | None = None, rng_seed: int = 0,
                  device="cuda"):
    """``embed_fn(audio [n]) -> [emb_dim]`` over fbank features, on
    ``device`` (seeded random weights when ``params`` is None)."""
    cfg = cfg or ECAPAConfig()
    dev = resolve_device(device)
    if params is None:
        params = init_params(cfg, seed=rng_seed, device=dev)

    @torch.inference_mode()
    def run(audio: np.ndarray) -> np.ndarray:
        feats = fbank_features(torch.from_numpy(audio).to(dev)[None], n_mels=cfg.feat_dim)
        return embed_features(params, feats, cfg)[0].float().cpu().numpy()

    return _counted(run)


def make_wavlm_embed_fn(wavlm_params, wavlm_cfg, ecapa_params=None,
                        ecapa_cfg: ECAPAConfig | None = None, feature_weight=None,
                        rng_seed: int = 0):
    """``embed_fn(audio [n]) -> [emb_dim]`` over WavLM hidden states, the
    reference's default similarity path: every hidden state combined with
    the softmax of ``feature_weight`` ([num_layers+1] logits; zeros =
    uniform, UniSpeech checkpoints carry trained values), then ECAPA-TDNN.
    Runs on the device of ``wavlm_params``."""
    from tts_max_tpu_torch.models import wavlm as wavlm_mod

    dev = wavlm_params["proj"]["kernel"].device
    ecapa_cfg = ecapa_cfg or ECAPAConfig(feat_dim=wavlm_cfg.hidden_size)
    if ecapa_params is None:
        ecapa_params = init_params(ecapa_cfg, seed=rng_seed, device=dev)
    if feature_weight is None:
        feature_weight = np.zeros((wavlm_cfg.num_layers + 1,), np.float32)
    w = torch.softmax(torch.as_tensor(np.asarray(feature_weight, np.float32), device=dev), 0)

    @torch.inference_mode()
    def run(audio: np.ndarray) -> np.ndarray:
        stack = wavlm_mod.encode(wavlm_params, wavlm_cfg, torch.from_numpy(audio).to(dev)[None])
        feats = torch.einsum("l,lbtd->btd", w, stack.float())
        return embed_features(ecapa_params, feats, ecapa_cfg)[0].float().cpu().numpy()

    return _counted(run)


def load_wavlm_similarity_embedder(wavlm_dir: str, ecapa_checkpoint: str | None = None,
                                   device="cuda"):
    """The reference similarity backend from local files: an HF WavLM dir
    and optionally a UniSpeech ECAPA_TDNN_SMALL torch checkpoint (which also
    carries the trained ``feature_weight`` layer logits), on ``device``."""
    from tts_max_tpu_torch.models import wavlm as wavlm_mod

    wavlm_params, wavlm_cfg = wavlm_mod.load_wavlm(wavlm_dir, device=device)
    ecapa_cfg = ECAPAConfig(feat_dim=wavlm_cfg.hidden_size)
    ecapa_params = None
    feature_weight = None
    if ecapa_checkpoint:
        sd = torch.load(ecapa_checkpoint, map_location="cpu", weights_only=True)
        sd = sd.get("model", sd)
        sd = {k.removeprefix("module."): v for k, v in sd.items()}
        ecapa_params = import_torch_state_dict(sd, ecapa_cfg, device=device)
        if "feature_weight" in sd:
            feature_weight = sd["feature_weight"].float().numpy()
    return make_wavlm_embed_fn(wavlm_params, wavlm_cfg, ecapa_params, ecapa_cfg,
                               feature_weight)


# --- torch checkpoint import ------------------------------------------------


def import_torch_state_dict(sd, cfg: ECAPAConfig, device="cuda") -> dict:
    """UniSpeech ECAPA state dict -> the tree (channel-last), fp32 on
    ``device``."""
    dev = resolve_device(device)

    def g(name):
        v = sd[name]
        t = v.detach() if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        return t.float().cpu()

    def put(t):
        return t.contiguous().to(dev)

    def conv(name):
        return put(g(name).permute(2, 1, 0))

    def bn(base):
        return {"scale": put(g(f"{base}.weight")), "bias": put(g(f"{base}.bias")),
                "mean": put(g(f"{base}.running_mean")), "var": put(g(f"{base}.running_var"))}

    def conv_bn(base):
        return {"conv": {"kernel": conv(f"{base}.conv.weight"), "bias": put(g(f"{base}.conv.bias"))},
                "bn": bn(f"{base}.bn")}

    def res2(base):
        return {"convs": [{"conv": {"kernel": conv(f"{base}.convs.{i}.weight"),
                                    "bias": put(g(f"{base}.convs.{i}.bias"))},
                           "bn": bn(f"{base}.bns.{i}")} for i in range(cfg.scale - 1)]}

    def linear(base):
        return {"kernel": put(g(f"{base}.weight").T), "bias": put(g(f"{base}.bias"))}

    def se_block(base):
        return {
            "conv1": conv_bn(f"{base}.Conv1dReluBn1"),
            "res2": res2(f"{base}.Res2Conv1dReluBn"),
            "conv2": conv_bn(f"{base}.Conv1dReluBn2"),
            "se": {"linear1": linear(f"{base}.SE_Connect.linear1"),
                   "linear2": linear(f"{base}.SE_Connect.linear2")},
        }

    return {
        "layer1": conv_bn("layer1"),
        "layer2": se_block("layer2"),
        "layer3": se_block("layer3"),
        "layer4": se_block("layer4"),
        "conv": {"kernel": conv("conv.weight"), "bias": put(g("conv.bias"))},
        "pooling": {
            "linear1": {"kernel": conv("pooling.linear1.weight"),
                        "bias": put(g("pooling.linear1.bias"))},
            "linear2": {"kernel": conv("pooling.linear2.weight"),
                        "bias": put(g("pooling.linear2.bias"))},
        },
        "bn": bn("bn"),
        "linear": linear("linear"),
    }


def export_torch_state_dict(params, cfg: ECAPAConfig) -> dict[str, torch.Tensor]:
    """The inverse of ``import_torch_state_dict``: UniSpeech ECAPA names and
    torch layouts (conv ``[out, in, k]``, linear ``[out, in]``), on the CPU."""
    sd = {}

    def put(name, t):
        sd[name] = t.detach().float().cpu().contiguous()

    def bn(base, p):
        put(f"{base}.weight", p["scale"])
        put(f"{base}.bias", p["bias"])
        put(f"{base}.running_mean", p["mean"])
        put(f"{base}.running_var", p["var"])

    def conv_bn(base, p):
        put(f"{base}.conv.weight", p["conv"]["kernel"].permute(2, 1, 0))
        put(f"{base}.conv.bias", p["conv"]["bias"])
        bn(f"{base}.bn", p["bn"])

    def linear(base, p):
        put(f"{base}.weight", p["kernel"].T)
        put(f"{base}.bias", p["bias"])

    conv_bn("layer1", params["layer1"])
    for name in ("layer2", "layer3", "layer4"):
        p = params[name]
        conv_bn(f"{name}.Conv1dReluBn1", p["conv1"])
        for i, c in enumerate(p["res2"]["convs"]):
            put(f"{name}.Res2Conv1dReluBn.convs.{i}.weight", c["conv"]["kernel"].permute(2, 1, 0))
            put(f"{name}.Res2Conv1dReluBn.convs.{i}.bias", c["conv"]["bias"])
            bn(f"{name}.Res2Conv1dReluBn.bns.{i}", c["bn"])
        conv_bn(f"{name}.Conv1dReluBn2", p["conv2"])
        linear(f"{name}.SE_Connect.linear1", p["se"]["linear1"])
        linear(f"{name}.SE_Connect.linear2", p["se"]["linear2"])
    put("conv.weight", params["conv"]["kernel"].permute(2, 1, 0))
    put("conv.bias", params["conv"]["bias"])
    for name in ("linear1", "linear2"):
        put(f"pooling.{name}.weight", params["pooling"][name]["kernel"].permute(2, 1, 0))
        put(f"pooling.{name}.bias", params["pooling"][name]["bias"])
    bn("bn", params["bn"])
    linear("linear", params["linear"])
    return sd
