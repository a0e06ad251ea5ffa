"""Vocos-style codec decoder, FSQ codes → waveform (counterpart of
``tts_max_tpu/models/codec/vocos.py``).

FSQ index lookup → ``fc_post_a`` vq_dim→hidden → conv embed (k=7) → 2 prior
ResnetBlocks → ``depth`` RoPE transformer layers (non-causal, fused qkv) →
2 post ResnetBlocks → LayerNorm → (upsampler, >16 kHz configs only) → ISTFT
head (n_fft = 4·hop, same-padding overlap-add).

Tensors are channel-last [B, T, C] and parameters keep the JAX package's
names and layouts: conv kernels [K, Cin, Cout], transposed-conv kernels
[K, Cout, Cin], dense kernels [in, out], transformer layers stacked on a
leading ``depth`` axis. Convolutions are written as one matmul over the K
shifted copies of the input (``conv1d``), so they run as plain matrix
products in fp32. The decoder runs in fp32.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

from tts_max_tpu_torch.device import resolve_device
from tts_max_tpu_torch.models.codec import fsq
from tts_max_tpu_torch.ops.attention import full_attention
from tts_max_tpu_torch.ops.norms import group_norm, layer_norm, rms_norm
from tts_max_tpu_torch.ops.rope import apply_rope_interleaved, rope_table
from tts_max_tpu_torch.ops.stft import istft_same


@dataclass(frozen=True)
class VocosConfig:
    hidden_dim: int = 1024
    depth: int = 12
    heads: int = 16
    rope_dim: int = 64
    hop_length: int = 320
    vq_dim: int = 2048
    fsq: fsq.FSQConfig = field(default_factory=fsq.FSQConfig)
    resnet_groups: int = 32
    upsample_factors: tuple[int, ...] = ()
    upsample_kernel_sizes: tuple[int, ...] = ()

    @property
    def n_fft(self) -> int:
        return self.hop_length * 4

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.heads


def tiny_vocos_config() -> VocosConfig:
    """CPU-testable miniature (keeps all structural invariants)."""
    return VocosConfig(
        hidden_dim=32,
        depth=2,
        heads=2,
        rope_dim=16,
        hop_length=320,
        vq_dim=64,
        fsq=fsq.FSQConfig(dim=64),
        resnet_groups=4,
    )


# --- primitive helpers ------------------------------------------------------


def conv1d(x: torch.Tensor, p, padding: int = 0) -> torch.Tensor:
    """Stride-1 conv over [B, T, Cin]; p = {"kernel": [K, Cin, Cout], "bias"?}."""
    w = p["kernel"]
    ksize, cin, cout = w.shape
    if padding:
        x = F.pad(x, (0, 0, padding, padding))
    if ksize == 1:
        y = x @ w[0]
    else:
        cols = x.unfold(1, ksize, 1).transpose(-1, -2)  # [B, T_out, K, Cin]
        y = cols.reshape(*cols.shape[:2], ksize * cin) @ w.reshape(ksize * cin, cout)
    return y + p["bias"] if "bias" in p else y


def conv_transpose1d(x: torch.Tensor, p, stride: int, padding: int = 0) -> torch.Tensor:
    """Transposed conv over [B, T, Cin] with torch ConvTranspose1d semantics;
    p["kernel"]: [K, Cout, Cin]. Output length (T-1)*stride + K - 2*padding.
    Written as a full conv of the zero-stuffed input with the kernel flipped
    in time."""
    w = p["kernel"]
    ksize = w.shape[0]
    b, t, c = x.shape
    up = x.new_zeros(b, (t - 1) * stride + 1, c)
    up[:, ::stride] = x
    y = conv1d(up, {"kernel": w.flip(0).transpose(1, 2)}, padding=ksize - 1)
    if padding:
        y = y[:, padding:-padding]
    return y + p["bias"] if "bias" in p else y


def linear(x: torch.Tensor, p) -> torch.Tensor:
    y = x @ p["kernel"]
    return y + p["bias"] if "bias" in p else y


# --- blocks -----------------------------------------------------------------


def resnet_block(x, p, groups: int):
    h = F.silu(group_norm(x, p["norm1"]["scale"], p["norm1"]["bias"], groups, eps=1e-6))
    h = conv1d(h, p["conv1"], padding=1)
    h = F.silu(group_norm(h, p["norm2"]["scale"], p["norm2"]["bias"], groups, eps=1e-6))
    h = conv1d(h, p["conv2"], padding=1)
    if "nin_shortcut" in p:
        x = conv1d(x, p["nin_shortcut"])
    return x + h


def transformer_stack(x, stacked, cfg: VocosConfig):
    b, t, d = x.shape
    cos, sin = rope_table(cfg.rope_dim, t, theta=10000.0, device=x.device)
    for i in range(stacked["att_norm"]["scale"].shape[0]):
        y = rms_norm(x, stacked["att_norm"]["scale"][i], eps=1e-6)
        q, k, v = (y @ stacked["att"]["c_attn"]["kernel"][i]).chunk(3, dim=-1)
        q = apply_rope_interleaved(q.reshape(b, t, cfg.heads, cfg.head_dim), cos, sin)
        k = apply_rope_interleaved(k.reshape(b, t, cfg.heads, cfg.head_dim), cos, sin)
        v = v.reshape(b, t, cfg.heads, cfg.head_dim)
        o = full_attention(q, k, v).reshape(b, t, d)
        x = x + o @ stacked["att"]["c_proj"]["kernel"][i]
        y = rms_norm(x, stacked["ffn_norm"]["scale"][i], eps=1e-6)
        y = F.silu(y @ stacked["mlp"]["fc1"]["kernel"][i])
        x = x + y @ stacked["mlp"]["fc2"]["kernel"][i]
    return x


def backbone(x, p, cfg: VocosConfig):
    """x: [B, T, hidden] -> [B, T, hidden]."""
    x = conv1d(x, p["embed"], padding=3)
    for rp in p["prior"]:
        x = resnet_block(x, rp, cfg.resnet_groups)
    x = transformer_stack(x, p["blocks"], cfg)
    for rp in p["post"]:
        x = resnet_block(x, rp, cfg.resnet_groups)
    return layer_norm(x, p["final_norm"]["scale"], p["final_norm"]["bias"], eps=1e-6)


def istft_head(x, p, cfg: VocosConfig) -> torch.Tensor:
    """x: [B, T, H] -> wav [B, T * hop]."""
    pred = linear(x.float(), p["out"]).transpose(1, 2)  # [B, n_fft+2, T]
    mag, phase = pred.chunk(2, dim=1)
    mag = torch.exp(mag).clamp_max(1e2)  # safeguard against exploding magnitudes
    spec = torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))
    return istft_same(spec, cfg.n_fft, cfg.hop_length)


def upsampler(x, p, cfg: VocosConfig) -> torch.Tensor:
    """x: [B, T, C] -> [B, T * prod(factors), hidden_dim]."""
    for layer, k, u in zip(p["layers"], cfg.upsample_kernel_sizes, cfg.upsample_factors):
        x = conv_transpose1d(x, layer["up"], stride=u, padding=(k - u) // 2)
        x = resnet_block(x, layer["resnet"], cfg.resnet_groups)
    return F.silu(linear(x, p["out_proj"]))


def decode(params, codes: torch.Tensor, cfg: VocosConfig) -> torch.Tensor:
    """FSQ indices [B, T] -> waveform [B, T * hop * prod(upsample_factors)]."""
    h = linear(fsq.decode_indices(params["quantizer"], codes, cfg.fsq),
               params["fc_post_a"])
    h = backbone(h, params["backbone"], cfg)
    if "upsampler" in params:
        h = upsampler(h, params["upsampler"], cfg)
    return istft_head(h, params["head"], cfg)


# --- init -------------------------------------------------------------------


def init_decoder(cfg: VocosConfig, seed: int = 0, device="cuda"):
    """Random fp32 decoder parameters with the JAX package's distributions
    (truncated-normal conv kernels at std 0.02, normal * fan_in^-1/2 dense
    kernels, zero biases, unit norm scales), drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def conv(ksize, cin, cout, std=0.02):
        w = torch.empty(ksize, cin, cout, device=dev)
        torch.nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0, generator=gen)
        return {"kernel": w * std, "bias": torch.zeros(cout, device=dev)}

    def dense(shape, fan_in):
        return torch.randn(shape, generator=gen, device=dev) * fan_in ** -0.5

    def lin(cin, cout):
        return {"kernel": dense((cin, cout), cin), "bias": torch.zeros(cout, device=dev)}

    def norm(c):
        return {"scale": torch.ones(c, device=dev), "bias": torch.zeros(c, device=dev)}

    def resnet(c):
        return {"norm1": norm(c), "conv1": conv(3, c, c),
                "norm2": norm(c), "conv2": conv(3, c, c)}

    d, L = cfg.hidden_dim, cfg.depth
    cd = cfg.fsq.codebook_dim
    params = {
        "quantizer": {"project_out": {
            "kernel": dense((cd, cfg.fsq.dim), cd),
            "bias": torch.zeros(cfg.fsq.dim, device=dev)}},
        "fc_post_a": lin(cfg.vq_dim, d),
        "backbone": {
            "embed": conv(7, d, d),
            "prior": [resnet(d), resnet(d)],
            "blocks": {
                "att_norm": {"scale": torch.ones(L, d, device=dev)},
                "ffn_norm": {"scale": torch.ones(L, d, device=dev)},
                "att": {"c_attn": {"kernel": dense((L, d, 3 * d), d)},
                        "c_proj": {"kernel": dense((L, d, d), d)}},
                "mlp": {"fc1": {"kernel": dense((L, d, 4 * d), d)},
                        "fc2": {"kernel": dense((L, 4 * d, d), 4 * d)}},
            },
            "post": [resnet(d), resnet(d)],
            "final_norm": norm(d),
        },
        "head": {"out": lin(d, cfg.n_fft + 2)},
    }
    if cfg.upsample_factors:
        layers = []
        for i, k in enumerate(cfg.upsample_kernel_sizes):
            c_in, c_out = d // 2 ** i, d // 2 ** (i + 1)
            up = conv(k, c_out, c_in)  # transposed-conv kernel [K, Cout, Cin]
            up["bias"] = torch.zeros(c_out, device=dev)
            layers.append({"up": up, "resnet": resnet(c_out)})
        params["upsampler"] = {
            "layers": layers,
            "out_proj": lin(d // 2 ** len(cfg.upsample_factors), d),
        }
    return params
