"""Llama-architecture SpeechLM in PyTorch (counterpart of
``tts_max_tpu/models/llama.py``).

Parameters are a nested dict of tensors with the JAX package's names and
layouts: dense kernels ``[in, out]`` (``x @ kernel``), layers stacked on a
leading ``L`` axis, the tied embedding doubling as the LM head. Matmul
weights and the embedding are stored in the compute dtype, norm scales in
fp32.

Attention goes through the port's kernels: ``flash_attention`` (kernel A)
for every prefill, ``flash_decode_attention`` (kernel B) for every decode
step. ``decode_step`` writes the new token's K/V row into the cache in
place, then attends over ``lengths + 1`` rows: PyTorch updates a tensor in
place, so the JAX package's delta-KV machinery, which exists to stop XLA
copying a loop-carried cache, has no counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F

from tts_max_tpu_torch.core.constants import FIXED_VOCAB_SIZE
from tts_max_tpu_torch.device import resolve_device
from tts_max_tpu_torch.models.quantization import quantize_tensor
from tts_max_tpu_torch.ops.flash_attention import flash_attention
from tts_max_tpu_torch.ops.flash_decode import flash_decode_attention
from tts_max_tpu_torch.ops.norms import rms_norm
from tts_max_tpu_torch.ops.rope import apply_rope, rope_table

Params = dict


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = FIXED_VOCAB_SIZE
    dim: int = 2048
    n_layers: int = 16
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 64
    ffn_dim: int = 8192
    norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    use_llama3_rope_scaling: bool = True
    max_seq_len: int = 2048
    tie_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16  # compute dtype

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


def tiny_config(vocab_size: int = 512, max_seq_len: int = 256) -> LlamaConfig:
    """Small config for tests (CPU-friendly)."""
    return LlamaConfig(
        vocab_size=vocab_size,
        dim=64,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        ffn_dim=128,
        rope_theta=10000.0,
        use_llama3_rope_scaling=False,
        max_seq_len=max_seq_len,
        tie_embeddings=True,
    )


def llama32_1b_config(**over) -> LlamaConfig:
    """Llama-3.2-1B-Instruct geometry with the 193856-token speech vocab."""
    return replace(
        LlamaConfig(
            vocab_size=FIXED_VOCAB_SIZE,
            dim=2048,
            n_layers=16,
            n_heads=32,
            n_kv_heads=8,
            head_dim=64,
            ffn_dim=8192,
            rope_theta=500000.0,
            use_llama3_rope_scaling=True,
            tie_embeddings=True,
        ),
        **over,
    )


def llama31_8b_config(**over) -> LlamaConfig:
    """Llama-3.1-8B-Instruct geometry with the 193856-token speech vocab."""
    return replace(
        LlamaConfig(
            vocab_size=FIXED_VOCAB_SIZE,
            dim=4096,
            n_layers=32,
            n_heads=32,
            n_kv_heads=8,
            head_dim=128,
            ffn_dim=14336,
            rope_theta=500000.0,
            use_llama3_rope_scaling=True,
            tie_embeddings=False,
        ),
        **over,
    )


# --- init -------------------------------------------------------------------


def init_params(cfg: LlamaConfig, seed: int = 0, device="cuda") -> Params:
    """Random parameters with the JAX package's distributions (normal *
    fan_in^-1/2 kernels, normal * 0.02 embedding, unit norm scales), drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    L, wdt = cfg.n_layers, cfg.dtype

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(wdt)

    def dense(shape, in_dim):
        return {"kernel": normal(shape, in_dim ** -0.5)}

    def ones(*shape):
        return {"scale": torch.ones(shape, device=dev)}

    params = {
        "embed": {"embedding": normal((cfg.vocab_size, cfg.dim), 0.02)},
        "layers": {
            "attn_norm": ones(L, cfg.dim),
            "mlp_norm": ones(L, cfg.dim),
            "attn": {
                "wq": dense((L, cfg.dim, cfg.q_dim), cfg.dim),
                "wk": dense((L, cfg.dim, cfg.kv_dim), cfg.dim),
                "wv": dense((L, cfg.dim, cfg.kv_dim), cfg.dim),
                "wo": dense((L, cfg.q_dim, cfg.dim), cfg.q_dim),
            },
            "mlp": {
                "w_gate": dense((L, cfg.dim, cfg.ffn_dim), cfg.dim),
                "w_up": dense((L, cfg.dim, cfg.ffn_dim), cfg.dim),
                "w_down": dense((L, cfg.ffn_dim, cfg.dim), cfg.ffn_dim),
            },
        },
        "norm": ones(cfg.dim),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((cfg.dim, cfg.vocab_size), cfg.dim)
    return params


# --- forward ----------------------------------------------------------------


def _layer(params: Params, i: int) -> Params:
    """Layer i's parameters: views into the stacked tensors."""
    def walk(p):
        return {k: walk(v) for k, v in p.items()} if isinstance(p, dict) else p[i]

    return walk(params["layers"])


def _embed(params: Params, tokens: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    return params["embed"]["embedding"][tokens.long()].to(cfg.dtype)


def _attn_block(h, lp, cos, sin, cfg: LlamaConfig):
    b, s, _ = h.shape
    x = rms_norm(h, lp["attn_norm"]["scale"], cfg.norm_eps)
    q = (x @ lp["attn"]["wq"]["kernel"]).view(b, s, cfg.n_heads, cfg.head_dim)
    k = (x @ lp["attn"]["wk"]["kernel"]).view(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ lp["attn"]["wv"]["kernel"]).view(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = flash_attention(q, k, v, causal=True)
    return h + o.reshape(b, s, cfg.q_dim) @ lp["attn"]["wo"]["kernel"], k, v


def _mlp_block(h, lp, cfg: LlamaConfig):
    x = rms_norm(h, lp["mlp_norm"]["scale"], cfg.norm_eps)
    gate = x @ lp["mlp"]["w_gate"]["kernel"]
    up = x @ lp["mlp"]["w_up"]["kernel"]
    return h + (F.silu(gate) * up) @ lp["mlp"]["w_down"]["kernel"]


def _logits(h, params: Params, cfg: LlamaConfig, logits_head=None):
    """Final norm and LM head: fp32 logits over the vocab, or over the
    window ``logits_head`` (a ``slice_logits_head`` result) covers."""
    h = rms_norm(h, params["norm"]["scale"], cfg.norm_eps)
    if cfg.tie_embeddings:
        head = params["embed"]["embedding"] if logits_head is None else logits_head
        return (h @ head.T).float()
    head = params["lm_head"]["kernel"] if logits_head is None else logits_head
    return (h @ head).float()


def slice_logits_head(params: Params, cfg: LlamaConfig, lo: int, size: int):
    """Output-head rows [lo, lo+size) for window-constrained decode, in the
    form ``_logits(..., logits_head=...)`` expects: embedding rows when
    tied, kernel columns otherwise."""
    if cfg.tie_embeddings:
        return params["embed"]["embedding"][lo:lo + size]
    return params["lm_head"]["kernel"][:, lo:lo + size]


def forward(params: Params, cfg: LlamaConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal forward: tokens [B, S] -> logits [B, S, V] (fp32)."""
    cos, sin = rope_table(cfg.head_dim, tokens.shape[1], cfg.rope_theta,
                          cfg.use_llama3_rope_scaling, tokens.device)
    h = _embed(params, tokens, cfg)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h, _, _ = _attn_block(h, lp, cos, sin, cfg)
        h = _mlp_block(h, lp, cfg)
    return _logits(h, params, cfg)


# --- KV-cached generation ---------------------------------------------------


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=None, *,
                  quantized: bool = False, device="cuda"):
    """Zeroed KV cache ``{"k", "v"}`` of [L, B, max_len, Hkv, D] in the
    compute dtype, or with ``quantized`` int8 payloads ``{"q", "scale"}``
    with fp32 scales [L, B, max_len, Hkv] per (token, head)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    if quantized:
        def entry():
            return {"q": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "scale": torch.zeros(shape[:-1], device=dev)}

        return {"k": entry(), "v": entry()}
    dtype = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def cache_is_quantized(cache) -> bool:
    return isinstance(cache["k"], dict)


def cache_max_len(cache) -> int:
    return (cache["k"]["q"] if cache_is_quantized(cache) else cache["k"]).shape[2]


def _quantize_kv(x: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-(…, head) symmetric int8 over the feature dim."""
    return quantize_tensor(x, axis=x.ndim - 1)


def _layer_cache(entry, i: int):
    """Layer i of a stacked cache entry: a contiguous view."""
    if isinstance(entry, dict):
        return {"q": entry["q"][i], "scale": entry["scale"][i]}
    return entry[i]


def _write_cache(entry, i: int, index, x: torch.Tensor) -> None:
    """cache[i][index] = x in place (quantized on write for int8)."""
    if isinstance(entry, dict):
        xq = _quantize_kv(x)
        entry["q"][i][index] = xq["q"]
        entry["scale"][i][index] = xq["scale"]
    else:
        entry[i][index] = x.to(entry.dtype)


def prefill(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
            lengths: torch.Tensor, cache, logits_head=None):
    """Process right-padded prompts [B, S]; fill cache[:, :, :S] in place;
    return (last-real-token logits [B, V] or [B, size], cache).

    Padded slots within [length, S) are later overwritten by decode_step,
    which writes at index ``lengths``, so they are never attended to.
    """
    b, s = tokens.shape
    cos, sin = rope_table(cfg.head_dim, s, cfg.rope_theta,
                          cfg.use_llama3_rope_scaling, tokens.device)
    h = _embed(params, tokens, cfg)
    rows = (slice(None), slice(0, s))
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h, k, v = _attn_block(h, lp, cos, sin, cfg)
        _write_cache(cache["k"], i, rows, k)
        _write_cache(cache["v"], i, rows, v)
        h = _mlp_block(h, lp, cfg)
    # gather the last real hidden state before the head: the [B, S, V]
    # logits are never materialized
    h_last = h[torch.arange(b, device=h.device), lengths.long() - 1]
    return _logits(h_last, params, cfg, logits_head), cache


def decode_step(params: Params, cfg: LlamaConfig, cache, tokens: torch.Tensor,
                lengths: torch.Tensor, logits_head=None):
    """One autoregressive step for tokens [B]; ``lengths`` [B] int32 are the
    valid cache rows BEFORE this token (also its position). Writes the
    token's K/V rows at ``lengths`` in place, attends with kernel B over
    ``lengths + 1`` rows and returns (logits [B, V] or [B, size], cache);
    the caller increments lengths."""
    b = tokens.shape[0]
    cos, sin = rope_table(cfg.head_dim, cache_max_len(cache), cfg.rope_theta,
                          cfg.use_llama3_rope_scaling, tokens.device)
    pos = lengths.long()[:, None]  # [B, 1]: one position per sequence
    rows = (torch.arange(b, device=tokens.device), lengths.long())
    attend = lengths + 1
    h = _embed(params, tokens, cfg)  # [B, D]
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        x = rms_norm(h, lp["attn_norm"]["scale"], cfg.norm_eps)
        q = (x @ lp["attn"]["wq"]["kernel"]).view(b, 1, cfg.n_heads, cfg.head_dim)
        k = (x @ lp["attn"]["wk"]["kernel"]).view(b, 1, cfg.n_kv_heads, cfg.head_dim)
        v = (x @ lp["attn"]["wv"]["kernel"]).view(b, cfg.n_kv_heads, cfg.head_dim)
        q = apply_rope(q, cos, sin, pos)[:, 0]
        k = apply_rope(k, cos, sin, pos)[:, 0]
        _write_cache(cache["k"], i, rows, k)
        _write_cache(cache["v"], i, rows, v)
        o = flash_decode_attention(
            q, _layer_cache(cache["k"], i), _layer_cache(cache["v"], i), attend
        )
        h = h + o.reshape(b, cfg.q_dim) @ lp["attn"]["wo"]["kernel"]
        h = _mlp_block(h, lp, cfg)
    return _logits(h, params, cfg, logits_head), cache
