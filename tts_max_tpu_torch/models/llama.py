"""Llama-architecture SpeechLM in PyTorch (counterpart of
``tts_max_tpu/models/llama.py``).

Parameters are a nested dict of tensors with the JAX package's names and
layouts: dense kernels ``[in, out]`` (``x @ kernel``), layers stacked on a
leading ``L`` axis, the tied embedding doubling as the LM head. Matmul
weights and the embedding are stored in the compute dtype, norm scales in
fp32; or, quantized for serving (``models/quantization.py``), as int8 or
int4 levels with fp32 scales. Every weight read goes through
``quantization.matmul``, ``embed_lookup`` and ``tied_logits``, as in the
JAX package: a quantized product of a decode step runs the kernel of
``ops/quant_matmul.py``.

Attention goes through the port's kernels: ``flash_attention`` (kernel A)
for every prefill, ``flash_decode_attention`` (kernel B) for a decode step
over a contiguous cache, or ``ragged_decode_attention`` (kernel C) when the
caller asks for it (the contiguous serving engine does), and the paged
kernel (``ops/paged_attention.py``) for ``decode_step_paged`` over a block
pool.
Under a mesh that splits ``tensor`` every forward below takes ``tp`` (a
``parallel.tensor.TensorParallel``) and this rank's blocks of the params:
the attention block then runs on local heads (``n_heads/t`` and
``n_kv_heads/t``) through the same kernels, the caches hold the local KV
heads, and the collectives are ``tp``'s (that module says which block runs
split and which whole).

Both decode steps write the new token's K/V row into the cache in place,
then attend over ``lengths + 1`` rows: PyTorch updates a tensor in place,
so the JAX package's delta-KV machinery, which exists to stop XLA copying a
loop-carried cache, has no counterpart here. The cache functions below that
write (``scatter_*``, ``decode_window``) also write in place and return the
cache they were given.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from tts_max_tpu_torch.core.constants import FIXED_VOCAB_SIZE
from tts_max_tpu_torch.device import resolve_device
from tts_max_tpu_torch.models.quantization import (
    embed_lookup,
    is_quantized,
    matmul,
    quantize_tensor,
    tied_logits,
)
from tts_max_tpu_torch.ops import paged_attention as pattn
from tts_max_tpu_torch.ops.attention import window_attention
from tts_max_tpu_torch.ops.flash_attention import flash_attention
from tts_max_tpu_torch.ops.flash_decode import flash_decode_attention
from tts_max_tpu_torch.ops.norms import rms_norm
from tts_max_tpu_torch.ops.ragged_decode import ragged_decode_attention
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
    # Training only: recompute each decoder layer in the backward pass
    # (``torch.utils.checkpoint``). None recomputes the whole layer (least
    # memory); "dots" saves the matrix products' outputs and recomputes only
    # the elementwise work, as JAX's ``dots_saveable`` policy does.
    remat: bool = False
    remat_policy: str | None = None

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


ARCHITECTURES = {
    "llama-tiny": tiny_config,
    "llama-1b": llama32_1b_config,
    "llama-3.2-1b": llama32_1b_config,
    "llama-8b": llama31_8b_config,
    "llama-3.1-8b": llama31_8b_config,
}


def config_for_architecture(name: str, **over) -> LlamaConfig:
    if name not in ARCHITECTURES:
        raise ValueError(f"unknown architecture {name!r}; have {sorted(ARCHITECTURES)}")
    return ARCHITECTURES[name](**over)


# --- init -------------------------------------------------------------------


def init_params(cfg: LlamaConfig, seed: int = 0, device="cuda") -> Params:
    """Random parameters with the JAX package's distributions (normal *
    fan_in^-1/2 kernels, normal * 0.02 embedding, unit norm scales), drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return _param_tree(
        cfg, lambda shape, std: (torch.randn(shape, generator=gen, device=dev) * std
                                 ).to(cfg.dtype),
        lambda shape: torch.ones(shape, device=dev))


def abstract_params(cfg: LlamaConfig) -> Params:
    """The parameter tree of ``cfg`` as meta tensors: shapes and dtypes."""
    return _param_tree(cfg, lambda shape, std: torch.empty(shape, dtype=cfg.dtype,
                                                           device="meta"),
                       lambda shape: torch.empty(shape, device="meta"))


def _param_tree(cfg: LlamaConfig, normal, ones_like) -> Params:
    L = cfg.n_layers

    def dense(shape, in_dim):
        return {"kernel": normal(shape, in_dim ** -0.5)}

    def ones(*shape):
        return {"scale": ones_like(shape)}

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


def param_count(params: Params) -> int:
    """Number of elements over every tensor of a (plain) parameter tree."""
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()


# --- forward ----------------------------------------------------------------


def _layer(params: Params, i: int) -> Params:
    """Layer i's parameters: views into the stacked tensors."""
    def walk(p):
        return {k: walk(v) for k, v in p.items()} if isinstance(p, dict) else p[i]

    return walk(params["layers"])


def params_device(params: Params) -> torch.device:
    """The device the parameters live on (the embedding's)."""
    emb = params["embed"]["embedding"]
    return (emb["scale"] if is_quantized(emb) else emb).device


def embedding_shape(params: Params) -> tuple[int, int]:
    """[V, D] of the embedding, plain or quantized."""
    emb = params["embed"]["embedding"]
    if not is_quantized(emb):
        return tuple(emb.shape)
    q = emb["q4"] if "q4" in emb else emb["q"]
    return q.shape[0], q.shape[1] * (2 if "q4" in emb else 1)


def _embed(params: Params, tokens: torch.Tensor, cfg: LlamaConfig, tp=None) -> torch.Tensor:
    if tp is not None and tp.embed:
        return tp.lookup(params["embed"]["embedding"], tokens, cfg.dtype)
    return embed_lookup(params["embed"]["embedding"], tokens, cfg.dtype)


def _block(lp, block: str, tp):
    """(the block's kernels, whether they run split over ``tp``'s group)."""
    w = {n: v["kernel"] for n, v in lp[block].items()}
    return (w, False) if tp is None else tp.block_weights(block, w)


def _attn_in(h, lp, cfg: LlamaConfig, tp):
    """The attention block's entry: (normed input, behind ``tp``'s entry
    when the block runs split; its kernels; whether it does)."""
    w, split = _block(lp, "attn", tp)
    x = rms_norm(h, lp["attn_norm"]["scale"], cfg.norm_eps)
    return (tp.enter(x) if split else x), w, split


def _attn_out(h, o, w, split, tp):
    """``h`` plus the output projection of the heads ``o`` [..., Hq, D]."""
    out = matmul(o.reshape(*o.shape[:-2], -1), w["wo"])
    return h + (tp.exit(out) if split else out)


def _attn_block(h, lp, cos, sin, cfg: LlamaConfig, tp=None):
    b, s, _ = h.shape
    x, w, split = _attn_in(h, lp, cfg, tp)
    q = matmul(x, w["wq"]).view(b, s, -1, cfg.head_dim)
    k = matmul(x, w["wk"]).view(b, s, -1, cfg.head_dim)
    v = matmul(x, w["wv"]).view(b, s, -1, cfg.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = flash_attention(q, k, v, causal=True)
    return _attn_out(h, o, w, split, tp), k, v


def _mlp_block(h, lp, cfg: LlamaConfig, tp=None):
    w, split = _block(lp, "mlp", tp)
    x = rms_norm(h, lp["mlp_norm"]["scale"], cfg.norm_eps)
    if split:
        x = tp.enter(x)
    out = matmul(F.silu(matmul(x, w["w_gate"])) * matmul(x, w["w_up"]), w["w_down"])
    return h + (tp.exit(out) if split else out)


def _logits(h, params: Params, cfg: LlamaConfig, logits_head=None, tp=None):
    """Final norm and LM head: fp32 logits over the vocab, or over the
    window ``logits_head`` (a ``slice_logits_head`` result, whole on every
    rank under ``tp``) covers. A vocab-split head's blocks are joined."""
    if logits_head is None and tp is not None and tp.head:
        return tp.gather_logits(local_logits(h, params, cfg, tp)[0])
    h = rms_norm(h, params["norm"]["scale"], cfg.norm_eps)
    if cfg.tie_embeddings:
        head = params["embed"]["embedding"] if logits_head is None else logits_head
        return tied_logits(h, head)
    head = params["lm_head"]["kernel"] if logits_head is None else logits_head
    return matmul(h, head).float()


def local_logits(h, params: Params, cfg: LlamaConfig, tp):
    """Final norm and this rank's block of a vocab-split head: (fp32
    logits [..., V/t], the block's first id)."""
    h = tp.enter(rms_norm(h, params["norm"]["scale"], cfg.norm_eps))
    if cfg.tie_embeddings:
        emb = params["embed"]["embedding"]
        return tied_logits(h, emb), tp.rank * emb.shape[0]
    k = params["lm_head"]["kernel"]
    return matmul(h, k).float(), tp.rank * k.shape[1]


def _column_window(levels: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """Columns [a, b) of ``levels`` [K, X] as a view into a zero-padded
    copy whose rows are a multiple of 16 bytes, so that the quantized
    product reads 4-byte aligned rows through the view's row stride."""
    cols = b - a
    buf = levels.new_zeros(levels.shape[0], -(-cols // 16) * 16)
    buf[:, :cols] = levels[:, a:b]
    return buf[:, :cols]


def slice_logits_head(params: Params, cfg: LlamaConfig, lo: int, size: int, tp=None):
    """Output-head rows [lo, lo+size) for window-constrained decode, in the
    form ``_logits(..., logits_head=...)`` expects: embedding rows when
    tied, kernel columns otherwise (plain or quantized). Under ``tp`` a
    vocab-split head's window is built whole on every rank (one sum over
    the group: build it once a weight update).

    Only the speech-token block (and the markers after it) is a legal
    output while speech is generated, so the head reads only those rows.
    A quantized embedding is sliced along its vocab rows, which are never
    the packed axis. A quantized lm_head is sliced along its columns: an
    int4 one packs vocab pairs along them, so its bounds must be even, and
    its levels are copied once into a buffer with aligned rows."""
    if tp is not None and tp.head:
        if cfg.tie_embeddings:
            return tp.window_head(params["embed"]["embedding"], lo, size, 0)
        return tp.window_head(params["lm_head"]["kernel"], lo, size, 1)
    if cfg.tie_embeddings:
        emb = params["embed"]["embedding"]
        if is_quantized(emb):
            return {k: v[lo:lo + size] for k, v in emb.items()}
        return emb[lo:lo + size]
    k = params["lm_head"]["kernel"]
    if is_quantized(k):
        out = {}
        for key, v in k.items():
            a, b = lo, lo + size
            if key == "q4":  # [D, V/2]: vocab pairs packed along the last axis
                if lo % 2 or size % 2:
                    raise ValueError("int4 lm_head window bounds must be even")
                a, b = lo // 2, (lo + size) // 2
            out[key] = (v[..., a:b].contiguous() if key == "scale"
                        else _column_window(v, a, b))
        return out
    return k[:, lo:lo + size]


def _unbind_layers(params: Params, n_layers: int) -> list[Params]:
    """Every layer's parameters, from one ``unbind`` of each stacked tensor:
    under autograd the stacked tensor's gradient is then one ``stack`` of
    the layers' gradients, not a full-size zero tensor per layer."""
    def walk(p):
        return ({k: walk(v) for k, v in p.items()} if isinstance(p, dict)
                else p.unbind(0))

    def pick(p, i):
        return {k: pick(v, i) for k, v in p.items()} if isinstance(p, dict) else p[i]

    stacked = walk(params["layers"])
    return [pick(stacked, i) for i in range(n_layers)]


def _decoder_layer(h, lp, cos, sin, cfg: LlamaConfig, gather_layer=None, tp=None):
    if gather_layer is not None:
        lp = gather_layer(lp)
    h, _, _ = _attn_block(h, lp, cos, sin, cfg, tp)
    return _mlp_block(h, lp, cfg, tp)


def _dots_context():
    """Selective checkpoint of ``remat_policy="dots"``: the matrix products'
    outputs are saved, everything else is recomputed in the backward."""
    aten = torch.ops.aten
    saved = {aten.mm.default, aten.bmm.default, aten.addmm.default}

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


def forward_hidden(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
                   gather_layer=None, tp=None) -> torch.Tensor:
    """Causal forward through the layer stack only: tokens [B, S] -> PRE-norm
    hidden states [B, S, D]. Callers apply ``_logits`` (the final norm and
    head) or, in training, a chunked loss that never holds the full
    [B, S, V] logits (``training/train_step.py``). With ``cfg.remat`` each
    layer runs under ``torch.utils.checkpoint`` (non-reentrant).
    ``gather_layer`` (FSDP) maps a layer's param shards to its full params
    inside the layer, so under remat its recompute gathers them again (and
    makes ``tp``'s row-parallel sums again)."""
    cos, sin = rope_table(cfg.head_dim, tokens.shape[1], cfg.rope_theta,
                          cfg.use_llama3_rope_scaling, tokens.device)
    h = _embed(params, tokens, cfg, tp)
    for lp in _unbind_layers(params, cfg.n_layers):
        if cfg.remat:
            kw = {"context_fn": _dots_context} if cfg.remat_policy == "dots" else {}
            h = checkpoint(_decoder_layer, h, lp, cos, sin, cfg, gather_layer, tp,
                           use_reentrant=False, **kw)
        else:
            h = _decoder_layer(h, lp, cos, sin, cfg, gather_layer, tp)
    return h


def forward(params: Params, cfg: LlamaConfig, tokens: torch.Tensor, tp=None) -> torch.Tensor:
    """Full-sequence causal forward: tokens [B, S] -> logits [B, S, V] (fp32)."""
    return _logits(forward_hidden(params, cfg, tokens, tp=tp), params, cfg, tp=tp)


# --- KV-cached generation ---------------------------------------------------


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=None, *,
                  quantized: bool = False, device="cuda", tp=None):
    """Zeroed KV cache ``{"k", "v"}`` of [L, B, max_len, Hkv, D] in the
    compute dtype, or with ``quantized`` int8 payloads ``{"q", "scale"}``
    with fp32 scales [L, B, max_len, Hkv] per (token, head). Under ``tp``,
    Hkv is this rank's (``tp.kv_heads``)."""
    dev = resolve_device(device)
    heads = cfg.n_kv_heads if tp is None else tp.kv_heads(cfg)
    shape = (cfg.n_layers, batch, max_len, heads, cfg.head_dim)
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


def _map(fn, *trees):
    """fn over the matching tensors of caches (dicts of tensors or of int8
    ``{"q", "scale"}`` dicts)."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def grow_cache(cache, new_len: int):
    """Zero-pad the token axis (axis 2 of every tensor) to ``new_len``."""
    old_len = cache_max_len(cache)
    if new_len < old_len:
        raise ValueError(f"cannot shrink cache {old_len} -> {new_len}")
    if new_len == old_len:
        return cache

    def leaf(x):
        out = x.new_zeros((*x.shape[:2], new_len, *x.shape[3:]))
        out[:, :, :old_len] = x
        return out

    return _map(leaf, cache)


def init_paged_kv_cache(cfg: LlamaConfig, num_blocks: int, block_size: int,
                        dtype=None, *, quantized: bool = False, device="cuda", tp=None):
    """Block-pool KV cache for paged serving: tensors [L, num_blocks,
    block_size, Hkv, D] (int8 payloads with fp32 scales [L, num_blocks,
    block_size, Hkv] when ``quantized``); sequences own ordered block-id
    lists (the engine's block table) instead of max_len reservations.
    Under ``tp``, Hkv is this rank's."""
    dev = resolve_device(device)
    heads = cfg.n_kv_heads if tp is None else tp.kv_heads(cfg)
    shape = (cfg.n_layers, num_blocks, block_size, heads, cfg.head_dim)
    if quantized:
        def entry():
            return {"q": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "scale": torch.zeros(shape[:-1], device=dev)}

        return {"k": entry(), "v": entry()}
    dtype = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def paged_block_size(cache) -> int:
    return (cache["k"]["q"] if cache_is_quantized(cache) else cache["k"]).shape[2]


def gather_blocks_to_cache(pool, block_ids):
    """Gather ordered pool blocks into a contiguous batch-1 cache
    [L, 1, len(block_ids) * block_size, ...] (the inverse of
    ``scatter_prefill_to_blocks``): the shared-prefix context of a
    prefix-cached admission. ``block_ids``: int tensor on the pool's
    device."""
    def leaf(big):
        g = big[:, block_ids.long()]  # [L, m, bs, ...]
        return g.reshape(g.shape[0], 1, -1, *g.shape[3:])

    return _map(leaf, pool)


def scatter_suffix_to_blocks(pool, small, block_ids, start: int):
    """Write rows [start, start + len(block_ids) * bs) of a contiguous
    batch-1 cache (tensors [L, 1, S, ...]) into pool blocks ``block_ids``,
    in place. ``start`` must be block-aligned."""
    def leaf(big, little):
        bs, n = big.shape[2], block_ids.shape[0]
        lit = little[:, 0, start:start + n * bs]
        big[:, block_ids.long()] = lit.reshape(lit.shape[0], n, bs,
                                               *lit.shape[2:]).to(big.dtype)

    _map(leaf, pool, small)
    return pool


def scatter_prefill_to_blocks(pool, small, block_ids):
    """Write a contiguous batch-1 prefill cache (tensors [L, 1, S, ...])
    into pool blocks ``block_ids`` ([S // block_size]), in place."""
    return scatter_suffix_to_blocks(pool, small, block_ids, 0)


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
            lengths: torch.Tensor, cache, logits_head=None, tp=None):
    """Process right-padded prompts [B, S]; fill cache[:, :, :S] in place;
    return (last-real-token logits [B, V] or [B, size], cache).

    Padded slots within [length, S) are later overwritten by decode_step,
    which writes at index ``lengths``, so they are never attended to.
    """
    b, s = tokens.shape
    cos, sin = rope_table(cfg.head_dim, s, cfg.rope_theta,
                          cfg.use_llama3_rope_scaling, tokens.device)
    h = _embed(params, tokens, cfg, tp)
    rows = (slice(None), slice(0, s))
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h, k, v = _attn_block(h, lp, cos, sin, cfg, tp)
        _write_cache(cache["k"], i, rows, k)
        _write_cache(cache["v"], i, rows, v)
        h = _mlp_block(h, lp, cfg, tp)
    # gather the last real hidden state before the head: the [B, S, V]
    # logits are never materialized
    h_last = h[torch.arange(b, device=h.device), lengths.long() - 1]
    return _logits(h_last, params, cfg, logits_head, tp), cache


def _decode_layers(params: Params, cfg: LlamaConfig, cache, tokens: torch.Tensor,
                   positions: torch.Tensor, rows, attend, max_pos: int, logits_head, tp):
    """The layer loop of one decode step for tokens [B] at ``positions``
    [B]: writes each layer's K/V rows at ``rows`` (an index into one
    layer's cache) in place and takes attention from ``attend(i, q)``."""
    b = tokens.shape[0]
    cos, sin = rope_table(cfg.head_dim, max_pos, cfg.rope_theta,
                          cfg.use_llama3_rope_scaling, tokens.device)
    pos = positions.long()[:, None]  # [B, 1]: one position per sequence
    h = _embed(params, tokens, cfg, tp)  # [B, D]
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        x, w, split = _attn_in(h, lp, cfg, tp)
        q = matmul(x, w["wq"]).view(b, 1, -1, cfg.head_dim)
        k = matmul(x, w["wk"]).view(b, 1, -1, cfg.head_dim)
        v = matmul(x, w["wv"]).view(b, -1, cfg.head_dim)
        q = apply_rope(q, cos, sin, pos)[:, 0]
        k = apply_rope(k, cos, sin, pos)[:, 0]
        _write_cache(cache["k"], i, rows, k)
        _write_cache(cache["v"], i, rows, v)
        h = _attn_out(h, attend(i, q), w, split, tp)
        h = _mlp_block(h, lp, cfg, tp)
    return _logits(h, params, cfg, logits_head, tp), cache


def decode_step(params: Params, cfg: LlamaConfig, cache, tokens: torch.Tensor,
                lengths: torch.Tensor, logits_head=None, *, ragged: bool = False, tp=None):
    """One autoregressive step for tokens [B]; ``lengths`` [B] int32 are the
    valid cache rows BEFORE this token (also its position). Writes the
    token's K/V rows at ``lengths`` in place, attends over ``lengths + 1``
    rows and returns (logits [B, V] or [B, size], cache); the caller
    increments lengths.

    ``ragged`` chooses the decode kernel, as the JAX ``decode_step``'s
    ``flash`` keyword does: kernel B (the default; bf16, fp32 or int8 KV) or,
    with ``ragged=True``, kernel C (``ragged_decode_attention``: B's
    split-K schedule with the scaled query kept in fp32 and zeros at length
    0; bf16 or fp32 KV only), the serving pool's decode attention."""
    if ragged and cache_is_quantized(cache):
        raise ValueError("ragged decode attention (kernel C) has no int8 form; "
                         "an int8 cache decodes with kernel B")
    rows = (torch.arange(tokens.shape[0], device=tokens.device), lengths.long())
    attend = lengths + 1
    kernel = ragged_decode_attention if ragged else flash_decode_attention

    def attn(i, q):
        return kernel(q, _layer_cache(cache["k"], i), _layer_cache(cache["v"], i), attend)

    return _decode_layers(params, cfg, cache, tokens, lengths, rows, attn,
                          cache_max_len(cache), logits_head, tp)


_PAGED_VARIANTS = ("dense", "dense2", "dma", "grid", "xla")


def _paged_variant(use_pallas: bool | None = None) -> str:
    """The paged attention entry point ``decode_step_paged`` runs, chosen
    as the JAX package chooses it: ``use_pallas=False`` means ``"xla"``
    (the plain version, for CPU tensors only), else ``TTS_MAX_PAGED_ATTN``
    names one of ``dense`` (kernel D, the default), ``dense2`` (D's stacked
    ``layer=`` form), ``dma`` (E), ``grid`` (F) or ``xla``."""
    variant = os.environ.get("TTS_MAX_PAGED_ATTN", "")
    if use_pallas is False and variant not in ("", "xla"):
        variant = "xla"
    if not variant:
        variant = "xla" if use_pallas is False else "dense"
    if variant not in _PAGED_VARIANTS:
        raise ValueError(f"TTS_MAX_PAGED_ATTN={variant!r}, not one of {_PAGED_VARIANTS}")
    return variant


def decode_step_paged(params: Params, cfg: LlamaConfig, cache, tokens: torch.Tensor,
                      lengths: torch.Tensor, table: torch.Tensor, *,
                      use_pallas: bool | None = None, logits_head=None, tp=None):
    """One autoregressive step against a block-pool cache: writes the new
    token's K/V row at block ``table[b, lengths[b] // bs]``, offset
    ``lengths[b] % bs``, in place, then attends through the table over
    ``lengths + 1`` rows with the entry point ``_paged_variant`` picks. ``table``: [B, P] int32 (unallocated entries must be valid ids,
    e.g. 0; they are masked by the lengths). Returns (logits, cache)."""
    variant = _paged_variant(use_pallas)
    if variant == "xla" and tokens.device.type != "cpu":
        raise ValueError("the 'xla' paged attention is the plain version and takes "
                         f"CPU tensors only, not {tokens.device.type} ones")
    bs = paged_block_size(cache)
    pos = lengths.long()
    blk = torch.gather(table, 1, (pos // bs)[:, None])[:, 0].long()
    rows = (blk, pos % bs)
    attend = lengths + 1
    entry = {"dense": pattn.paged_decode_attention_dense,
             "dma": pattn.paged_decode_attention_dma,
             "grid": pattn.paged_decode_attention,
             "xla": pattn.paged_decode_attention_xla}.get(variant)

    def attn(i, q):
        if variant == "dense2":  # the stacked pools, read at layer i
            return pattn.paged_decode_attention_dense(
                q, cache["k"], cache["v"], table, attend, layer=i)
        return entry(q, _layer_cache(cache["k"], i), _layer_cache(cache["v"], i),
                     table, attend)

    return _decode_layers(params, cfg, cache, tokens, lengths, rows, attn,
                          table.shape[1] * bs, logits_head, tp)


def decode_window(params: Params, cfg: LlamaConfig, cache, tokens: torch.Tensor,
                  lengths: torch.Tensor, logits_head=None, tp=None):
    """Chunked decode: a W-token window in one forward. tokens [B, W] sit at
    positions lengths .. lengths + W - 1; their K/V rows are written into the
    contiguous cache in place and each attends the cache up to and
    including itself (``window_attention``, plain torch: no kernel). Returns
    (logits [B, W, V] or [B, W, size] fp32, cache)."""
    b, w = tokens.shape
    cos, sin = rope_table(cfg.head_dim, cache_max_len(cache), cfg.rope_theta,
                          cfg.use_llama3_rope_scaling, tokens.device)
    pos = lengths.long()[:, None] + torch.arange(w, device=tokens.device)[None, :]
    rows = (torch.arange(b, device=tokens.device)[:, None], pos)
    h = _embed(params, tokens, cfg, tp)  # [B, W, D]
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        x, wts, split = _attn_in(h, lp, cfg, tp)
        q = matmul(x, wts["wq"]).view(b, w, -1, cfg.head_dim)
        k = matmul(x, wts["wk"]).view(b, w, -1, cfg.head_dim)
        v = matmul(x, wts["wv"]).view(b, w, -1, cfg.head_dim)
        q = apply_rope(q, cos, sin, pos)
        k = apply_rope(k, cos, sin, pos)
        _write_cache(cache["k"], i, rows, k)
        _write_cache(cache["v"], i, rows, v)
        o = window_attention(q, _layer_cache(cache["k"], i),
                             _layer_cache(cache["v"], i), lengths).to(h.dtype)
        h = _attn_out(h, o, wts, split, tp)
        h = _mlp_block(h, lp, cfg, tp)
    return _logits(h, params, cfg, logits_head, tp), cache
