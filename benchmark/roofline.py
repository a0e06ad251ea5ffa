"""The yardstick's arithmetic: the H100's published peaks, and the
operations and bytes each kernel and each whole step needs, computed from
shapes.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity) at its
700 W limit; a card set below it runs slower, so every share of a peak is
reported beside the card's ``power.limit``. Each input byte is counted read
once and each output byte written once, whatever a kernel reads again.
The bound formulas of kernels A, A' and C are ``chip_smoke.py``'s (the
``Bound at main shape`` column of ``PERF.md``'s kernel table).
"""

from __future__ import annotations

PEAK_FLOPS = 989e12  # dense bf16 on the tensor cores
PEAK_BYTES = 3.35e12
ITEM = 2  # bytes of a bf16 element: every cell computes and caches in bf16


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take for bf16 work: the larger of the
    operation and the byte bound."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def causal_pairs(s: int) -> int:
    """(query, key) pairs with key <= query over s positions."""
    return s * (s + 1) // 2


# --- kernel A: causal prefill / training forward attention --------------------------


def attn_fwd(b: int, s: int, hq: int, hkv: int, d: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one causal attention forward: 4 * Hq * D FLOPs a
    pair; q, k, v read and the output written once."""
    flops = 4.0 * b * hq * d * causal_pairs(s)
    nbytes = (2 * b * s * hq * d + 2 * b * s * hkv * d) * ITEM
    return flops, nbytes


# --- kernel A': the attention backward ---------------------------------------------------


def attn_bwd(b: int, s: int, hq: int, hkv: int, d: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one causal attention backward: the five products
    (S, dP, dV, dK, dQ), 2 * Hq * D FLOPs each a pair with key <= query;
    q, k, v, O, dO and the log-sum-exp read, dq, dk, dv written."""
    flops = 5 * 2.0 * b * hq * d * causal_pairs(s)
    nbytes = (4 * b * s * hq * d + 4 * b * s * hkv * d) * ITEM + 4 * b * hq * s
    return flops, nbytes


# --- kernel C: one decode token per slot over a contiguous cache ------------------------


def decode_attn(rows, hq: int, hkv: int, d: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one decode-attention call over a batch whose slot i
    reads ``rows[i]`` live K/V rows: q read and the output written once,
    each live K and V row read once, the lengths read; 4 * Hq * D FLOPs a
    live row."""
    b = len(rows)
    total = int(sum(rows))
    nbytes = 2 * b * hq * d * ITEM + 2 * total * hkv * d * ITEM + 4 * b
    return 4.0 * total * hq * d, nbytes


# --- whole steps ------------------------------------------------------------------------


def layer_matmul_params(cfg) -> int:
    """Weights of every layer's projections (q, k, v, o, gate, up, down)."""
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    return cfg.n_layers * (cfg.dim * (q + 2 * kv) + q * cfg.dim + 3 * cfg.dim * cfg.ffn_dim)


def decode_step(cfg, rows, window: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one lockstep decode step of the serving engine
    whose active slot i attends over ``rows[i]`` cache rows (its new row
    included): every layer weight and RMSNorm scale read once, the
    ``window`` rows of the output head, an embedding row, a new K/V row
    written and the live rows read per active slot in every layer."""
    b = len(rows)
    mm = layer_matmul_params(cfg)
    norms = (2 * cfg.n_layers + 1) * cfg.dim * 4
    head = window * cfg.dim
    kv_row = 2 * cfg.n_kv_heads * cfg.head_dim * ITEM  # K and V
    att_flops, _ = decode_attn(rows, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    flops = 2.0 * b * (mm + head) + cfg.n_layers * att_flops
    nbytes = ((mm + head) * ITEM + norms + b * cfg.dim * ITEM
              + cfg.n_layers * (b * kv_row + sum(rows) * kv_row))
    return flops, nbytes


def train_flops(cfg, lengths) -> float:
    """Model FLOPs of one optimizer step over samples of ``lengths`` real
    tokens: 6 per weight per token over the layer projections and the
    output head, and 3x the causal attention forward (the backward is two
    forwards), counted over real tokens only (no padding, no recompute)."""
    n_params = layer_matmul_params(cfg) + cfg.vocab_size * cfg.dim
    tokens = sum(lengths)
    att = sum(4.0 * cfg.n_heads * cfg.head_dim * causal_pairs(n) for n in lengths)
    return 6.0 * n_params * tokens + 3.0 * cfg.n_layers * att
