"""Token sampling (counterpart of ``tts_max_tpu/ops/sampling.py``):
temperature, top-k, top-p, repetition penalty (HF convention), frequency
penalty (vLLM/OpenAI convention). Token-count state rides in a [B, V] int32
buffer updated per step. Randomness comes from an explicit
``torch.Generator``; its stream differs from JAX's, so tests compare the
adjusted logits and greedy ids, never sampled ids.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SamplingParams:
    """Defaults mirror the JAX package's SamplingParams."""

    temperature: float = 0.8
    top_k: int = 50
    top_p: float = 1.0
    repetition_penalty: float = 1.1
    frequency_penalty: float = 0.3
    max_new_tokens: int = 1792


def apply_repetition_penalty(
    logits: torch.Tensor, token_counts: torch.Tensor, penalty: float
) -> torch.Tensor:
    """For any token already seen (count > 0), positive logits are divided
    by ``penalty`` and negative ones multiplied."""
    if penalty == 1.0:
        return logits
    scaled = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(token_counts > 0, scaled, logits)


def apply_frequency_penalty(
    logits: torch.Tensor, gen_counts: torch.Tensor, penalty: float
) -> torch.Tensor:
    """logits -= penalty * count(token in generation)."""
    if penalty == 0.0:
        return logits
    return logits - penalty * gen_counts.to(logits.dtype)


def top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest logits per row (ties with the k-th kept), -inf
    elsewhere. k <= 0 disables."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def top_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest set of tokens with cumulative
    probability >= p (the top token always survives)."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = cum - probs < p
    thresh = torch.where(
        keep_sorted, sorted_logits, torch.full_like(sorted_logits, float("inf"))
    ).amin(dim=-1, keepdim=True)
    return logits.masked_fill(logits < thresh, float("-inf"))


def adjusted_logits(
    logits: torch.Tensor,
    params: SamplingParams,
    token_counts: torch.Tensor | None = None,
    gen_counts: torch.Tensor | None = None,
) -> torch.Tensor:
    """Penalty/temperature/top-k/top-p-adjusted fp32 logits, ready for
    categorical sampling (greedy callers argmax them instead)."""
    logits = logits.float()
    if token_counts is not None:
        logits = apply_repetition_penalty(
            logits, token_counts, params.repetition_penalty
        )
    if gen_counts is not None:
        logits = apply_frequency_penalty(logits, gen_counts, params.frequency_penalty)
    if params.temperature <= 0.0:
        return logits
    logits = logits / params.temperature
    logits = top_k_mask(logits, params.top_k)
    return top_p_mask(logits, params.top_p)


def sample_token(
    generator: torch.Generator | None,
    logits: torch.Tensor,
    params: SamplingParams,
    token_counts: torch.Tensor | None = None,
    gen_counts: torch.Tensor | None = None,
) -> torch.Tensor:
    """Next token ids [B] (int64) from logits [B, V] with all penalties.

    ``token_counts``: counts over prompt+generation (repetition penalty).
    ``gen_counts``: counts over generation only (frequency penalty).
    """
    logits = adjusted_logits(logits, params, token_counts, gen_counts)
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def counts_from_tokens(
    tokens: torch.Tensor, mask: torch.Tensor, vocab: int
) -> torch.Tensor:
    """[B, V] int32 counts from a [B, S] token matrix with validity mask."""
    counts = torch.zeros(tokens.shape[0], vocab, dtype=torch.int32,
                         device=tokens.device)
    return counts.scatter_add_(1, tokens.long(), mask.to(torch.int32))


def counts_from_tokens_windowed(
    tokens: torch.Tensor, mask: torch.Tensor, window: tuple[int, int]
) -> torch.Tensor:
    """[B, size] counts in vocab-window space: global ids outside
    [lo, lo+size) are dropped (a window-constrained sampler never emits
    them, so penalties ignore them exactly)."""
    lo, size = window
    w = tokens.long() - lo
    m = mask & (w >= 0) & (w < size)
    return counts_from_tokens(w.clamp(0, size - 1), m, size)
