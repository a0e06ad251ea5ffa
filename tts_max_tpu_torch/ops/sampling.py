"""Token sampling (counterpart of ``tts_max_tpu/ops/sampling.py``):
temperature, top-k, top-p, repetition penalty (HF convention), frequency
penalty (vLLM/OpenAI convention). Token-count state rides in a [B, V] int32
buffer updated per step.

Two surfaces, as in the JAX package: one ``SamplingParams`` for a whole
batch (``sample_token``, which draws from an explicit ``torch.Generator``),
and the rowwise path of the serving engine (``BatchedSamplingParams``,
``sample_token_batched``), where every row carries its own parameters and
its own random stream. The streams differ from JAX's, so tests compare the
adjusted logits and greedy ids, never sampled ids.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from tts_max_tpu_torch.device import resolve_device


@dataclass(frozen=True)
class SamplingParams:
    """Defaults mirror the JAX package's SamplingParams."""

    temperature: float = 0.8
    top_k: int = 50
    top_p: float = 1.0
    repetition_penalty: float = 1.1
    frequency_penalty: float = 0.3
    max_new_tokens: int = 1792


_OVERRIDE_KEYS = ("temperature", "top_k", "top_p", "repetition_penalty",
                  "frequency_penalty")


def sampling_from_overrides(
    overrides: dict, default: SamplingParams
) -> SamplingParams | None:
    """Per-request SamplingParams from a dict of optional overrides (the
    serving request surface). None when nothing overrides."""
    if not any(k in overrides for k in _OVERRIDE_KEYS):
        return None
    return SamplingParams(**{
        **{k: getattr(default, k) for k in _OVERRIDE_KEYS},
        **{k: overrides[k] for k in _OVERRIDE_KEYS if k in overrides},
    })


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
    kth = _top_values(logits, k)[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


_GROUP = 128


def _top_values(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Exact k largest values per row, sorted descending [..., k]. Over a
    large vocabulary in two stages: the vocab in 128-wide groups, the k
    groups with the largest maxima, then the top k of their k * 128
    candidates. Exact, since every global top-k value lies in a group whose
    maximum ranks in the top k."""
    v = logits.shape[-1]
    k = min(k, v)
    num_groups = (v + _GROUP - 1) // _GROUP
    if k > _GROUP or k > num_groups or v <= 4 * _GROUP:
        return torch.topk(logits, k, dim=-1).values
    pad = (-v) % _GROUP
    if pad:
        logits = torch.nn.functional.pad(logits, (0, pad), value=float("-inf"))
    g = logits.reshape(*logits.shape[:-1], -1, _GROUP)
    top_groups = torch.topk(g.amax(dim=-1), k, dim=-1).indices
    idx = top_groups[..., None].expand(*top_groups.shape, _GROUP)
    candidates = torch.gather(g, -2, idx).reshape(*logits.shape[:-1], k * _GROUP)
    return torch.topk(candidates, k, dim=-1).values


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


def sampling_distribution(
    logits: torch.Tensor,
    params: SamplingParams,
    token_counts: torch.Tensor | None = None,
    gen_counts: torch.Tensor | None = None,
) -> torch.Tensor:
    """The exact [B, V] fp32 distribution ``sample_token`` draws from
    (one-hot argmax when temperature <= 0): the p and q of speculative
    decoding's accept/reject arithmetic."""
    al = adjusted_logits(logits, params, token_counts, gen_counts)
    if params.temperature <= 0.0:
        return torch.nn.functional.one_hot(torch.argmax(al, dim=-1),
                                           al.shape[-1]).float()
    return torch.softmax(al, dim=-1)


# --- per-row (batched) sampling params --------------------------------------
# The serving engine keeps one row of sampling parameters per slot
# (per-request overrides, vLLM style).


@dataclass(frozen=True)
class BatchedSamplingParams:
    """[B]-shaped tensors, one row per sequence. ``max_top_k`` bounds the
    top-k reduction (a row's k clamps to it); ``use_top_p`` says whether any
    row uses nucleus filtering, and when it is False the [B, V] sort is
    skipped. Both are plain Python fields."""

    temperature: torch.Tensor  # [B] f32; <= 0 means greedy for that row
    top_k: torch.Tensor  # [B] i32; <= 0 disables
    top_p: torch.Tensor  # [B] f32; >= 1 disables
    repetition_penalty: torch.Tensor  # [B] f32; 1.0 disables
    frequency_penalty: torch.Tensor  # [B] f32; 0.0 disables
    max_top_k: int = 64
    use_top_p: bool = False

    @staticmethod
    def broadcast(sp: SamplingParams, batch: int, max_top_k: int | None = None,
                  device="cuda") -> "BatchedSamplingParams":
        dev = resolve_device(device)

        def full(v, dt):
            return torch.full((batch,), v, dtype=dt, device=dev)

        return BatchedSamplingParams(
            temperature=full(sp.temperature, torch.float32),
            top_k=full(sp.top_k, torch.int32),
            top_p=full(sp.top_p, torch.float32),
            repetition_penalty=full(sp.repetition_penalty, torch.float32),
            frequency_penalty=full(sp.frequency_penalty, torch.float32),
            max_top_k=max_top_k or max(sp.top_k, 1),
            use_top_p=sp.top_p < 1.0,
        )

    def set_row(self, i: int, sp: SamplingParams) -> "BatchedSamplingParams":
        """Write ``sp`` into row ``i`` in place; the returned object shares
        the tensors and sets ``use_top_p`` when ``sp`` needs it."""
        self.temperature[i] = sp.temperature
        self.top_k[i] = sp.top_k
        self.top_p[i] = sp.top_p
        self.repetition_penalty[i] = sp.repetition_penalty
        self.frequency_penalty[i] = sp.frequency_penalty
        return dataclasses.replace(self, use_top_p=self.use_top_p or sp.top_p < 1.0)


def top_k_mask_rowwise(
    logits: torch.Tensor, k: torch.Tensor, max_top_k: int
) -> torch.Tensor:
    """Per-row top-k: row b keeps its k[b] largest logits (k[b] <= 0
    disables; k[b] clamps to ``max_top_k``)."""
    max_top_k = min(max_top_k, logits.shape[-1])
    kk = k.clamp(1, max_top_k).long()
    vals = _top_values(logits, max_top_k)
    kth = torch.gather(vals, -1, (kk - 1)[:, None])  # [B, 1]
    masked = logits.masked_fill(logits < kth, float("-inf"))
    return torch.where((k > 0)[:, None], masked, logits)


def top_p_mask_rowwise(logits: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Per-row nucleus filtering (p[b] >= 1 disables)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = cum - probs < p[:, None]
    thresh = torch.where(
        keep_sorted, sorted_logits, torch.full_like(sorted_logits, float("inf"))
    ).amin(dim=-1, keepdim=True)
    masked = logits.masked_fill(logits < thresh, float("-inf"))
    return torch.where((p < 1.0)[:, None], masked, logits)


def adjusted_logits_batched(
    logits: torch.Tensor,
    bsp: BatchedSamplingParams,
    token_counts: torch.Tensor | None = None,
    gen_counts: torch.Tensor | None = None,
) -> torch.Tensor:
    """Rowwise counterpart of ``adjusted_logits``: greedy rows keep the
    penalty-adjusted logits, the rest are temperature-scaled and masked."""
    logits = logits.float()
    if token_counts is not None:
        pen = bsp.repetition_penalty[:, None]
        scaled = torch.where(logits > 0, logits / pen, logits * pen)
        logits = torch.where(token_counts > 0, scaled, logits)
    if gen_counts is not None:
        logits = logits - bsp.frequency_penalty[:, None] * gen_counts.to(logits.dtype)
    t = bsp.temperature.clamp(min=1e-6)[:, None]
    scaled = logits / t
    scaled = top_k_mask_rowwise(scaled, bsp.top_k, bsp.max_top_k)
    if bsp.use_top_p:  # the [B, V] sort runs only when some row asks for it
        scaled = top_p_mask_rowwise(scaled, bsp.top_p)
    return torch.where((bsp.temperature <= 0.0)[:, None], logits, scaled)


_MASK32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (lowbias32) on int64 tensors holding values
    below 2**32; every product stays below 2**63."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _MASK32
    return x ^ (x >> 16)


def gumbel_noise(rngs: torch.Tensor, vocab: int) -> torch.Tensor:
    """[B, vocab] fp32 Gumbel noise, row b a pure function of the key
    ``rngs[b] = (seed, counter)``: a counter-based generator built from
    integer ops, so a row's draws depend on nothing else in the batch."""
    seed = rngs[:, 0].long() & _MASK32
    ctr = rngs[:, 1].long() & _MASK32
    key = _mix32(_mix32(seed ^ 0x9E3779B9) ^ ctr)  # [B]
    col = torch.arange(vocab, device=rngs.device, dtype=torch.int64)
    bits = _mix32(_mix32(key[:, None] ^ ((col * 0x85EBCA6B) & _MASK32)))
    u = ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))  # in (0, 1)
    return -torch.log(-torch.log(u))


def sample_token_batched(
    rngs: torch.Tensor,
    logits: torch.Tensor,
    bsp: BatchedSamplingParams,
    token_counts: torch.Tensor | None = None,
    gen_counts: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-row parameterized sampling with per-row keys ``rngs`` [B, 2]
    int64 (seed, counter): greedy rows (temperature <= 0) take the argmax of
    the penalty-adjusted logits, the rest sample by the Gumbel trick
    (categorical == argmax(logits + gumbel)), so each row's draw is
    independent of the rest of the batch (continuous-batching slot
    isolation). Returns [B] int64 ids."""
    al = adjusted_logits_batched(logits, bsp, token_counts, gen_counts)
    noise = gumbel_noise(rngs, al.shape[-1])
    return torch.where(
        bsp.temperature <= 0.0,
        torch.argmax(al, dim=-1),
        torch.argmax(al + noise, dim=-1),
    )


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
