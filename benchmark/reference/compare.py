"""The comparisons that decide ``correct``, on numbers only: the program's
outputs against the reference's.

- Served tokens: greedy tokens are the argmax of their logits, so a served
  token's gap below the reference's best logit at its position is a
  rounding-sized number where the program is right and the size of the
  logits' spread where it is not. Each gap is taken in units of that
  position's spread (the standard deviation of the reference's logits over
  the window), so one limit holds across widths.
- Training: a loss by its relative gap, a leaf's norm by the gap between
  the program's and the reference's norms over the reference's norm of that
  leaf or of the median leaf, whichever is larger.
"""

from __future__ import annotations

import statistics

import torch


def token_gaps(ref_logits: torch.Tensor, tokens: torch.Tensor,
               exclude: int | None = None) -> torch.Tensor:
    """Per position: (best reference logit - the token's) / spread, over
    the window's ids but ``exclude`` (a token the request could not take)."""
    if exclude is not None:
        keep = torch.ones(ref_logits.shape[-1], dtype=torch.bool, device=ref_logits.device)
        keep[exclude] = False
        ref_logits = ref_logits[:, keep]
        tokens = tokens - (tokens > exclude).long()
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, tokens.long()[:, None])[:, 0]
    return (best - got) / ref_logits.std(dim=-1)


def loss_gap(program: list[float], reference: list[float]) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))


def leaf_gap(program: dict[str, float], reference: dict[str, float],
             leaves=None) -> tuple[float, str]:
    """The worst leaf's |program norm - reference norm| / max(reference
    norm, the median leaf's reference norm), and its name."""
    leaves = list(reference) if leaves is None else list(leaves)
    floor = statistics.median(reference[k] for k in leaves)
    worst = max(leaves, key=lambda k: abs(program[k] - reference[k]) / max(reference[k], floor))
    return abs(program[worst] - reference[worst]) / max(reference[worst], floor), worst


def moved_leaves(ref_grad: dict[str, float], share: float = 1e-3) -> list[str]:
    """Leaves whose reference gradient is at least ``share`` of the median
    leaf's: the others move under Adam by round-off alone."""
    floor = share * statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= floor]
