"""Validation metrics: per-source eval loss and model-health statistics
(counterpart of ``tts_max_tpu/training/evaluation.py``).

The val loss is aggregated per data source; optional max/avg absolute
parameter values. The cross-process reduction goes through the statistics'
process sum (the identity in the port's one process).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable, Iterable

import numpy as np
import torch

from tts_max_tpu_torch.training.optim import tree_leaves


def compute_metrics(
    eval_step: Callable,
    params: Any,
    val_batches: Iterable[dict],
    prettify: Callable[[dict], dict],
    collect_health_stats: bool = False,
    reduce_fn=None,
) -> dict[str, float]:
    loss_sums: dict[str, float] = defaultdict(float)
    counts: dict[str, int] = defaultdict(int)
    for batch in val_batches:
        if not batch:
            continue
        sources = batch.get("source", ["default"] * len(batch["input_ids"]))
        loss, _ = eval_step(params, prettify(batch))
        loss = float(loss)
        loss_sums["total"] += loss
        counts["total"] += 1
        for s in set(sources):
            loss_sums[s] += loss
            counts[s] += 1

    keys = sorted(loss_sums)
    vals = np.array([loss_sums[k] for k in keys] + [float(counts[k]) for k in keys])
    if reduce_fn is not None:
        vals = np.asarray(reduce_fn(vals))
    n = len(keys)
    metrics = {}
    for i, k in enumerate(keys):
        c = vals[n + i]
        if c > 0:
            metrics[f"val_loss/{k}"] = float(vals[i] / c)

    if collect_health_stats:
        metrics.update(health_stats(params))
    return metrics


@torch.no_grad()
def health_stats(params: Any) -> dict[str, float]:
    """max/avg absolute parameter values."""
    leaves = tree_leaves(params)
    absmax = float(torch.stack([x.abs().max().float() for x in leaves]).max())
    total = sum(x.numel() for x in leaves)
    abssum = float(sum(x.abs().float().sum() for x in leaves))
    return {
        "health/param_abs_max": absmax,
        "health/param_abs_avg": abssum / max(1, total),
    }
