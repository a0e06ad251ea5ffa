"""Validation metrics: per-source eval loss and model-health statistics
(counterpart of ``tts_max_tpu/training/evaluation.py``).

The val loss is aggregated per data source; optional max/avg absolute
parameter values. Each rank records its batches' losses (under a mesh the
eval step's loss is already the global batch's) and counts, and the sums
go across ranks through the statistics' process sum (``reduce_fn``), over
the keys of every source any rank can see (``statistics.source_keys``).
Under fsdp the health statistics read each leaf whole, gathered one at a
time, as JAX reads its global arrays.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable, Iterable

import numpy as np
import torch

from tts_max_tpu_torch.training.optim import tree_items
from tts_max_tpu_torch.utils.statistics import source_keys


def compute_metrics(
    eval_step: Callable,
    params: Any,
    val_batches: Iterable[dict],
    prettify: Callable[[dict], dict],
    collect_health_stats: bool = False,
    reduce_fn=None,
    sources=(),
    layout=None,
) -> dict[str, float]:
    """``sources``: the val datasets' names; ``layout``: the ``ShardLayout``
    of ``params`` when they are this rank's shards."""
    loss_sums: dict[str, float] = defaultdict(float)
    counts: dict[str, int] = defaultdict(int)
    for batch in val_batches:
        if not batch:
            continue
        seen = batch.get("source", ["default"] * len(batch["input_ids"]))
        loss, _ = eval_step(params, prettify(batch))
        loss = float(loss)
        loss_sums["total"] += loss
        counts["total"] += 1
        for s in set(seen):
            loss_sums[s] += loss
            counts[s] += 1

    keys = source_keys(loss_sums, sources)
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
        metrics.update(health_stats(params, layout))
    return metrics


@torch.no_grad()
def health_stats(params: Any, layout=None) -> dict[str, float]:
    """max/avg absolute parameter values; with ``layout`` each sharded leaf
    is gathered whole for its turn (a collective: every rank calls it)."""
    absmax, abssum, total = [], 0, 0
    for path, x in tree_items(params):
        x = layout.gather_leaf(path, x) if layout is not None else x
        absmax.append(x.abs().max().float())
        abssum = abssum + x.abs().float().sum()
        total += x.numel()
    absmax, abssum = float(torch.stack(absmax).max()), float(abssum)
    return {
        "health/param_abs_max": absmax,
        "health/param_abs_avg": abssum / max(1, total),
    }
