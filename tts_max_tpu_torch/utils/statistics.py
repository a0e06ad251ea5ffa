"""Per-source metric accumulation (counterpart of ``tts_max_tpu/utils/statistics.py``).

Counters and metric sums are accumulated per data source on the host and
reduced over a canonically sorted key list. Given the sources every process
can record (the datasets' names), each process's vector carries all of them,
zero where it saw none, so that the cross-process sum (``make_process_sum``,
over ``torch.distributed``) adds the same keys in every process; JAX's keys
are only the sources the process saw, which differ between processes that
draw rows of several datasets.
Serializable to/from plain dicts so it can ride inside checkpoints.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Any

import numpy as np


class Statistics:
    def __init__(self) -> None:
        self.step = 0
        self.epoch = 0.0
        self.tokens_processed = 0
        self.samples_processed = 0
        self.audio_processed_sec = 0.0
        # per-source running loss sums and counts
        self.loss_sums: dict[str, float] = defaultdict(float)
        self.loss_counts: dict[str, int] = defaultdict(int)
        self.counters: dict[str, float] = defaultdict(float)
        self._step_times: list[float] = []
        self._data_times: list[float] = []

    # --- accumulation -------------------------------------------------------
    def record_loss(self, source: str, loss: float, n: int = 1) -> None:
        self.loss_sums[source] += float(loss) * n
        self.loss_counts[source] += n

    def record_counter(self, name: str, value: float) -> None:
        self.counters[name] += float(value)

    def record_step_time(self, seconds: float) -> None:
        self._step_times.append(seconds)
        if len(self._step_times) > 100:
            self._step_times.pop(0)

    def record_data_time(self, seconds: float) -> None:
        self._data_times.append(seconds)
        if len(self._data_times) > 100:
            self._data_times.pop(0)

    # --- reduction ----------------------------------------------------------
    def _reducible(self, sources=()) -> dict[str, float]:
        out: dict[str, float] = {
            "tokens_processed": float(self.tokens_processed),
            "samples_processed": float(self.samples_processed),
            "audio_processed_sec": float(self.audio_processed_sec),
        }
        for k in source_keys(self.loss_sums, sources):
            out[f"loss_sum/{k}"] = self.loss_sums[k]
            out[f"loss_count/{k}"] = float(self.loss_counts[k])
        for k in sorted(self.counters):
            out[f"counter/{k}"] = self.counters[k]
        return out

    def logging_stats(self, reduce_fn=None, sources=()) -> dict[str, float]:
        """Derive loggable metrics; optionally all-reduce sums across processes.

        ``reduce_fn`` maps a 1-D np array -> summed 1-D array across processes
        (see :func:`make_process_sum`). None => single-process. ``sources``:
        every source any process can record (see :func:`source_keys`).
        """
        red = self._reducible(sources)
        keys = sorted(red)
        vals = np.array([red[k] for k in keys], dtype=np.float64)
        if reduce_fn is not None:
            vals = np.asarray(reduce_fn(vals))
        red = dict(zip(keys, vals.tolist()))

        stats: dict[str, float] = {"step": float(self.step), "epoch": self.epoch}
        for k, v in red.items():
            if k.startswith("loss_sum/"):
                src = k[len("loss_sum/") :]
                cnt = red.get(f"loss_count/{src}", 0.0)
                if cnt > 0:
                    stats[f"loss/{src}"] = v / cnt
            elif k.startswith("loss_count/"):
                if v > 0:  # a source no process saw in the window is not logged
                    stats[k] = v
            elif k.startswith("counter/"):
                stats[k[len("counter/") :]] = v
            else:
                stats[k] = v
        if self._step_times:
            st = float(np.mean(self._step_times))
            stats["step_time_sec"] = st
            if st > 0:
                stats["samples_per_sec"] = red.get("samples_processed", 0.0) / max(
                    1e-9, st * max(1, self.step)
                )
        if self._data_times:
            stats["data_time_sec"] = float(np.mean(self._data_times))
        return stats

    def reset_window(self) -> None:
        self.loss_sums.clear()
        self.loss_counts.clear()

    # --- (de)serialization --------------------------------------------------
    def state_dict(self) -> dict[str, Any]:
        return {
            "step": self.step,
            "epoch": self.epoch,
            "tokens_processed": self.tokens_processed,
            "samples_processed": self.samples_processed,
            "audio_processed_sec": self.audio_processed_sec,
            "loss_sums": dict(self.loss_sums),
            "loss_counts": dict(self.loss_counts),
            "counters": dict(self.counters),
        }

    @classmethod
    def from_state_dict(cls, d: dict[str, Any]) -> "Statistics":
        s = cls()
        s.step = int(d.get("step", 0))
        s.epoch = float(d.get("epoch", 0.0))
        s.tokens_processed = int(d.get("tokens_processed", 0))
        s.samples_processed = int(d.get("samples_processed", 0))
        s.audio_processed_sec = float(d.get("audio_processed_sec", 0.0))
        s.loss_sums.update(d.get("loss_sums", {}))
        s.loss_counts.update({k: int(v) for k, v in d.get("loss_counts", {}).items()})
        s.counters.update(d.get("counters", {}))
        return s


def source_keys(seen, sources=()) -> list[str]:
    """The sorted source keys of a reduced vector: "total", every name in
    ``sources`` and every key in ``seen``. Given ``sources``, a key of
    ``seen`` outside them raises, since another process's vector would not
    carry it."""
    known = {"total", *sources}
    extra = set(seen) - known
    if sources and extra:
        raise ValueError(f"sources {sorted(extra)} are not among {sorted(known)}")
    return sorted(known | extra)


def make_process_sum():
    """Cross-process sum of a host vector (``fabric.all_reduce``,
    custom_logging.py:244-245): one ``all_reduce(SUM)`` of it as a float64
    tensor over the world, on the group's device (the current card under
    NCCL, the CPU under gloo). The identity without a group."""
    import torch
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return lambda v: v
    from tts_max_tpu_torch.parallel.collectives import all_reduce_sum

    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))

    def _sum(v: np.ndarray) -> np.ndarray:
        t = torch.as_tensor(np.asarray(v, dtype=np.float64)).to(device)
        return all_reduce_sum(t, None).cpu().numpy()

    return _sum


class Timer:
    """Wall-clock phase timer (reference custom_logging.py:177-189)."""

    def __init__(self, name: str = "") -> None:
        self.name = name
        self.elapsed = 0.0

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self._t0
