"""A bounded ``torch.profiler`` slice of the measured window, and what the
per-layer metrics read from it: the device's busy time (the union of its
kernel, copy and set intervals, as ``utils/profiling.device_busy_us`` of the
port computes it), device time by kernel name, and the longest idle gaps
named by what the host was doing.

The slice starts and ends on a synchronized card, so it holds exactly the
device work its own calls queued.
"""

from __future__ import annotations

import collections
import heapq
import time

import torch

from benchmark.harness import interval_union


class Slice:
    """``with Slice(device) as s:`` profiles the block; ``s.reduce()`` then
    gives the reductions below and ``s.window_s`` is the block's host-clock
    length. ``host=False`` records the card's activity alone, which costs
    a host-bound program far less than recording every host op too."""

    def __init__(self, device, host: bool = True):
        self.device, self.host = device, host
        self.summary = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        acts = ([ProfilerActivity.CPU] if self.host or self.device.type != "cuda" else []) + (
            [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        return False

    def reduce(self) -> dict:
        """Read the events once (after the measured window has closed)."""
        if self.summary is None:
            self.summary = summarize(self._prof.events(), self.window_s)
            self._prof = None
        return self.summary


def summarize(events, window_s: float) -> dict:
    """busy_s, device seconds by kernel name, and the 10 longest idle gaps
    by the host op that was running when each began."""
    dev, host = [], []
    for e in events:
        span = (e.time_range.start * 1e-6, e.time_range.end * 1e-6, e.name)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append(span)
        else:
            host.append(span)
    by_name: dict[str, float] = collections.defaultdict(float)
    calls: dict[str, int] = collections.defaultdict(int)
    for s, e, name in dev:
        by_name[name] += e - s
        calls[name] += 1
    busy = interval_union([(s, e) for s, e, _ in dev])
    gaps = _idle_gaps(dev, host)
    return {"busy_s": busy, "window_s": window_s, "device_s": dict(by_name),
            "calls": dict(calls), "idle_gaps": gaps}


def _idle_gaps(dev, host) -> list[list]:
    if not dev:
        return []
    spans = sorted((s, e) for s, e, _ in dev)
    merged = [list(spans[0])]
    for s, e in spans[1:]:
        if s > merged[-1][1]:
            merged.append([s, e])
        else:
            merged[-1][1] = max(merged[-1][1], e)
    host = sorted(host)
    by_label: dict[str, float] = collections.defaultdict(float)
    # the innermost host op open when the device went idle: a heap of the
    # ops begun so far, latest start on top, ended ones dropped lazily (the
    # gaps come in time order)
    heap: list = []
    j = 0
    for (_, end), (start, _) in zip(merged, merged[1:]):
        while j < len(host) and host[j][0] <= end:
            heapq.heappush(heap, (-host[j][0], host[j][1], host[j][2]))
            j += 1
        while heap and heap[0][1] < end:
            heapq.heappop(heap)
        by_label[heap[0][2] if heap else "python between ops"] += start - end
    return sorted(([k, v] for k, v in by_label.items()), key=lambda kv: -kv[1])[:10]


def device_seconds(summary: dict, *needles: str) -> tuple[float, int]:
    """Device seconds and calls of the kernels whose name holds any of
    ``needles``."""
    secs, n = 0.0, 0
    for name, t in summary["device_s"].items():
        if any(k in name for k in needles):
            secs += t
            n += summary["calls"][name]
    return secs, n


def breakdown(summary: dict) -> dict:
    top = sorted(summary["device_s"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[name[:160], t] for name, t in top],
            "idle_gaps": [[name[:160], t] for name, t in summary["idle_gaps"]]}
