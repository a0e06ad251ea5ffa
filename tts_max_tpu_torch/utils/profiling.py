"""Profiling utilities (counterpart of ``tts_max_tpu/utils/profiling.py``):
a ``torch.profiler`` trace around a block, the device's busy time in it,
the card's round trip, and the sliding-window tokens/s and
audio-seconds/s counters.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

import torch

from tts_max_tpu_torch.device import resolve_device


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Capture a ``torch.profiler`` trace of the block: host activity, and
    the card's kernels and copies where there is a card. Written on exit to
    ``log_dir/<host>_<pid>.<ns>.pt.trace.json`` (Chrome trace format, the
    name ``tensorboard_trace_handler`` gives: TensorBoard's profiler plugin
    and Perfetto read it). Yields the profiler, None when not
    ``enabled``."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"))


def device_busy_us(prof) -> float:
    """Microseconds in which the card ran at least one kernel, copy or set
    in a ``trace``: the union of its device events' intervals (0 without a
    card, or when the profiler recorded no device activity)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def fetch_rtt(iters: int = 5, device="cuda") -> float:
    """Seconds of one round trip to the device: a one-element op and
    ``torch.cuda.synchronize()`` on the card, ``.item()`` on the CPU."""
    dev = resolve_device(device)
    x = torch.ones((), device=dev)

    def once():
        y = x + 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        else:
            y.item()

    once()
    t0 = time.perf_counter()
    for _ in range(iters):
        once()
    return (time.perf_counter() - t0) / iters


class Throughput:
    """Sliding-window tokens/s and audio-seconds/s tracker."""

    def __init__(self, window: int = 50):
        self._window = window
        self._events: list[tuple[float, int, float]] = []

    def record(self, tokens: int, audio_sec: float = 0.0) -> None:
        self._events.append((time.perf_counter(), tokens, audio_sec))
        if len(self._events) > self._window:
            self._events.pop(0)

    def rates(self) -> dict[str, float]:
        if len(self._events) < 2:
            return {"tokens_per_sec": 0.0, "audio_sec_per_sec": 0.0}
        dt = self._events[-1][0] - self._events[0][0]
        if dt <= 0:
            return {"tokens_per_sec": 0.0, "audio_sec_per_sec": 0.0}
        tokens = sum(e[1] for e in self._events[1:])
        audio = sum(e[2] for e in self._events[1:])
        return {"tokens_per_sec": tokens / dt, "audio_sec_per_sec": audio / dt}
