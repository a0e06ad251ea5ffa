"""The metric arithmetic against hand-worked cases: a tail over every
request of a window with a stall in it, the device's busy union and idle
gaps, the pool's rows per step, and each per-layer reader."""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import harness, roofline, trace  # noqa: E402
from benchmark.loops.serve import step_rows  # noqa: E402


def test_p95_over_every_request_sees_a_stall():
    # 95 requests at 100 ms and 5 caught behind one stall at 3000 ms: the
    # 95th percentile of all 100 lies between ranks 95 and 96
    values = [100.0] * 95 + [3000.0] * 5
    assert harness.percentile(values, 95) == pytest.approx(100.0 + 0.05 * 2900.0)
    # 10 caught: the tail is the stall itself
    assert harness.percentile([100.0] * 90 + [3000.0] * 10, 95) == 3000.0
    assert harness.percentile([7.0], 95) == 7.0


class Ev:
    def __init__(self, start, end, name, on_card):
        self.time_range = SimpleNamespace(start=start, end=end)
        self.name = name
        self.device_type = (torch.autograd.DeviceType.CUDA if on_card
                            else torch.autograd.DeviceType.CPU)


def test_busy_union_and_idle_gaps():
    events = [Ev(0, 10, "k1", True), Ev(20, 30, "k2", True), Ev(25, 35, "k1", True),
              Ev(50, 60, "k3", True), Ev(5, 40, "poll", False), Ev(9, 12, "aten::mm", False)]
    s = trace.summarize(events, window_s=100e-6)
    assert s["busy_s"] == pytest.approx(35e-6)  # 10 + (20..35) + 10
    assert s["device_s"]["k1"] == pytest.approx(20e-6) and s["calls"]["k1"] == 2
    # the gap 10..20 began inside aten::mm (innermost), 35..50 inside poll
    assert s["idle_gaps"] == [["poll", pytest.approx(15e-6)], ["aten::mm", pytest.approx(10e-6)]]
    assert trace.device_seconds(s, "k1", "k3") == (pytest.approx(30e-6), 3)
    assert harness.interval_union([(0, 2), (1, 3), (5, 6)]) == 4


def test_rows_each_slot_reads_in_a_dispatch():
    k = 4
    l0 = np.array([16, 10, 0, 0])
    a0 = np.array([True, True, False, False])
    l1 = np.array([20, 12, 0, 104])
    a1 = np.array([True, False, False, True])
    rows = np.stack(step_rows(l0, a0, l1, a1, k))
    assert rows[:, 0].tolist() == [17, 18, 19, 20]  # active throughout
    assert rows[:, 1].tolist() == [11, 1, 1, 1]  # emitted 2, ended on the second step
    assert rows[:, 2].tolist() == [1, 1, 1, 1]  # idle: its dead row
    assert rows[:, 3].tolist() == [101, 102, 103, 104]  # admitted before the dispatch


def cfg():
    return harness.model_config(harness.load_json("configs", "smollm2-1.7b-speech"))


def reader(name):
    return harness.load_metric(name).read


def serve_obs(**kw):
    obs = {"kind": "serve", "cfg": cfg(), "window": (262, 65542), "window_s": 2.0,
           "dispatches": 10, "steps_per_dispatch": 16, "occupancy": [64, 62, 63, 63],
           "max_batch": 64}
    obs.update(kw)
    return obs


def test_serving_readers():
    obs = serve_obs()
    assert reader("step_ms.serve")(obs) == pytest.approx(2000.0 / 160)
    assert reader("occupancy.serve")(obs) == pytest.approx(100 * 63 / 64)
    for name in ("mfu.serve", "ragged_decode_roofline.serve", "idle_share.serve"):
        assert reader(name)(obs) is None  # nothing traced: nothing read
    rows = [np.array([1000, 1, 500])] * 16
    obs = serve_obs(dispatch_rows=[("fill", rows), ("window", rows), ("slice", rows)])
    c = cfg()
    least = 16 * roofline.least_seconds(*roofline.decode_step(c, [1000, 500], 65542))
    assert reader("mfu.serve")(obs) == pytest.approx(100 * least / 2.0)
    k_s = 16 * c.n_layers * 1e-4
    summary = {"busy_s": 0.5, "window_s": 2.0, "calls": {"tc_kernel<ContiguousRows>": 16 * c.n_layers,
               "combine_kernel<bf16>": 16 * c.n_layers},
               "device_s": {"tc_kernel<ContiguousRows>": k_s, "combine_kernel<bf16>": 0.0}}
    obs["trace"] = summary
    one = roofline.least_seconds(*roofline.decode_attn(rows[0], c.n_heads, c.n_kv_heads, c.head_dim))
    assert reader("ragged_decode_roofline.serve")(obs) == pytest.approx(100 * one / 1e-4)
    assert reader("idle_share.serve")(obs) == pytest.approx(75.0)
    summary["calls"]["tc_kernel<ContiguousRows>"] -= 1  # a call missing from the trace
    assert reader("ragged_decode_roofline.serve")(obs) is None


def test_serving_tail_readers():
    """The per-layer tails are the percentiles of every request's reading,
    as the end-to-end metrics take them, and nothing where no request
    reached its first token or its end in the window."""
    ttft = [0.5 + 0.01 * i for i in range(100)] + [4.0]  # one stall in the window
    rtf = [1.0 + 0.002 * i for i in range(40)]
    obs = serve_obs(ttft_s=ttft, stream_rtf=rtf)
    assert reader("ttft_p95_ms.serve")(obs) == pytest.approx(1e3 * harness.percentile(ttft, 95))
    assert reader("ttft_p95_ms.serve")(obs) == pytest.approx(1450.0)
    assert reader("stream_rtf_p95.serve")(obs) == pytest.approx(harness.percentile(rtf, 95))
    for name in ("ttft_p95_ms.serve", "stream_rtf_p95.serve"):
        assert reader(name)(serve_obs(ttft_s=[], stream_rtf=[])) is None
        assert reader(name)({"kind": "train"}) is None


def test_training_readers():
    c = cfg()
    obs = {"kind": "train", "cfg": c, "window_s": 4.0, "tokens": 3000, "padded": 8192,
           "lengths": [1000, 1000, 500, 500]}
    assert reader("pad_share.train")(obs) == pytest.approx(100 * 5192 / 8192)
    assert reader("mfu.train")(obs) == pytest.approx(
        100 * roofline.train_flops(c, obs["lengths"]) / 4.0 / 989e12)
    assert reader("idle_share.train")(obs) is None
    L = c.n_layers
    obs.update(traced_batches=[(4, 1024)], trace={
        "busy_s": 0.9, "window_s": 1.0,
        "calls": {"flash_fwd_tc": 2 * L, "bwd_delta": L, "bwd_dkdv_tc": L, "bwd_dq_tc": L},
        "device_s": {"flash_fwd_tc": 2 * L * 2e-4, "bwd_delta": L * 1e-5,
                     "bwd_dkdv_tc": L * 3e-4, "bwd_dq_tc": L * 2e-4}})
    fwd = roofline.least_seconds(*roofline.attn_fwd(4, 1024, c.n_heads, c.n_kv_heads, c.head_dim))
    bwd = roofline.least_seconds(*roofline.attn_bwd(4, 1024, c.n_heads, c.n_kv_heads, c.head_dim))
    assert reader("flash_attn_fwd_roofline.train")(obs) == pytest.approx(100 * fwd / 2e-4)
    assert reader("flash_attn_bwd_roofline.train")(obs) == pytest.approx(100 * bwd / 5.1e-4)
    assert reader("idle_share.train")(obs) == pytest.approx(10.0)
    assert reader("step_ms.serve")(obs) is None  # a serving reader finds nothing here


def test_every_reader_declares_its_benchmark_entry():
    """Each per-layer metric's file states the name, unit, layer, source
    and moved metric that ``BENCHMARK.json`` gives it."""
    for m in harness.benchmark_spec()["per_layer"]:
        mod = harness.load_metric(m["name"])
        assert (mod.NAME, mod.UNIT, mod.LAYER, mod.SOURCE, mod.MOVES) == (
            m["name"], m["unit"], m["layer"], m["source"], m["moves"])
