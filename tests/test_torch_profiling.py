"""``tts_max_tpu_torch/utils/profiling.py`` on the CPU: ``Throughput``
equal to the JAX package's on the same mocked clock (window overflow, a
zero interval, fewer than two events); ``trace`` writes a Chrome trace that
names the traced ops, and writes nothing when disabled; the CPU trace has
no device time; ``fetch_rtt`` times a round trip."""

import glob
import json

import pytest
import torch

from tts_max_tpu.utils import profiling as jprof
from tts_max_tpu_torch.utils import profiling


@pytest.mark.parametrize("window", [3, 50])
def test_throughput_equals_jax_on_a_mocked_clock(monkeypatch, window):
    times = [1.0, 1.0, 1.5, 2.25, 3.0, 3.0, 4.5, 6.0]
    ticks = {"jax": iter(times), "port": iter(times)}
    monkeypatch.setattr(jprof.time, "perf_counter", lambda: next(ticks["jax"]))
    j, p = jprof.Throughput(window), profiling.Throughput(window)
    events = [(10, 0.2), (7, 0.0), (0, 1.5), (12, 0.25), (3, 0.1), (9, 0.0), (4, 2.0),
              (5, 0.5)]
    jr = []
    for tok, sec in events:
        j.record(tok, sec)
        jr.append(j.rates())
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(ticks["port"]))
    pr = []
    for tok, sec in events:
        p.record(tok, sec)
        pr.append(p.rates())
    assert pr == jr
    assert pr[0] == {"tokens_per_sec": 0.0, "audio_sec_per_sec": 0.0}
    assert pr[1] == {"tokens_per_sec": 0.0, "audio_sec_per_sec": 0.0}  # dt == 0


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "off"), enabled=False) as prof:
        assert prof is None
        torch.mm(x, x)
    assert not (tmp_path / "off").exists()
    with profiling.trace(str(tmp_path / "on")) as prof:
        torch.mm(x, x)
    files = glob.glob(str(tmp_path / "on" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
    assert profiling.device_busy_us(prof) == 0.0  # no card: no device events


def test_fetch_rtt_on_the_cpu():
    rtt = profiling.fetch_rtt(iters=3, device="cpu")
    assert 0.0 < rtt < 1.0
