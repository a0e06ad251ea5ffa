"""Where the port's CPU parity tests spend their time.

As a script, it sums a junit file's test times by test file (the tier-1
command writes one with ``--junitxml``), the port's ``test_torch_*`` files
apart from the rest; given two files (parent, change) it prints both::

    python tests/_torch_suite_times.py parent.xml [change.xml]

As a pytest plugin, it samples the main thread's stack every 5 ms and
splits the run's wall time into imports and collection, fixture set-up and
tear-down, and test calls; each into the JAX side (frames of
``tts_max_tpu``, ``jax``, ``optax``, ``flax`` or ``orbax``), the port's
side (``tts_max_tpu_torch`` or ``torch``), and the rest (test code, numpy,
waiting), by the outermost such frame; it writes the split as JSON::

    PYTHONPATH=tests SUITE_TIMES_OUT=split.json python -m pytest \\
        tests/test_torch_quant.py -p _torch_suite_times

Imports before pytest configures its plugins count in no phase: the
process's wall time less the phases is imports and collection.
"""

import collections
import contextlib
import json
import os
import sys
import threading
import time
import xml.etree.ElementTree as ET

import pytest

_PORT = ("/tts_max_tpu_torch/", "/site-packages/torch/")
_JAX = ("/tts_max_tpu/", "/site-packages/jax", "/site-packages/optax",
        "/site-packages/flax", "/site-packages/orbax")


def by_file(junit: str) -> tuple[dict, dict, float]:
    """Seconds and cases by test file (``test_x`` for ``tests/test_x.py``),
    and the session's seconds as pytest reports them."""
    seconds, cases = collections.defaultdict(float), collections.Counter()
    root = ET.parse(junit).getroot()
    for case in root.iter("testcase"):
        name = case.get("classname", "").split(".")[-1]
        seconds[name] += float(case.get("time", 0))
        cases[name] += 1
    suite = root if root.tag == "testsuite" else root.find("testsuite")
    return dict(seconds), dict(cases), float(suite.get("time", 0))


def _report(paths: list[str]) -> None:
    runs = [by_file(p) for p in paths]
    for path, (seconds, _, session) in zip(paths, runs):
        port = sum(v for k, v in seconds.items() if k.startswith("test_torch_"))
        print(f"{path}: session {session:.1f} s; tests: all files {sum(seconds.values()):.1f} s, "
              f"port files {port:.1f} s, the rest {sum(seconds.values()) - port:.1f} s")
    last = runs[-1][0]
    names = sorted({k for s, _, _ in runs for k in s if k.startswith("test_torch_")},
                   key=lambda k: -last.get(k, 0.0))
    print("file | cases | " + " | ".join(f"s ({p})" for p in paths))
    for name in names:
        cases = runs[-1][1].get(name, runs[0][1].get(name, 0))
        print(f"{name} | {cases} | " + " | ".join(f"{s.get(name, 0.0):.1f}" for s, _, _ in runs))


# --- the pytest plugin ------------------------------------------------------------

_phase = ["collect"]
_split: dict = collections.defaultdict(float)


def _side(frame) -> str:
    files = []
    while frame is not None:
        files.append(frame.f_code.co_filename)
        frame = frame.f_back
    for name in reversed(files):
        if any(p in name for p in _PORT):
            return "port"
        if any(p in name for p in _JAX):
            return "jax"
    return "rest"


def _sample(main: int) -> None:
    last = time.perf_counter()
    while True:
        time.sleep(0.005)
        now = time.perf_counter()
        frame = sys._current_frames().get(main)
        _split[(_phase[0], "rest" if frame is None else _side(frame))] += now - last
        last = now


def pytest_configure(config):
    main = threading.main_thread().ident
    threading.Thread(target=_sample, args=(main,), daemon=True).start()


@contextlib.contextmanager
def _in(phase: str):
    _phase[0] = phase
    yield
    _phase[0] = "between"


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    with _in("fixtures"):
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    with _in("calls"):
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_teardown(item):
    with _in("fixtures"):
        yield


def pytest_unconfigure(config):
    out = os.environ.get("SUITE_TIMES_OUT")
    if out:
        with open(out, "w") as f:
            json.dump({f"{phase}/{side}": round(s, 2)
                       for (phase, side), s in sorted(_split.items())}, f, indent=1)


if __name__ == "__main__":
    _report(sys.argv[1:])
