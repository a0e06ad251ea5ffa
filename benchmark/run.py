"""Run one cell of the benchmark once:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's cards. The cell is
an entry of ``BENCHMARK.json``'s ``workloads``; its files are found by name:
``benchmark/workloads/<name>.json`` (its loop and settings),
``benchmark/configs/<config>.json``, ``benchmark/traffic/<traffic>.json``,
and one reader ``benchmark/metrics/<metric>.py`` per per-layer metric.

The last line of standard output is the result, one JSON object; the
numbers that decided ``correct`` are the last lines of standard error. A run
that finds no CUDA card, fewer cards than the cell asks for, or JAX (or the
JAX package) loaded once the window has closed prints no result and exits
with another code than 0.
"""

import time

T0 = time.perf_counter()  # process start, as near as Python gets to it

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

from benchmark import harness  # noqa: E402


@dataclass
class Cell:
    name: str
    workload: dict
    conf: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    patches: list = field(default_factory=list)  # tests break the timed path here
    t0: float = 0.0  # the process's start on the perf_counter clock


def load_cell(name: str, seed: int, seconds: float, trace: bool, device, spec=None) -> Cell:
    spec = spec or harness.benchmark_spec()
    entry = harness.cell_entry(spec, name)
    return Cell(name, harness.load_json("workloads", name),
                harness.load_json("configs", entry["config"]),
                harness.load_json("traffic", entry["traffic"]), seed, seconds, trace, device)


def drive(cell: Cell) -> dict:
    loop = importlib.import_module(f"benchmark.loops.{cell.workload['loop']}")
    return loop.run(cell)


def verdict(checks: list[dict]) -> bool:
    def ok(c):
        return c["value"] <= c["limit"] if c["op"] == "<=" else c["value"] >= c["limit"]

    return all(ok(c) for c in checks)


def per_layer(spec: dict, cell: str, obs: dict) -> dict:
    out = {}
    for m in harness.metrics_for(spec, "per_layer", cell):
        value = harness.load_metric(m["name"]).read(obs)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def power_limit():
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return res.stdout.strip().splitlines()[0] if res.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    harness.set_cache_dirs()

    import torch

    spec = harness.benchmark_spec()
    entry = harness.cell_entry(spec, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        harness.log(f"no result: cell {args.workload} needs {entry['chips']} CUDA card(s); "
                    f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
                    f"device_count() = {torch.cuda.device_count()}")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cell = load_cell(args.workload, args.seed, args.seconds, bool(args.trace), device, spec)
    cell.t0 = T0
    out = drive(cell)
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": entry["chips"], "memory_peak_bytes": out["memory_peak_bytes"],
                   "power_limit": power_limit()}
    rc, result = finish(spec, args.workload, bool(args.trace), out, device_info)
    if rc == 0:
        print(json.dumps(result), flush=True)
    return rc


def finish(spec: dict, workload: str, trace: bool, out: dict, device_info: dict):
    """(exit code, result line) of a run whose loop returned ``out``: the
    metrics read, the checks logged, and last the look for JAX, after every
    module that the run loads (the per-layer readers, the trace's
    reduction) has been loaded. A result comes only with exit code 0."""
    obs = out["obs"]
    if trace:
        metrics = per_layer(spec, workload, obs)
    else:
        metrics = {}
        e2e = dict(out["e2e"], setup_s=out["t_open"] - T0)
        for m in harness.metrics_for(spec, "end_to_end", workload):
            if e2e.get(m["name"]) is None:
                harness.log(f"no result: end-to-end metric {m['name']} has no value")
                return 4, None
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    result = {"correct": verdict(out["checks"]), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device_info}
    if trace:
        from benchmark.trace import breakdown

        summary = obs.get("trace")
        if summary:
            device_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
            result["breakdown"] = breakdown(summary)
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"], "op": c["op"]}
                        for c in out["checks"]}
    found = harness.forbidden_loaded()
    if found:
        harness.log(f"no result: the process loaded {found} (compared by top-level name)")
        return 3, None
    for c in out["checks"]:
        harness.log(f"check {c['name']}: {c['value']} (limit {c['op']} {c['limit']})")
    return 0, result


if __name__ == "__main__":
    sys.exit(main())
