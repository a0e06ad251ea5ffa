"""Readings from which a cell's ``correct`` limits are set (not run by the
benchmark's own runs):

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--seconds 12] [--fault <name>]

For every seed, in one process: one run of the cell at its own load with a
short window, and the numbers its checks compared. For each control seed,
the same run's outputs read again by the control (the reference in the
precision below the configuration's). With ``--fault`` the program runs
with one of its loop's ``FAULTS`` planted in the timed path. One JSON line a seed, then a summary
with the program's largest and the control's smallest reading per number.
"""

import argparse
import importlib
import json
import sys

import torch

from benchmark import harness
from benchmark.run import drive, load_cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=12.0)
    p.add_argument("--fault", default="",
                   help="run the program with this fault of the loop's FAULTS planted")
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    if not torch.cuda.is_available():
        harness.log("calibration needs a CUDA card")
        return 2
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    program: dict[str, list] = {}
    control: dict[str, list] = {}
    for seed in seeds:
        cell = load_cell(args.workload, seed, args.seconds, False, device)
        module = importlib.import_module(f"benchmark.loops.{cell.workload['loop']}")
        if args.fault:
            cell.patches.append(module.FAULTS[args.fault])
        out = drive(cell)
        line = {"seed": seed, "program": {c["name"]: c["value"] for c in out["checks"]}}
        for k, v in line["program"].items():
            program.setdefault(k, []).append(v)
        if seed in controls:
            line["control"] = module.control_reading(cell, out["compared"])
            for k, v in line["control"].items():
                control.setdefault(k, []).append(v)
        print(json.dumps(line), flush=True)
        del out
        torch.cuda.empty_cache()
    print(json.dumps({"summary": {
        "program_max": {k: max(v) for k, v in program.items()},
        "control_min": {k: min(v) for k, v in control.items()},
        "program": program, "control": control}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
