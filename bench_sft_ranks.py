"""Time SFT at Llama-3.2-1B width on one CUDA card alone and through an NCCL
group of world size 1, alternating in one run.

    python3 bench_sft_ranks.py [--pairs 2]

from the root of the repo, beside ``chip_smoke.py``, whose SFT config,
launcher variables and card line it uses.

Each run is ``tts_max_tpu_torch.training.main`` on ``example/configs/sft.json``
as ``chip_smoke.write_sft_config`` writes it (batch 4 x 2048, fsdp, remat,
``chip_smoke.TRAIN_STEPS`` steps), in this process: "alone" with no
launcher (the one-device step), "world1" under torchrun's variables for one
rank (``chip_smoke.nccl_world_of_one``: the mesh step, fsdp's gathers and
reduce-scatters on one block a leaf). Runs alternate alone, world1,
world1, alone, ... Step 5 of each run is traced (``utils/profiling.trace``)
for its device-busy time and the device time of its NCCL kernels and of
its copies. Prints one JSON line: the card (name, power limit), and per
run its kind, losses, step seconds, the median ms/step and padded
tokens/s of steps 3 on but the traced one, peak ``max_memory_allocated``,
and the traced step's wall, busy, NCCL and copy milliseconds. Without a
card it exits 1.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

TRAIN_DIR = Path(__file__).resolve().parent / "build" / "bench_sft_ranks"
TRACED = 5


@contextlib.contextmanager
def _probe_step(record: dict):
    """Trace call ``TRACED`` of either train step (one device or the mesh's)."""
    from tts_max_tpu_torch.training import train_step as ts
    from tts_max_tpu_torch.utils import profiling

    calls = []

    def wrap(fn):
        def step(*args, **kw):
            calls.append(1)
            if len(calls) != TRACED:
                return fn(*args, **kw)
            with profiling.trace(str(TRAIN_DIR / "trace")) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                record["traced_wall_ms"] = 1e3 * (time.perf_counter() - t0)
            record["traced_busy_ms"] = profiling.device_busy_us(prof) / 1e3
            dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            record["traced_nccl_ms"] = sum(e.time_range.elapsed_us() for e in dev
                                           if "nccl" in e.name.lower()) / 1e3
            record["traced_copy_ms"] = sum(e.time_range.elapsed_us() for e in dev
                                           if "memcpy" in e.name.lower()
                                           or "copy" in e.name.lower()) / 1e3
            return out
        return step

    plain, sharded = ts.train_step, ts.ShardedTrainStep.__call__
    ts.train_step, ts.ShardedTrainStep.__call__ = wrap(plain), wrap(sharded)
    try:
        yield
    finally:
        ts.train_step, ts.ShardedTrainStep.__call__ = plain, sharded


def _run(kind: str) -> dict:
    from tts_max_tpu_torch.training import main as train_main

    path, _, _, _ = cs.write_sft_config(str(TRAIN_DIR))
    record = {"kind": kind}
    torch.cuda.reset_peak_memory_stats()
    ranks = cs.nccl_world_of_one() if kind == "world1" else contextlib.nullcontext()
    with ranks, _probe_step(record):
        res = train_main.main(["--config_path", path, "--total_steps", str(cs.TRAIN_STEPS)])
    record["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    shutil.rmtree(TRAIN_DIR)
    secs = [s for _, _, s, _ in res.steps]
    toks = [n for _, _, _, n in res.steps]
    kept = [i for i in range(2, len(secs)) if i + 1 != TRACED]
    record.update(losses=[float(m.loss) for _, m, _, _ in res.steps], step_s=secs,
                  ms_step=1e3 * float(np.median([secs[i] for i in kept])),
                  tokens_s=float(np.median([toks[i] / secs[i] for i in kept])))
    return record


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--pairs", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bench_sft_ranks: needs a CUDA card", file=sys.stderr)
        return 1
    from tts_max_tpu_torch.device import full_fp32
    from tts_max_tpu_torch.ops import cuda_build

    full_fp32()  # as chip_smoke runs the SFT
    cuda_build.build_all()
    order = []
    for i in range(args.pairs):
        order += ["alone", "world1"] if i % 2 == 0 else ["world1", "alone"]
    runs = [_run(kind) for kind in order]
    print(json.dumps({"card": cs.gpu_line(), "traced_step": TRACED, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
