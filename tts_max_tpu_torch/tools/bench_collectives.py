"""The host and device cost of one tensor-parallel collective call on the
card, at world size 1 on NCCL.

    python3 -m tts_max_tpu_torch.tools.bench_collectives [--calls 2000] [--depth 40]

It joins an NCCL group of one rank (torchrun's variables on a free local
port, set here when no launcher set them) and times ``--calls`` calls of
``collectives.tensor_exit`` on an engine decode step's row-parallel output
([8, 2048] bf16, the 1B model's width at 8 slots) and of SFT's ([4, 2048,
2048] bf16): the host clock per call with the device synchronized after the
loop, and the device time per call between CUDA events. Each is taken from
a shallow Python stack and from one ``--depth`` frames deep (a serving
loop's depth), since ProcessGroupNCCL may record each call's Python stack.
Beside them, an in-place ``add_`` of the same tensor (one kernel launch).
One JSON line; the card's name and power limit on the line before.
``TORCH_NCCL_TRACE_BUFFER_SIZE`` and the other ``TORCH_NCCL_*`` variables
of the environment are printed with it: run it twice, with and without
one, to compare.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import time

import torch


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not measured"


def _deep(depth: int, fn):
    return fn() if depth <= 0 else _deep(depth - 1, fn)


def _time(fn, calls: int) -> tuple[float, float]:
    """(host us a call, device us a call)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e6 / calls
    return host, start.elapsed_time(end) * 1e3 / calls


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--calls", type=int, default=2000)
    parser.add_argument("--depth", type=int, default=40)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_collectives: needs a CUDA card")
    from tts_max_tpu_torch.parallel import collectives, mesh as pmesh

    if "RANK" not in os.environ:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    env = pmesh.initialize_distributed("cuda")
    try:
        group = pmesh.build_mesh((1, 1, env.world_size), "tp").group(pmesh.TENSOR_AXIS)
        out = {"env": {k: v for k, v in os.environ.items() if k.startswith("TORCH_NCCL")},
               "calls": args.calls, "depth": args.depth}
        for name, shape in (("decode [8, 2048]", (8, 2048)),
                            ("sft [4, 2048, 2048]", (4, 2048, 2048))):
            x = torch.randn(shape, device="cuda").to(torch.bfloat16)
            calls = args.calls if len(shape) == 2 else max(1, args.calls // 20)
            row = {}
            for label, fn in (("tensor_exit", lambda: collectives.tensor_exit(x, group)),
                              ("add_", lambda: x.add_(0.0))):
                host, dev = _time(fn, calls)
                deep_host, deep_dev = _time(lambda: _deep(args.depth, fn), calls)
                row[label] = {"host_us": host, "device_us": dev,
                              "deep_host_us": deep_host, "deep_device_us": deep_dev}
            out[name] = row
    finally:
        pmesh.destroy_distributed(env)
    print(_card(), flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
