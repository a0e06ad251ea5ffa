#!/usr/bin/env python3
"""Where the time goes in one synthesis request through the PyTorch/CUDA port.

    python3 tools/profile_torch_synthesis.py [--request c] [--max-tokens 64]

On one CUDA card, with the model, stub encoder and requests of
``chip_smoke.py``'s main path (Llama-3.2-1B and the default Vocos decoder,
random weights from its seeds): one warm-up request, then the same request
profiled through ``LocalTtsModel.synthesize_speech``. Prints the request's
phases (host clock, device synchronized), the device's busy and idle share
over the request (the union of kernel intervals in the ``torch.profiler``
trace), and the kernels by total device time, then one JSON line with the
same numbers. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import REQUESTS, build_main_path, gpu_line, synthesize  # noqa: E402
from tts_max_tpu_torch.core import tokenization  # noqa: E402
from tts_max_tpu_torch.inference.synthesize import InferenceSettings  # noqa: E402


def busy_ms(events) -> float:
    """Union of the device kernel intervals, in ms."""
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3  # us -> ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--request", choices=[r[0][0] for r in REQUESTS], default="c",
                    help="which of chip_smoke.py's requests to profile")
    ap.add_argument("--max-tokens", type=int, default=64)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = gpu_line()
    print(f"gpu: {card}; torch {torch.__version__}")

    tok = tokenization.build_byte_tokenizer()
    model, _, _, _ = build_main_path(tok, tokenization.speech_vocab(tok))
    settings = InferenceSettings(max_tokens=args.max_tokens)
    request = next(r for r in REQUESTS if r[0][0] == args.request)

    synthesize(model, settings, request)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = synthesize(model, settings, request)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy = busy_ms(prof.events())
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = (e.self_device_time_total / 1e3, e.count)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]

    steps = max(res.decode_steps, 1)
    print(f"request {request[0]}: {res.decode_steps} decode steps; wall "
          f"{wall_ms:.2f} ms (profiler on); prefill {1e3 * res.prefill_time:.2f} ms, "
          f"decode {1e3 * res.decode_time:.2f} ms "
          f"({1e3 * res.decode_time / steps:.3f} ms/step), codec decode "
          f"{1e3 * res.decoding_time:.2f} ms")
    print(f"device busy {busy:.2f} ms of {wall_ms:.2f} ms: idle share "
          f"{1 - busy / wall_ms:.4f}")
    print("kernels by device time (ms, launches):")
    for name, (ms, n) in top:
        print(f"  {ms:10.3f} {n:7d}  {name[:110]}")
    print(json.dumps({
        "gpu": card, "request": request[0], "decode_steps": res.decode_steps,
        "wall_ms": wall_ms, "prefill_ms": 1e3 * res.prefill_time,
        "decode_ms_per_step": 1e3 * res.decode_time / steps,
        "codec_ms": 1e3 * res.decoding_time, "device_busy_ms": busy,
        "idle_share": 1 - busy / wall_ms,
        "top_kernels": [{"name": n, "ms": ms, "launches": c} for n, (ms, c) in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
