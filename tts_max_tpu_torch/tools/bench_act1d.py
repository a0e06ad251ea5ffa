"""Time the port's kernel G (the codec encoder's fused anti-aliased SnakeBeta)
on one CUDA card at the six shapes of a 22 s prompt's encode, and the
acoustic encoder that runs it, for comparing two checkouts in one run on
one card.

    python3 tts_max_tpu_torch/tools/bench_act1d.py [--rows 48,24,12]
    PYTHONPATH=<other checkout> python3 tts_max_tpu_torch/tools/bench_act1d.py

Run by path: ``tts_max_tpu_torch`` (wrapper, CUDA source, build, encoder)
comes from ``PYTHONPATH`` when it is set, else from this checkout, while
the inputs, the timer and the shapes always come from this checkout's
``chip_smoke.py``, so both checkouts see the same inputs. Prints one JSON
line: the package's path, the card (name, power limit), G's median ms per
shape over 20 cold-L2 launches queued behind a spin kernel
(``chip_smoke.Timer``), their sum over one encode's 36 launches, and the
median SM clock (MHz) and power (W) of ``nvidia-smi``'s samples (every
200 ms, the first two dropped) while G runs back to back at block 1 for
2 s, and the median host ms of the acoustic
encoder on request (c)'s 22 s prompt wav
(``EncoderConfig()``, weights from ``chip_smoke``'s seed, device
synchronized; the stage ``chip_smoke.encode_split`` reports). Every output
is checked bitwise equal to the plain version first. ``--rows`` also
times each shape at each given strip length R (a compiled instantiation)
in place of ``act1d.launch_rows``' choice. Without a card it exits 1.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.append(str(ROOT))  # after PYTHONPATH, which may name another checkout

ENCODER_SEED = 2  # chip_smoke.build_main_path's codec encoder


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rows", default="", help="comma-separated strip lengths R")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_act1d: needs a CUDA card", file=sys.stderr)
        return 1
    # this checkout's chip_smoke.py, whatever PYTHONPATH holds
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import tts_max_tpu_torch
    from tts_max_tpu_torch.device import full_fp32
    from tts_max_tpu_torch.models.codec import encoder
    from tts_max_tpu_torch.ops import act1d

    full_fp32()
    timer = cs.Timer()
    gen = torch.Generator(device="cuda").manual_seed(6)
    ms, per_encode = {}, {}
    forced = [int(r) for r in args.rows.split(",") if r]
    rule = getattr(act1d, "launch_rows", None)
    if forced and rule is None:
        raise SystemExit("bench_act1d: --rows needs a wrapper with act1d.launch_rows")
    for label, t, c, n in cs.ENCODER_SHAPES:
        x = torch.randn(1, t, c, generator=gen, device="cuda")
        p = {k: 0.3 * torch.randn(c, generator=gen, device="cuda") for k in ("alpha", "beta")}
        want = act1d.activation1d_fused(x, p)
        for rows in [None, *forced]:
            if rows is not None:
                act1d.launch_rows = lambda b, t, c, rows=rows: rows
            key = label if rows is None else f"{label} R={rows}"
            if not torch.equal(act1d.activation1d_kernel(x, p), want):
                raise AssertionError(f"kernel G {key}: not bitwise equal to the plain version")
            ms[key] = timer.ms(lambda: act1d.activation1d_kernel(x, p))
            name = "rule" if rows is None else f"R={rows}"
            per_encode[name] = per_encode.get(name, 0.0) + n * ms[key]
            if rule is not None:
                act1d.launch_rows = rule
        del x, p, want

    # the SM clock and power while G runs back to back at block 1 for ~2 s
    label, t, c, _ = cs.ENCODER_SHAPES[0]
    x = torch.randn(1, t, c, generator=gen, device="cuda")
    p = {k: 0.3 * torch.randn(c, generator=gen, device="cuda") for k in ("alpha", "beta")}
    sampler = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
         "-lms", "200"], stdout=subprocess.PIPE, text=True)
    t_end = time.perf_counter() + 2.0
    while time.perf_counter() < t_end:
        for _ in range(200):
            act1d.activation1d_kernel(x, p)
        torch.cuda.synchronize()
    sampler.terminate()
    samples = np.array([[float(v) for v in line.split(",")]
                        for line in sampler.communicate()[0].split("\n") if line.strip()][2:])
    del x, p

    cfg = encoder.EncoderConfig()
    params = encoder.init_encoder(cfg, seed=ENCODER_SEED, device="cuda")["acoustic"]
    wav = cs.prompt_wavs()["p22s"]
    padded = torch.from_numpy(encoder.pad_wav_for_encode(wav[None], cfg.hop_length)).cuda()
    runs = []
    with torch.inference_mode():
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            encoder.acoustic_encoder(padded, params, cfg)
            torch.cuda.synchronize()
            runs.append(1e3 * (time.perf_counter() - t0))
    print(json.dumps({"package": str(Path(tts_max_tpu_torch.__file__).parent),
                      "gpu": cs.gpu_line(), "ms": ms, "per_encode_ms": per_encode,
                      "acoustic_ms": float(np.median(runs[1:])), "acoustic_runs_ms": runs,
                      "block1_loop_sm_mhz": float(np.median(samples[:, 0])),
                      "block1_loop_power_w": float(np.median(samples[:, 1]))}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
