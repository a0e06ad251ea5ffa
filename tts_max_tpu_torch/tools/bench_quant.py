"""Time the weight-only quantized product (``ops/quant_matmul.py``) on one
CUDA card at the shapes ``chip_smoke.py`` checks it, for comparing launch
rules or two checkouts in one run on one card.

    python3 tts_max_tpu_torch/tools/bench_quant.py [--targets 264,1056] [--modes int8,int4-g128]
    PYTHONPATH=<other checkout> python3 tts_max_tpu_torch/tools/bench_quant.py

Run by path: ``tts_max_tpu_torch`` comes from ``PYTHONPATH`` when it is set,
else from this checkout; the inputs and the timer come from this
checkout's ``chip_smoke.py``. Prints one JSON line: the package's path,
the card (name, power limit) and, per case (shape, mode, rows; bf16 x),
the kernel's median ms over 20 cold-L2 launches queued behind a spin kernel
(``chip_smoke.Timer``), for each ``--targets`` value of
``quant_matmul.TARGET_BLOCKS`` (the launch rule's grid size; default: the
package's own). Without a card it exits 1.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.append(str(ROOT))  # after PYTHONPATH, which may name another checkout


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--targets", default="", help="comma-separated TARGET_BLOCKS values")
    parser.add_argument("--modes", default="int8,int4,int4-g64,int4-g128")
    parser.add_argument("--rows", default="1,8,16")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_quant: needs a CUDA card", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import tts_max_tpu_torch
    from tts_max_tpu_torch.models.quantization import quantize_tensor
    from tts_max_tpu_torch.ops import cuda_build
    from tts_max_tpu_torch.ops import quant_matmul as qm

    cuda_build.build_all()
    timer = cs.Timer()
    gen = torch.Generator(device="cuda").manual_seed(8)
    targets = [int(t) for t in args.targets.split(",") if t] or [qm.TARGET_BLOCKS]
    rows = [int(r) for r in args.rows.split(",")]
    ms: dict = {}
    for label, k, n in cs.QUANT_SHAPES:
        w = torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
        xs = torch.randn(max(rows), k, generator=gen, device="cuda").to(torch.bfloat16)
        for mode in args.modes.split(","):
            p = quantize_tensor(w, 0, **cs.QUANT_MODES[mode])
            for m in rows:
                x = xs[:m]
                for t in targets:
                    qm.TARGET_BLOCKS = t
                    ms[f"{label} {mode} m={m} target={t}"] = timer.ms(
                        lambda: qm.quant_matmul(x, p))
            del p
        del w
    print(json.dumps({"package": str(Path(tts_max_tpu_torch.__file__).parent),
                      "gpu": cs.gpu_line(), "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
