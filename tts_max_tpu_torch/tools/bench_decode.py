"""Time the port's decode-attention kernels (B, C and the paged kernel) on
one CUDA card at the shapes ``chip_smoke.py`` times them, for comparing two
checkouts in one run on one card.

    python3 tts_max_tpu_torch/tools/bench_decode.py [--rows 64,128,...]
    PYTHONPATH=<other checkout> python3 tts_max_tpu_torch/tools/bench_decode.py

Run by path: ``tts_max_tpu_torch`` (wrappers, CUDA sources, build) comes
from ``PYTHONPATH`` when it is set, else from this checkout, while the
inputs, the timer and the cases always come from this checkout's
``chip_smoke.py``, so both checkouts see the same inputs. Prints one JSON
line: the package's path, the card (name, power limit) and, per case, the
kernel's median ms over 20 cold-L2 launches queued behind a spin kernel
(``chip_smoke.Timer``). ``--rows`` also times kernel B at e3's shape and at
batch 1 with each given rows-per-split (a multiple of 32) in place of
``flash_decode.num_splits``' choice. Without a card it exits 1.
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

B1_T, B1_LEN = 1536, 1359  # request (c)'s bucket + 256 and a mid-decode length


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rows", default="", help="comma-separated rows per split for B")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_decode: needs a CUDA card", file=sys.stderr)
        return 1
    # this checkout's chip_smoke.py, whatever PYTHONPATH holds
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import tts_max_tpu_torch
    from tts_max_tpu_torch.ops import cuda_build
    from tts_max_tpu_torch.ops import flash_decode as fd
    from tts_max_tpu_torch.ops import paged_attention as pa
    from tts_max_tpu_torch.ops.flash_decode import flash_decode_attention
    from tts_max_tpu_torch.ops.ragged_decode import ragged_decode_attention

    cuda_build.build_all()
    timer = cs.Timer()
    gen = torch.Generator(device="cuda").manual_seed(2)
    ms = {}

    def contiguous(label, fn, b, t, d, lens, quant=False, dtype=torch.bfloat16):
        q, kc, vc, lengths = cs._decode_inputs(gen, b, t, d, lens, quant, False, dtype=dtype)
        ms[label] = timer.ms(lambda: fn(q, kc, vc, lengths))

    contiguous("B e3", flash_decode_attention, 8, 2048, 64, cs.E3_LENS)
    contiguous("B e3 int8", flash_decode_attention, 8, 2048, 64, cs.E3_LENS, quant=True)
    contiguous("B B=1", flash_decode_attention, 1, B1_T, 64, [B1_LEN])
    contiguous("C e3", ragged_decode_attention, 8, 2048, 64, cs.E3_LENS)
    contiguous("C B=1", ragged_decode_attention, 1, B1_T, 64, [B1_LEN])
    contiguous("C e3 D=128", ragged_decode_attention, 8, 2048, 128, cs.E3_LENS)
    contiguous("C e3 fp32", ragged_decode_attention, 8, 2048, 64, cs.E3_LENS,
               dtype=torch.float32)
    for label, b, lens, quant in (("paged D main", 8, cs.PAGED_MAIN_LENS, False),
                                  ("paged D main int8", 8, cs.PAGED_MAIN_LENS, True),
                                  ("paged D B=1", 1, [1358], False)):
        q, kp, vp, table, lengths = cs._paged_inputs(gen, b, 64, lens, quant)
        k0, v0 = cs._layer(kp, 0), cs._layer(vp, 0)
        ms[label] = timer.ms(
            lambda: pa.paged_decode_attention_dense(q, k0, v0, table, lengths))
    for rows in [int(r) for r in args.rows.split(",") if r]:
        fd.num_splits = lambda b, hkv, t, device, rows=rows: (-(-t // rows), rows)
        contiguous(f"B e3 rows={rows}", flash_decode_attention, 8, 2048, 64, cs.E3_LENS)
        contiguous(f"B B=1 rows={rows}", flash_decode_attention, 1, B1_T, 64, [B1_LEN])
    print(json.dumps({"package": str(Path(tts_max_tpu_torch.__file__).parent),
                      "gpu": cs.gpu_line(), "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
