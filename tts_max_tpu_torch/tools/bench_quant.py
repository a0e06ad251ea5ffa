"""Time the weight-only quantized product (``ops/quant_matmul.py``) on one
CUDA card at the shapes ``chip_smoke.py`` checks it, for comparing two
checkouts in one run on one card.

    python3 tts_max_tpu_torch/tools/bench_quant.py [--modes int8,int4-g128] [--rows 1,8,16]
    PYTHONPATH=<other checkout> python3 tts_max_tpu_torch/tools/bench_quant.py

Run by path: ``tts_max_tpu_torch`` comes from ``PYTHONPATH`` when it is set,
else from this checkout; the inputs and the timer come from this
checkout's ``chip_smoke.py``. Prints one JSON line: the package's path,
the card (name, power limit) and, per case (bf16 x), the median ms over 20
cold-L2 launches queued behind a spin kernel (``chip_smoke.Timer``): kn at
every layer shape in each mode (``--modes``; ``--modes ''`` times vd
only) and row count (``--rows``), and vd on Llama-3.2-1B's tied head
window at int8 and int4. ``--reads``
adds, per weight, a plain read of its levels under the same timer
(``amax`` over them as int32): what reading those bytes costs there.
``--splits`` also times each kn case at every K split and tile width the
kernel takes, the launch rule's choice forced (``plan`` replaced). When
the package asks the card for its kn launch rule, the line also holds the
clusters of each size the card holds at once (``cluster_slots``, bf16 x).
Without a card it exits 1.
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
    parser.add_argument("--modes", default="int8,int4,int4-g64,int4-g128")
    parser.add_argument("--rows", default="1,8,16")
    parser.add_argument("--reads", action="store_true", help="also time a plain read of "
                        "each weight's levels")
    parser.add_argument("--splits", action="store_true", help="also time kn at every K split "
                        "and tile width")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_quant: needs a CUDA card", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import tts_max_tpu_torch
    from tts_max_tpu_torch.models import llama
    from tts_max_tpu_torch.models.quantization import quantize_tensor
    from tts_max_tpu_torch.ops import cuda_build
    from tts_max_tpu_torch.ops import quant_matmul as qm

    cuda_build.build_all()
    timer = cs.Timer()
    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = [int(r) for r in args.rows.split(",")]
    ms: dict = {}
    modes = [m for m in args.modes.split(",") if m]
    for label, k, n in cs.QUANT_SHAPES if modes else ():
        w = torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
        xs = torch.randn(max(rows), k, generator=gen, device="cuda").to(torch.bfloat16)
        for mode in modes:
            p = quantize_tensor(w, 0, **cs.QUANT_MODES[mode])
            for m in rows:
                x = xs[:m]
                ms[f"{label} {mode} m={m}"] = timer.ms(lambda: qm.quant_matmul(x, p))
                if args.splits:
                    ms.update(splits(qm, timer, label, mode, x, p))
            if args.reads:
                lv = p["q4" if "q4" in p else "q"]
                ms[f"{label} {mode} read"] = timer.ms(lambda: lv.view(torch.int32).amax())
            del p
        del w
    cfg = llama.llama32_1b_config()
    lo, size = 262, 65542
    emb = torch.randn(cfg.vocab_size, cfg.dim, generator=gen, device="cuda") * 0.02
    hs = torch.randn(max(rows), cfg.dim, generator=gen, device="cuda").to(torch.bfloat16)
    for bits in (8, 4):
        win = llama.slice_logits_head(
            {"embed": {"embedding": quantize_tensor(emb, 1, bits=bits)}}, cfg, lo, size)
        for m in rows:
            h = hs[:m]
            ms[f"1B tied head int{bits} m={m}"] = timer.ms(lambda: qm.quant_tied_logits(h, win))
        if args.reads:
            lv = win["q4" if bits == 4 else "q"]
            ms[f"1B tied head int{bits} read"] = timer.ms(lambda: lv.view(torch.int32).amax())
        del win
    out = {"package": str(Path(tts_max_tpu_torch.__file__).parent), "gpu": cs.gpu_line(),
           "ms": ms}
    if hasattr(qm, "cluster_slots"):
        out["slots"] = {f"bits={b} grouped={int(gr)} nt={nt} tile={tile}": [
            qm.cluster_slots(0, b, gr, 1, nt, tile, c) for c in qm.CLUSTERS]
            for b, gr in ((8, False), (4, False), (4, True)) for nt in (1, 2)
            for tile in qm.TILE_BYTES}
    print(json.dumps(out), flush=True)
    return 0


def splits(qm, timer, label: str, mode: str, x, p) -> dict:
    """kn on x and p at every K split and tile width it takes."""
    plan, group = qm.plan, p["scale"].shape[0] if p["scale"].ndim == 2 else None
    k = x.shape[-1]
    group = k // group if group else None
    out = {}
    try:
        for tile in qm.TILE_BYTES:
            for cs in qm.CLUSTERS:
                if k % (cs * qm.STAGE_ROWS) or (group and (k // cs) % group):
                    continue
                qm.plan = lambda m, k_, n, bits, g=None, slots=None, cs=cs, tile=tile: (
                    qm.row_tiles(m), cs, -(-(n * bits // 8) // tile), tile)
                out[f"{label} {mode} m={x.shape[0]} tile={tile} cs={cs}"] = timer.ms(
                    lambda: qm.quant_matmul(x, p))
    finally:
        qm.plan = plan
    return out


if __name__ == "__main__":
    sys.exit(main())
