"""Time the port's kernel A' (attention's backward) at every row of
``chip_smoke.BWD_CASES`` and a few SFT steps at Llama-3.2-1B width on one
CUDA card, for comparing two checkouts in one run on one card.

    python3 tts_max_tpu_torch/tools/bench_attention_bwd.py
    PYTHONPATH=<other checkout> python3 tts_max_tpu_torch/tools/bench_attention_bwd.py

Run by path: ``tts_max_tpu_torch`` (wrappers, CUDA sources, build, model,
trainer) comes from ``PYTHONPATH`` when it is set, else from this checkout,
while the cases, the inputs (``chip_smoke.bwd_inputs``), the timer
(``chip_smoke.Timer``) and the SFT config (``chip_smoke.write_sft_config``)
always come from this checkout's ``chip_smoke.py``, so both checkouts see
the same work. Prints one JSON line: the package's path, the card (name,
power limit), per case A''s median ms over 20 cold-L2 launches and each
grad's ratio to ``GRAD_TOL`` against the plain backward (reported, not
checked: an older kernel may lie outside), the device time by kernel of
A' and of SDPA's backward on the same inputs at the main shape
(``torch.profiler``, 10 calls each), kernel A at the main shape
with and without its training outputs, the GRAD_TOL ratios of the sharp
row (q x 4) drawn once from each of the generator seeds 0-5 (whether D
from the rounded O shows on a draw depends on the draw), and the SFT run
through ``tts_max_tpu_torch.training.main`` on ``example/configs/sft.json``
(batch 4 x 2048, ``chip_smoke.TRAIN_STEPS`` steps): every step's loss and
seconds, the median ms/step and padded tokens/s of steps 3 on, and the
peak ``max_memory_allocated``. Without a card it exits 1.
"""

from __future__ import annotations

import importlib.util
import json
import re
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.append(str(ROOT))  # after PYTHONPATH, which may name another checkout
TRAIN_DIR = ROOT / "build" / "bench_attention_bwd"
SHARP_SEEDS = range(6)


def _train(cs, steps: int) -> dict:
    """The SFT entry point on this checkout's config for ``steps`` steps."""
    from tts_max_tpu_torch.training import main as train_main

    path, _, _, _ = cs.write_sft_config(str(TRAIN_DIR))
    torch.cuda.reset_peak_memory_stats()
    res = train_main.main(["--config_path", path, "--total_steps", str(steps)])
    peak = torch.cuda.max_memory_allocated()
    shutil.rmtree(TRAIN_DIR)
    secs = [s for _, _, s, _ in res.steps]
    toks = [n for _, _, _, n in res.steps]
    return {"losses": [float(m.loss) for _, m, _, _ in res.steps], "step_s": secs,
            "ms_step": 1e3 * float(np.median(secs[2:])),
            "tokens_s": float(np.median([n / s for n, s in zip(toks[2:], secs[2:])])),
            "peak_gib": peak / 2**30}


def _backward(fwd, bwd, q, k, v, g, kv_len):
    """Kernel A with its training outputs, then a closure that launches A'
    on them. A checkout from before O's residual returns (out, lse) and
    takes no out_lo."""
    res = fwd(q, k, v, True, kv_len, with_lse=True)
    extra = {"out_lo": res[2]} if len(res) == 3 else {}
    return lambda: bwd(q, k, v, res[0], res[1], g, True, kv_len, **extra)


def _by_kernel(fn) -> dict:
    """Mean device ms by kernel name of 10 calls of ``fn``."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    return {re.sub(r"\(.*", "", e.key.replace("(anonymous namespace)::", ""))[:80]:
            e.device_time_total / e.count / 1e3
            for e in prof.key_averages() if e.device_time_total > 0}


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_attention_bwd: needs a CUDA card", file=sys.stderr)
        return 1
    # this checkout's chip_smoke.py, whatever PYTHONPATH holds
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import tts_max_tpu_torch
    from tts_max_tpu_torch.device import full_fp32
    from tts_max_tpu_torch.ops.attention import GRAD_TOL, causal_attention_bwd, grad_tol_ratio
    from tts_max_tpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd

    full_fp32()
    timer = cs.Timer()
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases, fwd, by_kernel = {}, {}, {}
    for (label, b, s, hq, hkv, d, dtype, kv_len, q_scale) in cs.BWD_CASES:
        q, k, v, g = cs.bwd_inputs(gen, b, s, hq, hkv, d, dtype, q_scale)
        run = _backward(flash_attention_fwd, flash_attention_bwd, q, k, v, g, kv_len)
        refs = causal_attention_bwd(q, k, v, g, kv_len=kv_len)
        cases[label] = {"grad_tol_ratios": [grad_tol_ratio(x, r) for x, r in zip(run(), refs)],
                        "ms": timer.ms(run)}
        if label == "main":
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
            o_lib = torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)
            by_kernel = {"kernel": _by_kernel(run), "library": _by_kernel(
                lambda: torch.autograd.grad(o_lib, (qt, kt, vt), g.transpose(1, 2),
                                            retain_graph=True))}
            del qt, kt, vt, o_lib
            fwd = {"with_training_outputs_ms": timer.ms(
                       lambda: flash_attention_fwd(q, k, v, True, None, with_lse=True)),
                   "without_ms": timer.ms(lambda: flash_attention_fwd(q, k, v, True, None))}
        del q, k, v, g, run, refs
    del timer
    sharp = {}
    row = next(r for r in cs.BWD_CASES if r[0] == "sharp q*4")
    for seed in SHARP_SEEDS:
        _, b, s, hq, hkv, d, dtype, kv_len, q_scale = row
        gen = torch.Generator(device="cuda").manual_seed(seed)
        q, k, v, g = cs.bwd_inputs(gen, b, s, hq, hkv, d, dtype, q_scale)
        grads = _backward(flash_attention_fwd, flash_attention_bwd, q, k, v, g, kv_len)()
        refs = causal_attention_bwd(q, k, v, g, kv_len=kv_len)
        sharp[seed] = [grad_tol_ratio(x, r) for x, r in zip(grads, refs)]
    torch.cuda.empty_cache()
    result = {"package": str(Path(tts_max_tpu_torch.__file__).parent), "gpu": cs.gpu_line(),
              "grad_tol": {str(k): v for k, v in GRAD_TOL.items()},
              "kernel_a_bwd": cases, "main_ms_by_kernel": by_kernel, "kernel_a_main": fwd,
              "sharp_seeds": sharp}
    result["sft"] = _train(cs, cs.TRAIN_STEPS)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
