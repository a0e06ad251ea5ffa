#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

From the root of a checkout, with one CUDA card. It builds the port's CUDA
kernels from ``tts_max_tpu_torch/csrc`` with nvcc (one process per source,
in parallel) and holds each against its plain PyTorch version on the card,
printing the earlier kernels' times beside the redesigned ones' (``PREV_MS``),
and A, A', B, C and the paged kernel again at a tensor-parallel rank's
heads of Llama-3.2-1B under TP 2, 4 and 8 (16/4, 8/2, 4/1; ``TP_RANK_HEADS``):
kernel A (prefill: bf16 on the tensor cores, fp32 on the CUDA cores, batch
1 and 8, kv_len < S, n_rep 1 and 8), kernel A' (attention's backward, for
training: SFT's layer at batch 4 x 2048, fp32, D = 128, a tail, kv_len < S,
n_rep 1, a sharp softmax, a ragged S = 130, batch 8, draft distillation's
layer at batch 8 x 512, the LoRA step's and the GRPO update's (at batch 2
x 3072; A at r1's 8 x 3072), beside SDPA's backward;
its library's SASS must hold tensor-core and cp.async instructions; and A
with its log-sum-exp and residual writes beside A without them), kernel B
(contiguous decode), kernel C (ragged decode,
the contiguous engine's), the paged decode kernel behind its three entry
points (D, E, F) and D's stacked form (bf16 and int8 pools, block sizes
16, 48 and 64), and kernel G (the codec encoder's
anti-aliased SnakeBeta) at the six shapes of a 22 s prompt's encode, at
edge cases and at every compiled strip length, logging whether each output
is bitwise its plain version's and G's SASS instructions an element, and
the weight-only quantized product (kn: every layer kernel of Llama-3.2-1B
and Llama-3.1-8B in int8, int4, int4-g64 and int4-g128 at 1, 8 and 16
rows, the untied 8B head window; vd: the tied 1B head window, int8 and
int4), beside cuBLAS on the dequantized weight and the split-K CUDA-core
kernel it replaced, every case launched twice and held bitwise equal, the
library's SASS required to hold HMMA (tensor-core) instructions. It checks the port's GPU
path against its CPU path on a small model, through ``generate`` (also
quantized: int8 and int4-g64, greedy ids) and through the paged engine
under each paged entry point, on a small codec encoder, through one fp32
train step (kernels A and A' against the plain versions: loss, every grad,
the updated params), through one tiny GAN step (cuDNN conv2d, cuFFT) and
through the mesh train step in an NCCL group of world size 1 (fsdp and
dp, against the one-device step, with the collectives it must make) and
through the RLHF slice's small checks (a GRPO loss, its grads and one step;
a small Whisper's greedy tokens; a DNSMOS-shaped ONNX graph). Then it trains Llama-3.2-1B at full width through the
SFT entry point (``tts_max_tpu_torch.training.main`` on
``example/configs/sft.json``, 8 steps on a seeded dataset the port's
``codes_io`` writes, a checkpoint, the final model, a one-step resume),
under torchrun's variables for one rank, so that it trains through an NCCL
group of world size 1 with sft.json's fsdp strategy (every split leaf
gathered where it is used, its grads reduce-scattered, the checkpoint and
final model gathered); t1 then trains the same config under ``strategy:
tp`` for 4 steps in an NCCL group of world size 1 (a tensor axis of one
rank that still splits every rule-split leaf into one block: the
row-parallel sums, the entries' grad sums and the vocab-parallel cross
entropy's reductions all made, each count held to ``tp_sft_collectives``),
its losses held to the fsdp run's (``TP_LOSS_RTOL``), and resumes one step
under ``fsdp`` from its checkpoint. It
drives the main paths at
the full width of Llama-3.2-1B, the full Vocos decoder and the full codec
encoder with wav2vec-BERT 2.0, random weights from seeds: text and a 5 s or
22 s prompt wav to waveform through ``LocalTtsModel.synthesize_speech`` (the
prompt encode split into host features, w2v-bert and the acoustic encoder),
the serving engines (``inference/engine.py``: paged with prefix caching,
paged int8 KV, contiguous, paged under the ``grid`` entry point, then with
prefill-ahead: contiguous beside the same requests without it, and paged
with the prefix cache; and e-tp: the contiguous bf16, contiguous int8-KV
and paged engines, and ``generate``, each with ``mesh=`` a ``(1, 1, 1)``
tensor-parallel mesh in an NCCL group of world size 1 beside the same
without a mesh, greedy ids identical), vocoding every completion, speculative decoding
(``inference/speculative.py``: fp32 with the target as its own draft, whose
ids must equal greedy ``generate``'s, and bf16 with a 2-layer draft beside
plain ``generate``), and the three serving CLIs (``tts_max_tpu_torch/tools``:
single shot, a JSONL batch, the HTTP server with a streamed request) on an
HF directory of the main path's weights that the port's writer stores in
BF16, then the batch CLI with ``--quantize int4-g128`` on it and the single
shot on a pre-quantized int8 dir of the same weights. The tools from training
to serving run at the same width: v1 writes 40 samples with
``example/make_synthetic_samples.py`` and vectorizes them
(``tools.data_vectorizer``, the full-width seeded encoder at batch 8, kernel
G; ``tools.data_merger``); c1 converts the SFT's final model with a seeded
LoRA adapter into an HF dir and a pre-quantized int8 dir
(``tools.convert_checkpoint``) and serves 128 tokens from each; d1 distills
a 4-layer draft from that dir on v1's dataset (``tools.distill_draft``, batch
8 x 512, kernels A and A'), and sp3 decodes speculatively with both read
from their dirs; l1 takes one LoRA forward and backward at batch 2 x 2048;
q1 writes seeded full-width codec checkpoints, with which the SFT's
one-step resume through ``training.main`` runs prompt-continuation quality
validation, then runs the random-phrases validator on the trained weights;
qq measures quantization quality
(``tools.quant_quality``, int8 and int4-g128, kernel Q); g1 trains the
codec decoder as a GAN at full width (``training.codec.gan_loop``, 8 steps
on v1's dataset from q1's decoder checkpoint as written, data-parallel
through an NCCL group of world size 1, no host
sync inside a step, one step traced by ``utils/profiling.trace`` for its
device-busy share); r1 runs two GRPO steps through
``training.rlhf.main`` on ``example/configs/rlhf.json`` (one prompt a step,
completions of up to its 1792 tokens, fp32 master weights)
from c1's HF dir (the fixture tokenizer, extended to 193856 ids, written
in), on v1's dataset, with q1's decoder and every reward backed by a
full-width seeded model (Whisper large-v3 with a Whisper-shaped tokenizer,
WavLM-Large + ECAPA, two DNSMOS-shaped ONNX graphs), and r1e one step with
the rollouts through the contiguous engine (kernel C); h1, last, fine-tunes from the serving BF16 HF dir with
the repository's Llama-3-style ``tokenizer.json`` copied in
(``training.main``, 5 steps; the tokenizer's golden ids checked). A tiny
GAN step runs on the card and the CPU among the small-model checks.
Launch counters,
set to 0 before each path and read after it, must equal what that path's
requests and the engines' own counts imply; so must the collectives'
counters (``parallel/collectives.py``: ``counts()`` and ``counts_tp()``)
after the SFT runs, t1, g1 and e-tp. RLHF's trainer/sampler topology
(``training/rlhf/topology.py``) needs two ranks on distinct cards, which
this one-card machine does not have: it is not run here (the gloo tests
hold it to the JAX package).
The port's C++ host library (``tts_max_tpu_torch/native``: the byte
tokenizer's encode, the WER reward's edit distance) is built with this
machine's g++ before anything encodes; the synthesis path, the engines (each
request tokenized as a server does) and the SFT run must make at least one
native encode a request or fetched sample, and r1 one native edit distance
for each WER reward with a reference. Last, host_native holds the native
encode against ``encode_plain`` on every text the paths encoded and on
seeded random strings, and the native edit distance against
``edit_distance_plain`` on r1's pairs and seeded sequences, and times both
on the host; its JSON line (``{"host_native": ...}``, with the card and
the host CPU) comes before the kernels' summary.
The next-to-last lines are a JSON summary of the kernels and the card's
name and power limit; the last line is ``{"ok": true, "device": {...}}``.
Any failed check raises, so the run ends with a nonzero exit and no result
line. Without a CUDA card it exits 1 at once. It imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import heapq
import json
import os
import re
import struct
import subprocess
import sys
import time
import traceback
import types
import warnings

import numpy as np
import torch

PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # H100 SXM, dense
PEAK_BYTES = 3.35e12
L2_FLUSH_BYTES = 256 << 20
SPIN_CYCLES_PER_S = 2e9  # at or above the H100's SM clock: a spin never falls short


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


class Timer:
    """Median device time of ``fn`` over ``iters`` launches, each between
    its own pair of CUDA events, with L2 flushed before every launch (the
    main path finds a layer's cache cold: a decode step reads gigabytes of
    weights between two reads of it).

    Every launch is queued behind a spin kernel (``torch.cuda._sleep``) long
    enough for the host to enqueue them all, so the card never waits on the
    host between two events: the time is the device's, not the wrapper's
    Python (which an idle card would otherwise count)."""

    def __init__(self):
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 20) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.flush.zero_()
        fn()
        host_s = time.perf_counter() - t0  # host time to enqueue one launch
        torch.cuda.synchronize()
        torch.cuda._sleep(int(SPIN_CYCLES_PER_S * 2 * iters * (host_s + 1e-4)))
        events = []
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in events]))


def _sass(lib) -> str | None:
    """``cuobjdump -sass`` of a built library, None without cuobjdump."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(cuobjdump):
        return None
    return subprocess.run([cuobjdump, "-sass", str(lib)], check=True, capture_output=True,
                          text=True, timeout=300).stdout


SASS_OPS = ("HMMA", "LDGSTS", "LDSM")


def sass_counts(lib) -> dict | None:
    """How many lines of a built library's SASS (over all its kernels) hold
    tensor-core (HMMA), cp.async (LDGSTS) and ldmatrix (LDSM) instructions,
    as ``grep -c`` counts them; None without cuobjdump."""
    text = _sass(lib)
    if text is None:
        return None
    lines = text.splitlines()
    return {op: sum(op in line for line in lines) for op in SASS_OPS}


def _sass_functions(text: str) -> dict:
    """{kernel: [instruction, ...]} from ``cuobjdump -sass`` output, each
    instruction as (address, text)."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def _opcode(text: str) -> str:
    return (text.split()[1] if text.startswith("@") else text.split()[0]).split(".")[0]


def _shortest_loop_path(ins) -> list:
    """The instructions of one trip round the storing loop (a backward
    branch whose range holds an STG) with the fewest instructions on its
    shortest path from head to latch: the interior strip loop with every
    sine on its fast path (the slow path and the edge loop take more)."""
    index = {a: i for i, (a, _) in enumerate(ins)}

    def target(t):
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", t)
        return None if m is None else index.get(int(m.group(1), 16))

    def succ(i):
        t = ins[i][1]
        j = target(t)
        if j is not None:
            return [j, i + 1] if t.startswith("@") else [j]
        return [] if _opcode(t) == "EXIT" and not t.startswith("@") else [i + 1]

    best = []
    for latch, (_, t) in enumerate(ins):
        head = target(t)
        if head is None or head > latch or not any(
                _opcode(u) == "STG" for _, u in ins[head:latch + 1]):
            continue
        dist, prev, heap = {head: 1}, {}, [(1, head)]
        while heap:
            d, j = heapq.heappop(heap)
            if j == latch or d > dist[j]:
                continue
            for k in succ(j):
                if head <= k <= latch and d + 1 < dist.get(k, 1 << 30):
                    dist[k], prev[k] = d + 1, j
                    heapq.heappush(heap, (d + 1, k))
        if latch in dist and (not best or dist[latch] < len(best)):
            path, j = [latch], latch
            while j != head:
                j = prev[j]
                path.append(j)
            best = [ins[j][1] for j in reversed(path)]
    return best


def act1d_sass() -> tuple[dict, dict]:
    """Kernel G's SASS (cuobjdump): per compiled R, the instructions an
    element on the interior strip loop's path when every sine takes the
    fast path (a trip is 6 rows of one channel) and the FFMAs among them
    (the sine's own); and the LDS / STS / BAR lines in the whole library
    (0: no shared memory, no barrier). Empty without cuobjdump."""
    from tts_max_tpu_torch.ops import cuda_build

    text = _sass(cuda_build.library_path("act1d"))
    if text is None:
        return {}, {}
    funcs = _sass_functions(text)
    per_elem = {}
    for name, ins in funcs.items():
        path = _shortest_loop_path(ins)
        rows = int(re.search(r"ILi(\d+)E", name).group(1))
        per_elem[rows] = (len(path) / 6, sum(_opcode(t) == "FFMA" for t in path) / 6)
    shared = {op: sum(_opcode(t) == op for ins in funcs.values() for _, t in ins)
              for op in ("LDS", "STS", "BAR")}
    return per_elem, shared


def sm_clock_max_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         check=True, capture_output=True, text=True, timeout=60).stdout
    return 1e6 * float(out.split()[0])


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(out: torch.Tensor, ref: torch.Tensor, what: str) -> tuple[float, str]:
    """Raises unless out is finite and within ``KERNEL_TOL`` of its plain
    version ref: |out - ref| <= atol + rtol |ref| everywhere. Returns the
    max abs error and the tolerance as text."""
    from tts_max_tpu_torch.ops.attention import KERNEL_TOL

    rtol, atol = KERNEL_TOL[ref.dtype]
    err = (out.float() - ref.float()).abs()
    ratio = float((err / (atol + rtol * ref.float().abs())).max())
    if not (ratio <= 1.0 and bool(torch.isfinite(out).all())):
        raise AssertionError(f"{what}: max abs err {float(err.max()):.3e}, "
                             f"{ratio:.2f}x the tolerance")
    return float(err.max()), f"tol {atol:.0e} + {rtol:.4g}|ref|, {ratio:.2f}x"


# --- kernel A -----------------------------------------------------------------


def attention_bound_ms(b, s, hq, hkv, d, dtype, kv_len=None,
                       causal=True) -> tuple[float, str]:
    """Least time for prefill attention: 4 * Hq * D FLOPs per (query, key)
    pair with key < kv_len (and key <= query when causal), against the
    bytes of q, k, v read once and the output written once."""
    kv_len = s if kv_len is None else kv_len
    pairs = sum(min(i + 1, kv_len) for i in range(s)) if causal else s * kv_len
    flops = 4.0 * b * hq * d * pairs
    nbytes = (2 * b * s * hq * d + 2 * b * s * hkv * d) * torch.finfo(dtype).bits // 8
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


# The earlier kernels' times at the same shapes (the CUDA-core kernels A, B,
# C and the paged kernel on decode_split.cuh, and G's shared-memory
# stencil; PERF.md section 6, one H100 80GB HBM3 at 700 W), printed in the
# per-case lines beside this run's:
# (kernel, case) -> ms
PREV_MS = {
    ("B", "e3"): 0.1137, ("B", "main"): 0.0288,
    ("C", "main (e3)"): 0.0863, ("C", "B=1 request c"): 0.0847, ("C", "fp32"): 0.1636,
    ("C", "D=128"): 0.2390,
    ("A", "S=137"): 0.0316, ("A", "S=1024"): 0.3187, ("A", "S=2048"): 1.0047,
    ("A", "D=128 S=1024"): 0.5883, ("A", "fp32 S=1024"): 0.3358, ("A", "main"): 0.4632,
    ("D", "main"): 0.1400, ("E", "main"): 0.1399, ("F", "main"): 0.1403,
    ("D", "main int8"): 0.1362, ("E", "main int8"): 0.1357, ("F", "main int8"): 0.1359,
    ("D", "D=128"): 0.1500, ("E", "D=128"): 0.1497, ("F", "D=128"): 0.1498,
    ("D", "D=128 int8"): 0.1487, ("E", "D=128 int8"): 0.1497, ("F", "D=128 int8"): 0.1497,
    ("D", "B=1"): 0.0815, ("E", "B=1"): 0.0321, ("F", "B=1"): 0.0323,
    ("G", "block 1"): 0.1985, ("G", "block 2"): 0.1887, ("G", "block 3"): 0.1891,
    ("G", "block 4"): 0.1004, ("G", "block 5"): 0.0558, ("G", "final"): 0.0286,
    # the quantized product's first kernel (split-K on the CUDA cores), bf16 x
    ("Q", "1B w_gate/w_up int8 m=1"): 0.0213, ("Q", "1B w_gate/w_up int4-g128 m=1"): 0.0190,
    ("Q", "1B wq/wo int8 m=1"): 0.0131, ("Q", "1B wk/wv int8 m=1"): 0.0115,
    ("Q", "8B w_gate/w_up int8 m=1"): 0.0518, ("Q", "8B w_gate/w_up int4-g128 m=1"): 0.0455,
    ("Q", "1B w_gate/w_up int8 m=16"): 0.0462, ("Q", "1B w_gate/w_up int4-g128 m=16"): 0.0372,
    ("Q", "1B tied head int8 m=1"): 0.0601, ("Q", "1B tied head int8 m=8"): 0.1679,
    ("Q", "1B tied head int8 m=16"): 0.3767,
    # kernel A''s first design (CUDA cores, fp32 math)
    ("A'", "main"): 11.414, ("A'", "fp32 S=1024"): 1.3723, ("A'", "D=128 S=1024"): 2.2485,
    ("A'", "S=1000"): 3.4368, ("A'", "kv_len<S"): 1.0774, ("A'", "n_rep 1"): 0.9905,
}


# a rank's query / KV heads of Llama-3.2-1B (32 / 8) under TP 2, 4 and 8:
# the shapes kernels A, A', B, C and D run at on a rank of a tensor-parallel
# mesh (parallel/tensor.py)
TP_RANK_HEADS = [(f"TP{t} rank {32 // t}/{8 // t}", 32 // t, 8 // t) for t in (2, 4, 8)]


def _prev(kernel: str, case: str) -> str:
    ms = PREV_MS.get((kernel, case))
    return "n/a" if ms is None else f"{ms:.4f}"


def check_kernel_a(timer: Timer, main_s: int) -> dict:
    """Kernel A against its plain version and beside SDPA: the main path's
    prefill (request (c)'s bucket), an engine group prefill of 8 such
    prompts, S = 137 and 2048, D = 128, fp32 (the CUDA-core path), n_rep 1
    and 8, kv_len < S causal and not, and the layers of draft distillation
    (d1), of the LoRA step (l1) and of the GRPO update (r1, 8 x 3072)."""
    from tts_max_tpu_torch.ops import attention
    from tts_max_tpu_torch.ops.flash_attention import flash_attention

    log("kernel A: flash_attention vs ops.attention.causal_attention "
        "(plain, fp32 math, TF32 off); library = F.scaled_dot_product_attention "
        "(with a boolean mask where kv_len < S); prev = the CUDA-core kernel")
    bf = torch.bfloat16
    cases = [  # (label, B, S, Hq, Hkv, D, dtype, causal, kv_len)
        ("S=137", 1, 137, 32, 8, 64, bf, True, None),
        ("S=1024", 1, 1024, 32, 8, 64, bf, True, None),
        ("S=2048", 1, 2048, 32, 8, 64, bf, True, None),
        ("D=128 S=1024", 1, 1024, 32, 8, 128, bf, True, None),
        ("fp32 S=1024", 1, 1024, 32, 8, 64, torch.float32, True, None),
        (f"B=8 group S={main_s}", 8, main_s, 32, 8, 64, bf, True, None),
        ("kv_len<S non-causal", 1, main_s, 32, 8, 64, bf, False, main_s - 231),
        ("kv_len<S causal", 1, main_s, 32, 8, 64, bf, True, main_s - 231),
        ("n_rep 1", 1, 1024, 32, 32, 64, bf, True, None),
        ("n_rep 8", 1, 1024, 64, 8, 64, bf, True, None),
        # draft distillation's target: A without the training outputs
        ("distill B=8 S=512", 8, 512, 32, 8, 64, bf, True, None),
        ("LoRA B=2 S=2048", 2, 2048, 32, 8, 64, bf, True, None),  # l1's layer
        ("GRPO B=8 S=3072", 8, 3072, 32, 8, 64, bf, True, None),  # r1's update forward
        ("main", 1, main_s, 32, 8, 64, bf, True, None),
    ] + [  # a TP rank's heads at the SFT layer's shape (t1's, 4 x 2048)
        (f"{label} B=4 S=2048", 4, 2048, hq, hkv, 64, bf, True, None)
        for label, hq, hkv in TP_RANK_HEADS]
    worst, main = 0.0, None
    gen = torch.Generator(device="cuda").manual_seed(1)
    for (label, b, s, hq, hkv, d, dtype, causal, kv_len) in cases:
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
                   for h in (hq, hkv, hkv))
        out = flash_attention(q, k, v, causal=causal, kv_len=kv_len)
        ref = attention.causal_attention(q, k, v, causal=causal, kv_len=kv_len)
        err, tol = check_close(out, ref, f"kernel A {label}")
        worst = max(worst, err)
        ms = timer.ms(lambda: flash_attention(q, k, v, causal=causal, kv_len=kv_len))
        plain_ms = timer.ms(lambda: attention.causal_attention(q, k, v, causal=causal,
                                                               kv_len=kv_len), iters=5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if kv_len is None:
            lib_ms = timer.ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True))
        else:
            pos = torch.arange(s, device="cuda")
            mask = (pos[None, :] < kv_len) & ((pos[None, :] <= pos[:, None]) | (not causal))
            lib_ms = timer.ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True))
        bound, by = attention_bound_ms(b, s, hq, hkv, d, dtype, kv_len, causal)
        log(f"  {label:20s} B={b} S={s:5d} Hq={hq} Hkv={hkv} D={d:3d} {str(dtype):14s} "
            f"max_abs_err={err:.3e} ({tol})  ms={ms:.4f} prev_ms={_prev('A', label)} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={bound:.4f} ({by})")
        if label == "main":
            main = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                        bound_by=by)
    return dict(max_abs_err=worst, **main)


# --- kernel A' (attention's backward) -------------------------------------------


def attention_bwd_bound_ms(b, s, hq, hkv, d, dtype, kv_len=None) -> tuple[float, str]:
    """Least time for the backward: the five causal products (S, dP, dV, dK,
    dQ), 2 * Hq * D FLOPs each per (query, key) pair with key <= query <
    kv_len, over the dense peak for the dtype, against q, k, v, O, dO and
    the log-sum-exp read once and dq, dk, dv written once."""
    n = s if kv_len is None else kv_len
    flops = 5 * 2.0 * b * hq * d * (n * (n + 1) // 2)
    es = torch.finfo(dtype).bits // 8
    nbytes = (4 * b * s * hq * d + 4 * b * s * hkv * d) * es + 4 * b * hq * s
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


# SFT's layer (Llama-3.2-1B at batch 4 x 2048) first, then fp32, Llama-3.1-8B's
# head_dim, a tail, kv_len < S, n_rep 1, a sharp softmax (q x 4: D from the
# bf16-rounded O alone puts dq and dk outside GRAD_TOL there), a small ragged
# case (partial tiles in both kernels), batch 8, draft distillation's layer,
# the LoRA step's (l1) and the GRPO update's (r1, at batch 2)
BWD_CASES = [  # (label, B, S, Hq, Hkv, D, dtype, kv_len, q_scale)
    ("main", 4, 2048, 32, 8, 64, torch.bfloat16, None, 1.0),
    ("fp32 S=1024", 1, 1024, 32, 8, 64, torch.float32, None, 1.0),
    ("D=128 S=1024", 1, 1024, 32, 8, 128, torch.bfloat16, None, 1.0),
    ("S=1000", 4, 1000, 32, 8, 64, torch.bfloat16, None, 1.0),
    ("kv_len<S", 1, 1024, 32, 8, 64, torch.bfloat16, 793, 1.0),
    ("n_rep 1", 1, 1024, 32, 32, 64, torch.bfloat16, None, 1.0),
    ("sharp q*4", 1, 1024, 32, 8, 64, torch.bfloat16, None, 4.0),
    ("ragged S=130", 2, 130, 32, 8, 64, torch.bfloat16, 97, 1.0),
    ("B=8 S=1024", 8, 1024, 32, 8, 64, torch.bfloat16, None, 1.0),
    ("distill B=8 S=512", 8, 512, 32, 8, 64, torch.bfloat16, None, 1.0),
    ("LoRA B=2 S=2048", 2, 2048, 32, 8, 64, torch.bfloat16, None, 1.0),
    # r1's update layer is B=8 x 3072; the plain backward's fp32 scores hold it to 2
    ("GRPO B=2 S=3072", 2, 3072, 32, 8, 64, torch.bfloat16, None, 1.0),
] + [  # a TP rank's heads at the SFT layer's shape (t1's)
    (label, 4, 2048, hq, hkv, 64, torch.bfloat16, None, 1.0) for label, hq, hkv in TP_RANK_HEADS]


def bwd_inputs(gen, b, s, hq, hkv, d, dtype, q_scale):
    """q (times q_scale, in fp32), k, v and the output cotangent of one
    BWD_CASES row, drawn from ``gen`` on the card."""
    q = (torch.randn(b, s, hq, d, generator=gen, device="cuda") * q_scale).to(dtype)
    k, v = (torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    g = torch.randn(b, s, hq, d, generator=gen, device="cuda").to(dtype)
    return q, k, v, g


def check_kernel_a_bwd(timer: Timer) -> dict:
    """Kernel A' against its plain version (``causal_attention_bwd``: torch
    autograd through the plain attention under the kv_len rule) at every
    case of BWD_CASES, within ``GRAD_TOL``, beside SDPA's backward and the
    first design's time (``PREV_MS``); and kernel A with its log-sum-exp and
    residual writes against A without them."""
    from tts_max_tpu_torch.ops.attention import GRAD_TOL, causal_attention_bwd, grad_tol_ratio
    from tts_max_tpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd

    log("kernel A': flash_attention_bwd vs ops.attention.causal_attention_bwd (plain: "
        "autograd through fp32 math, TF32 off); library = the backward of "
        "F.scaled_dot_product_attention(is_causal=True, enable_gqa=True) (a boolean "
        "mask where kv_len < S) on the same inputs; tolerance GRAD_TOL "
        f"{ {str(k): v for k, v in GRAD_TOL.items()} } as |g - ref| <= rtol|ref| + atol max|ref|")
    worst, main = 0.0, None
    gen = torch.Generator(device="cuda").manual_seed(2)
    for (label, b, s, hq, hkv, d, dtype, kv_len, q_scale) in BWD_CASES:
        q, k, v, g = bwd_inputs(gen, b, s, hq, hkv, d, dtype, q_scale)
        out, lse, out_lo = flash_attention_fwd(q, k, v, True, kv_len, with_lse=True)
        grads = flash_attention_bwd(q, k, v, out, lse, g, True, kv_len, out_lo)
        refs = causal_attention_bwd(q, k, v, g, kv_len=kv_len)
        ratios = [grad_tol_ratio(x, r) for x, r in zip(grads, refs)]
        errs = [max_err(x, r) for x, r in zip(grads, refs)]
        if not max(ratios) <= 1.0:
            raise AssertionError(f"kernel A' {label}: dq/dk/dv at {ratios} of GRAD_TOL "
                                 f"(max abs err {errs})")
        worst = max(worst, *errs)
        ms = timer.ms(lambda: flash_attention_bwd(q, k, v, out, lse, g, True, kv_len, out_lo))
        plain_ms = timer.ms(lambda: causal_attention_bwd(q, k, v, g, kv_len=kv_len), iters=5)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
        if kv_len is None:
            o_lib = torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)
        else:
            pos = torch.arange(s, device="cuda")
            mask = (pos[None, :] < kv_len) & (pos[None, :] <= pos[:, None])
            o_lib = torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
        gt = g.transpose(1, 2)
        lib_ms = timer.ms(lambda: torch.autograd.grad(o_lib, (qt, kt, vt), gt,
                                                      retain_graph=True))
        del o_lib
        bound, by = attention_bwd_bound_ms(b, s, hq, hkv, d, dtype, kv_len)
        prev = _prev("A'", label)
        log(f"  {label:13s} B={b} S={s:5d} Hq={hq:2d} Hkv={hkv} D={d:3d} {str(dtype):14s} "
            f"kv_len={kv_len or s} q*{q_scale:g} dq/dk/dv max_abs_err={errs[0]:.3e}/"
            f"{errs[1]:.3e}/{errs[2]:.3e} ({'/'.join(f'{r:.2f}' for r in ratios)}x GRAD_TOL)  "
            f"ms={ms:.4f} prev_ms={prev} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={bound:.4f} ({by})")
        if label == "main":
            with_lse = timer.ms(lambda: flash_attention_fwd(q, k, v, True, None, with_lse=True))
            without = timer.ms(lambda: flash_attention_fwd(q, k, v, True, None))
            log(f"  kernel A at the main shape: {with_lse:.4f} ms writing the log-sum-exp and "
                f"O's residual, {without:.4f} ms without ({with_lse / without - 1:+.1%})")
            main = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                        bound_by=by)
        del q, k, v, g, out, lse, out_lo, grads, refs
    return dict(max_abs_err=worst, **main)


# --- kernel B -----------------------------------------------------------------

# the contiguous engine's pool mid-decode (e3: 8 slots, max_len 2048)
E3_LENS = [431, 431, 431, 431, 496, 496, 1351, 1351]


def decode_bound_ms(q, kq, lengths, quant: bool) -> tuple[float, str]:
    """Least time for decode attention: bytes of q, the live K and V rows
    (and their scales) and the output, against 4 * Hq * D FLOPs per live
    row."""
    b, hq, d = q.shape
    hkv = kq.shape[2]
    rows = int(lengths.sum())
    row_bytes = hkv * d * kq.element_size() + (4 * hkv if quant else 0)
    nbytes = 2 * q.numel() * q.element_size() + 2 * rows * row_bytes + 4 * b
    flops = 4.0 * rows * hq * d
    t_ops, t_bytes = flops / PEAK_FLOPS[q.dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _decode_inputs(gen, b, t, d, lengths, quant, nan_tail, hq=32, hkv=8,
                   dtype=torch.bfloat16, stacked=False):
    """q [b, hq, d] and caches [b, t, hkv, d] in ``dtype`` (or int8 with
    scales), NaN past every length if ``nan_tail``; with ``stacked`` the
    caches are layer 1 of [2, b, t, hkv, d] (a view, as ``llama.decode_step``
    passes ``cache[layer]``)."""
    from tts_max_tpu_torch.models.llama import _layer_cache, _quantize_kv

    q = torch.randn(b, hq, d, generator=gen, device="cuda").to(dtype)
    layers = (2,) if stacked else ()
    kv = [torch.randn(*layers, b, t, hkv, d, generator=gen, device="cuda").to(dtype)
          for _ in range(2)]
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    if quant:
        kv = [_quantize_kv(x) for x in kv]
    if nan_tail:
        dead = torch.arange(t, device="cuda")[None, :] >= lens[:, None]
        idx = (slice(None), dead) if stacked else (dead,)
        for c in kv:
            (c["scale"] if quant else c)[idx] = float("nan")
    if stacked:
        kv = [_layer_cache(c, 1) for c in kv]
    return q, kv[0], kv[1], lens


# Edge cases of the contiguous decode kernels (B and C), checked against the
# plain version, not timed: T = 200 (not a multiple of 32), lengths at chunk
# edges (0 gives zeros in both plain versions), n_rep 1, 4 and 8, D 64 and
# 128, NaN past every length, a stacked cache's layer view
EDGE_LENS = [0, 1, 31, 32, 33, 200, 137]
EDGE_CASES = [(hq, d) for hq in (8, 32, 64) for d in (64, 128)]


def _check_zeros(out, lens, what) -> None:
    if 0 in lens and not bool((out[lens.index(0)] == 0).all()):
        raise AssertionError(f"{what}: a length of 0 did not give zeros")


def check_kernel_b(timer: Timer, main_t: int, main_len: int) -> dict:
    """Kernel B against its plain version, timed beside a masked SDPA (bf16)
    and beside the earlier CUDA-core kernel's time (``PREV_MS``): batch 1
    and 8, T 256 and 2048, bf16 and int8, ragged lengths with NaN past them
    at D 64 and 128, the contiguous engine's shape (e3) and the main path's
    (batch 1 at request (c)'s length, the ``kernels`` line); then the edge
    cases (``EDGE_CASES``) untimed."""
    from tts_max_tpu_torch.ops import attention
    from tts_max_tpu_torch.ops.flash_decode import flash_decode_attention

    log("kernel B: flash_decode_attention vs ops.attention.decode_attention "
        "(plain); library = F.scaled_dot_product_attention with a length mask "
        "(bf16 cache only); prev = the CUDA-core kernel")
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = []  # (label, B, T, D, lengths, int8, NaN past the lengths, Hq, Hkv)
    for b in (1, 8):
        for t in (256, 2048):
            lens = [t] if b == 1 else [1, t, 7, t // 2, t - 1, 100, 33, t // 3]
            for quant in (False, True):
                cases.append((f"B={b} T={t}", b, t, 64, lens, quant, False, 32, 8))
    ragged = [1, 2048, 7, 1024, 2047, 100, 33, 682]
    for d in (64, 128):  # 128: Llama-3.1-8B's head_dim
        for quant in (False, True):
            cases.append((f"D={d} ragged", 8, 2048, d, ragged, quant, True, 32, 8))
    # the contiguous engine's shape (e3: 8 slots, max_len 2048, mid-decode)
    cases.append(("e3", 8, 2048, 64, E3_LENS, False, False, 32, 8))
    cases.append(("main", 1, main_t, 64, [main_len], False, False, 32, 8))  # the main path's
    for label, hq, hkv in TP_RANK_HEADS:  # a TP rank's heads at e3's shape, bf16 and int8
        for quant in (False, True):
            cases.append((f"{label} e3", 8, 2048, 64, E3_LENS, quant, False, hq, hkv))
    worst, main = 0.0, None
    for (label, b, t, d, lens, quant, nan_tail, hq, hkv) in cases:
        q, kc, vc, lengths = _decode_inputs(gen, b, t, d, lens, quant, nan_tail, hq=hq,
                                            hkv=hkv)
        out = flash_decode_attention(q, kc, vc, lengths)
        ref = attention.decode_attention(q, kc, vc, lengths)
        err, tol = check_close(out, ref, f"kernel B {label} quant={quant}")
        worst = max(worst, err)
        ms = timer.ms(lambda: flash_decode_attention(q, kc, vc, lengths))
        plain_ms = timer.ms(lambda: attention.decode_attention(q, kc, vc, lengths))
        lib_ms = None
        if not quant:
            mask = (torch.arange(t, device="cuda")[None, :] < lengths[:, None])
            mask = mask[:, None, None, :]
            qs, ks, vs = q[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2)
            lib_ms = timer.ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, enable_gqa=True))
        bound, by = decode_bound_ms(q, kc["q"] if quant else kc, lengths, quant)
        lib = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
        prev = _prev("B", label) if not quant else "n/a"
        log(f"  {label:14s} B={b} T={t:5d} Hq={hq:2d} Hkv={hkv} D={d:3d} "
            f"{'int8' if quant else 'bf16'} {'NaN-tail ' if nan_tail else ''}"
            f"max_abs_err={err:.3e} "
            f"({tol})  ms={ms:.4f} prev_ms={prev} plain_ms={plain_ms:.4f} "
            f"library_ms={lib} bound_ms={bound:.5f} ({by})")
        if label == "main":
            main = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                        bound_by=by)
    n_edge = 0
    for hq, d in EDGE_CASES:
        for quant in (False, True):
            q, kc, vc, lengths = _decode_inputs(gen, len(EDGE_LENS), 200, d, EDGE_LENS,
                                                quant, True, hq=hq, stacked=True)
            out = flash_decode_attention(q, kc, vc, lengths)
            what = f"kernel B edge Hq={hq} D={d} quant={quant}"
            err, _ = check_close(out, attention.decode_attention(q, kc, vc, lengths), what)
            _check_zeros(out, EDGE_LENS, what)
            worst = max(worst, err)
            n_edge += 1
    log(f"  {n_edge} edge cases (T=200, lengths {EDGE_LENS}, n_rep 1/4/8, D 64/128, "
        "bf16 and int8, NaN past the lengths, layer 1 of a stacked cache): "
        "within tolerance")
    return dict(max_abs_err=worst, **main)


# --- kernel C -----------------------------------------------------------------

def check_kernel_c(timer: Timer, main_t: int, main_len: int) -> dict:
    """Kernel C against its plain version at e3's shape (the main shape,
    timed beside kernel B and a masked SDPA on the same inputs, and beside
    the earlier CUDA-core kernel C's time, ``PREV_MS``) and at the edges:
    batch 1 at request (c)'s length, fp32, D = 128, n_rep 1, 4 and 8, T =
    200, lengths 0, 1 and T, NaN past every length; then ``EDGE_CASES`` in
    bf16 and fp32, untimed."""
    from tts_max_tpu_torch.ops.attention import ragged_decode_attention_plain as plain
    from tts_max_tpu_torch.ops.flash_decode import flash_decode_attention
    from tts_max_tpu_torch.ops.ragged_decode import ragged_decode_attention

    log("kernel C: ragged_decode_attention vs ops.attention.ragged_decode_attention_plain "
        "(plain); library = F.scaled_dot_product_attention with a length mask; kernel B "
        "(flash_decode_attention) timed on the same inputs; prev = the CUDA-core kernel C")
    gen = torch.Generator(device="cuda").manual_seed(7)
    edge = [0, 1, 2048, 129, 2047, 7, 1024, 300]
    cases = [  # (label, B, T, Hq, Hkv, D, dtype, lengths, NaN past the lengths)
        ("main (e3)", 8, 2048, 32, 8, 64, torch.bfloat16, E3_LENS, False),
        ("B=1 request c", 1, main_t, 32, 8, 64, torch.bfloat16, [main_len], False),
        ("fp32", 8, 2048, 32, 8, 64, torch.float32, edge, True),
        ("D=128", 8, 2048, 32, 8, 128, torch.bfloat16, edge, True),
        ("n_rep 1", 4, 512, 8, 8, 64, torch.bfloat16, [0, 1, 512, 300], True),
        ("n_rep 8", 4, 512, 64, 8, 64, torch.bfloat16, [512, 0, 1, 200], True),
        ("T=200", 3, 200, 32, 8, 64, torch.bfloat16, [0, 1, 200], True),
        ("T=200 fp32 D=128 n_rep 8", 3, 200, 16, 2, 128, torch.float32, [200, 77, 0], True),
    ] + [  # a TP rank's heads at e3's shape
        (f"{label} (e3)", 8, 2048, hq, hkv, 64, torch.bfloat16, E3_LENS, False)
        for label, hq, hkv in TP_RANK_HEADS]
    worst, main = 0.0, None
    for (label, b, t, hq, hkv, d, dtype, lens, nan_tail) in cases:
        q = torch.randn(b, hq, d, generator=gen, device="cuda").to(dtype)
        kc, vc = (torch.randn(b, t, hkv, d, generator=gen, device="cuda").to(dtype)
                  for _ in range(2))
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        if nan_tail:
            dead = torch.arange(t, device="cuda")[None, :] >= lengths[:, None]
            kc[dead], vc[dead] = float("nan"), float("nan")
        out = ragged_decode_attention(q, kc, vc, lengths)
        ref = plain(q, kc, vc, lengths)
        err, tol = check_close(out, ref, f"kernel C {label}")
        _check_zeros(out, lens, f"kernel C {label}")
        worst = max(worst, err)
        ms = timer.ms(lambda: ragged_decode_attention(q, kc, vc, lengths))
        plain_ms = timer.ms(lambda: plain(q, kc, vc, lengths), iters=5)
        bound, by = decode_bound_ms(q, kc, lengths, False)
        extra = ""
        if label.startswith("main"):
            b_ms = timer.ms(lambda: flash_decode_attention(q, kc, vc, lengths))
            mask = (torch.arange(t, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
            qs, ks, vs = q[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2)
            lib_ms = timer.ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, enable_gqa=True))
            main = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                        bound_by=by)
            extra = f" kernel_B_ms={b_ms:.4f} library_ms={lib_ms:.4f}"
        log(f"  {label:24s} B={b} T={t:5d} Hq={hq:2d} Hkv={hkv} D={d:3d} "
            f"{str(dtype):14s} max_abs_err={err:.3e} ({tol})  ms={ms:.4f} "
            f"prev_ms={_prev('C', label)} plain_ms={plain_ms:.4f}{extra} "
            f"bound_ms={bound:.5f} ({by})")
    n_edge = 0
    for hq, d in EDGE_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q, kc, vc, lengths = _decode_inputs(gen, len(EDGE_LENS), 200, d, EDGE_LENS,
                                                False, True, hq=hq, dtype=dtype, stacked=True)
            out = ragged_decode_attention(q, kc, vc, lengths)
            what = f"kernel C edge Hq={hq} D={d} {dtype}"
            err, _ = check_close(out, plain(q, kc, vc, lengths), what)
            _check_zeros(out, EDGE_LENS, what)
            worst = max(worst, err)
            n_edge += 1
    log(f"  {n_edge} edge cases (T=200, lengths {EDGE_LENS}, n_rep 1/4/8, D 64/128, "
        "bf16 and fp32, NaN past the lengths, layer 1 of a stacked cache): "
        "within tolerance, zeros at length 0")
    return dict(max_abs_err=worst, **main)


# --- the paged kernel (D, E, F) ---------------------------------------------------

PAGED_MAIN_LENS = [300, 1900, 777, 1024, 1358, 501, 1650, 1100]


def paged_bound_ms(q, kq, table, lengths, quant: bool) -> tuple[float, str]:
    """Least time for paged decode attention: bytes of q, the live pages of
    K and V (and their scales), the table entries of those pages, the
    lengths and the output, against 4 * Hq * D FLOPs per live row."""
    b, hq, d = q.shape
    bs, hkv = kq.shape[-3], kq.shape[-2]
    pages = int(((lengths + bs - 1) // bs).sum())
    row_bytes = hkv * d * kq.element_size() + (4 * hkv if quant else 0)
    nbytes = (2 * q.numel() * q.element_size() + 2 * pages * bs * row_bytes
              + 4 * pages + 4 * b)
    flops = 4.0 * int(lengths.sum()) * hq * d
    t_ops, t_bytes = flops / PEAK_FLOPS[q.dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _paged_inputs(gen, b, d, lens, quant, layers=1, bs=64, p=32, n=257, hq=32, hkv=8):
    """q [b, hq, d] and K/V pools of ``layers`` layers [L, N, bs, hkv, d] in
    bf16 (or int8 with scales), sequences' pages shuffled through the pool
    (block 0, the sink, owned by none), NaN in every row no sequence reads:
    the sink, unowned pages, and rows past each length."""
    from tts_max_tpu_torch.models.llama import _quantize_kv

    q = torch.randn(b, hq, d, generator=gen, device="cuda").to(torch.bfloat16)
    kv = [torch.randn(layers, n, bs, hkv, d, generator=gen, device="cuda").to(torch.bfloat16)
          for _ in range(2)]
    perm = torch.randperm(n - 1, generator=torch.Generator().manual_seed(b * d))[:b * p] + 1
    table = perm.view(b, p).to(device="cuda", dtype=torch.int32)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    live = torch.zeros(n, bs, dtype=torch.bool, device="cuda")
    rows = torch.arange(p * bs, device="cuda")
    for i in range(b):
        ok = rows < lengths[i]
        live[table[i].repeat_interleave(bs)[ok], (rows % bs)[ok]] = True
    if quant:
        kv = [_quantize_kv(x) for x in kv]
    for c in kv:
        (c["scale"] if quant else c)[:, ~live] = float("nan")
    return q, kv[0], kv[1], table, lengths


def _layer(c, i):
    return {"q": c["q"][i], "scale": c["scale"][i]} if isinstance(c, dict) else c[i]


def check_paged(timer: Timer) -> dict:
    """Each entry point (and D's stacked form) against the plain version on
    every case: the main shape (B = 8, bf16) and int8, D = 128, batch 1,
    n_rep 8 in int8 at batch 1, and block sizes 16 and 48 (32-row chunks
    with rows past the page's end). Per entry point, its times at the main
    shape and its worst error over all cases."""
    from tts_max_tpu_torch.ops import paged_attention as pa

    log("paged kernel (csrc/paged_decode.cu) behind D, E, F vs "
        "ops.paged_attention.paged_decode_attention_xla (plain); library = "
        "F.scaled_dot_product_attention with a length mask on the same rows already "
        "gathered contiguous (gather excluded; bf16 only); prev = the CUDA-core kernel")
    entries = {"D": pa.paged_decode_attention_dense, "E": pa.paged_decode_attention_dma,
               "F": pa.paged_decode_attention}
    gen = torch.Generator(device="cuda").manual_seed(4)
    lens = PAGED_MAIN_LENS
    cases = [  # (label, B, D, lengths, int8, Hq, bs, Hkv)
        ("main", 8, 64, lens, False, 32, 64, 8), ("main int8", 8, 64, lens, True, 32, 64, 8),
        ("D=128", 8, 128, lens, False, 32, 64, 8), ("D=128 int8", 8, 128, lens, True, 32, 64, 8),
        ("B=1", 1, 64, [1358], False, 32, 64, 8),
        ("n_rep 8 B=1 int8", 1, 64, [1358], True, 64, 64, 8),
        ("bs=16", 8, 64, lens, False, 32, 16, 8), ("bs=48 int8", 8, 64, lens, True, 32, 48, 8),
    ] + [(label, 8, 64, lens, False, hq, 64, hkv) for label, hq, hkv in TP_RANK_HEADS]
    worst = {k: 0.0 for k in entries}
    main = {}
    for (label, b, d, lens, quant, hq, bs, hkv) in cases:
        p = max(32, -(-max(PAGED_MAIN_LENS) // bs))  # the bs 64 table (32) and pool (257)
        n = max(257, b * p + 1)
        q, kp, vp, table, lengths = _paged_inputs(gen, b, d, lens, quant, layers=2, bs=bs,
                                                  p=p, n=n, hq=hq, hkv=hkv)
        k0, v0 = _layer(kp, 1), _layer(vp, 1)
        ref = pa.paged_decode_attention_xla(q, k0, v0, table, lengths)
        plain_ms = timer.ms(lambda: pa.paged_decode_attention_xla(q, k0, v0, table, lengths),
                            iters=5)
        lib_ms = None
        if not quant:
            idx = table.long()
            kc = k0[idx].reshape(b, -1, hkv, d).transpose(1, 2)
            vc = v0[idx].reshape(b, -1, hkv, d).transpose(1, 2)
            mask = (torch.arange(kc.shape[2], device="cuda")[None, :] < lengths[:, None])
            mask = mask[:, None, None, :]
            qs = q[:, :, None, :]
            # the masked rows hold NaN, which SDPA's softmax would spread
            kc, vc = kc.nan_to_num(), vc.nan_to_num()
            lib_ms = timer.ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qs, kc, vc, attn_mask=mask, enable_gqa=True))
        bound, by = paged_bound_ms(q, kp["q"] if quant else kp, table, lengths, quant)
        for name, fn in entries.items():
            out = fn(q, k0, v0, table, lengths)
            err, tol = check_close(out, ref, f"paged {name} {label}")
            worst[name] = max(worst[name], err)
            ms = timer.ms(lambda: fn(q, k0, v0, table, lengths))
            lib = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
            log(f"  {name} {label:16s} B={b} Hq={hq} Hkv={hkv} D={d:3d} bs={bs} "
                f"{'int8' if quant else 'bf16'} max_abs_err={err:.3e} ({tol})  ms={ms:.4f} "
                f"prev_ms={_prev(name, label)} plain_ms={plain_ms:.4f} library_ms={lib} "
                f"bound_ms={bound:.5f} ({by})")
            if label == "main":
                main[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                  bound_ms=bound, bound_by=by)
        for layer in (0, 1):
            ref_l = pa.paged_decode_attention_xla(q, _layer(kp, layer), _layer(vp, layer),
                                                  table, lengths)
            out = pa.paged_decode_attention_dense(q, kp, vp, table, lengths, layer=layer)
            err, tol = check_close(out, ref_l, f"paged D stacked layer={layer} {label}")
            worst["D"] = max(worst["D"], err)
        log(f"  D stacked form (layer=0, 1 of [2, {n}, {bs}, {hkv}, {d}]) {label}: "
            "within tolerance")
    return {k: dict(max_abs_err=worst[k], **main[k]) for k in entries}


# --- kernel G -------------------------------------------------------------------

# [B, T, C] of the acoustic encoder's activations on a 22 s prompt (352000
# samples + 320 of hop padding) at EncoderConfig(), and launches per encode
ENCODER_SHAPES = [("block 1", 352320, 48, 7), ("block 2", 176160, 96, 7),
                  ("block 3", 88080, 192, 7), ("block 4", 22020, 384, 7),
                  ("block 5", 5505, 768, 7), ("final", 1101, 1536, 1)]
# v1's batches: data_vectorizer at batch 8 on V1_SAMPLES samples of 0.5-3 s
# (example/make_synthetic_samples.py) pads each batch to the 3 s bucket plus a
# hop; the train split runs batches of 8 and one of 7, the val split one of 1
V1_SAMPLES, V1_T, V1_BATCHES = 40, 48000 + 320, (8, 7, 1)


def encoder_shapes(t0: int) -> list:
    """ENCODER_SHAPES for an input of ``t0`` samples (hop padding included):
    each block's T divided as the 22 s prompt's is."""
    top = ENCODER_SHAPES[0][1]
    return [(label, t0 // (top // t), c, n) for label, t, c, n in ENCODER_SHAPES]


ACT1D_FLOPS = 53  # per element: two 6-tap sums (22), two snakes (8), the 12-tap down sum (23)
SINE_FLOPS = 20  # an estimate for one sinf: range reduction and polynomial


def act1d_bound_ms(b, t, c) -> tuple[float, str]:
    """Least time for kernel G: x read once and y written once (fp32), plus
    alpha and beta, against ACT1D_FLOPS + 2 sines per element in fp32."""
    n = b * t * c
    nbytes = 8 * n + 8 * c
    flops = n * (ACT1D_FLOPS + 2 * SINE_FLOPS)
    t_ops, t_bytes = flops / PEAK_FLOPS[torch.float32], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def check_kernel_g(timer: Timer) -> dict:
    from tts_max_tpu_torch.models.codec import filters
    from tts_max_tpu_torch.ops import act1d
    from tts_max_tpu_torch.ops.act1d import activation1d_fused, activation1d_kernel

    log("kernel G: activation1d_kernel vs ops.act1d.activation1d_fused (plain, fp32); "
        "unfused = filters.activation1d(fused=False), cuDNN depthwise conv_transpose1d "
        "+ snake + depthwise strided conv1d (yardstick: no single PyTorch call "
        "computes G); random log-scale alpha, beta at 0.3 std")
    per_elem, shared = act1d_sass()
    clock = sm_clock_max_hz()
    log("  SASS, interior strip loop, every sine on the fast path: " + "; ".join(
        f"R={r} {n:.1f} instructions an element ({f:.1f} FFMA, the sine's)"
        for r, (n, f) in sorted(per_elem.items())) + "; library " + " ".join(
        f"{k}={v}" for k, v in shared.items()) + f"; max SM clock {clock / 1e6:.0f} MHz")
    gen = torch.Generator(device="cuda").manual_seed(6)

    def inputs(b, t, c, scales=(), amp=None):
        if amp is None:
            x = torch.randn(b, t, c, generator=gen, device="cuda")
        else:
            x = amp * (2 * torch.rand(b, t, c, generator=gen, device="cuda") - 1)
        for i, sc in enumerate(scales):
            x[i] *= sc
        p = {k: 0.3 * torch.randn(c, generator=gen, device="cuda") for k in ("alpha", "beta")}
        return x, p

    worst = 0.0

    def check(label, x, p):
        nonlocal worst
        out, ref = activation1d_kernel(x, p), activation1d_fused(x, p)
        err, tol = check_close(out, ref, f"kernel G {label}")
        worst = max(worst, err)
        return err, tol, bool(torch.equal(out, ref))

    # T below the warm-up, around one strip of every R, past three strips
    ts = sorted({1, 2, 5, 6, 7} | {r + d for r in act1d.STRIP_ROWS for d in (-1, 1)}
                | {3 * r + 5 for r in act1d.STRIP_ROWS})
    edge = [(f"B=2 T={t} C=4, scales 30 / 0.01", inputs(2, t, 4, scales=(30.0, 0.01)))
            for t in ts]
    edge += [("B=2 T=5000 C=48, scales 0.01 / 30", inputs(2, 5000, 48, scales=(0.01, 30.0))),
             ("B=1 T=4096 C=48, |x| up to 50", inputs(1, 4096, 48, amp=50.0)),
             ("B=1 T=4096 C=48, |x| up to 1e6 (sinf's slow path)",
              inputs(1, 4096, 48, amp=1e6)),
             ("B=1 T=300 C=20 (masked lanes)", inputs(1, 300, 20))]
    for label, (x, p) in edge:
        err, tol, same = check(label, x, p)
        log(f"  edge case {label}: max_abs_err={err:.3e} ({tol}), bitwise {same}")
    for b in V1_BATCHES:  # every shape v1 runs G at (run_vectorize checks that)
        for label, t, c, _ in encoder_shapes(V1_T):
            err, tol, same = check(f"v1 {label} B={b}", *inputs(b, t, c))
            log(f"  v1 {label:7s} [{b}, {t:5d}, {c:4d}]: max_abs_err={err:.3e} ({tol}), "
                f"bitwise {same}")
    rule = act1d.launch_rows
    try:  # every compiled R, forced in place of the rule's choice
        for r in act1d.STRIP_ROWS:
            act1d.launch_rows = lambda b, t, c, r=r: r
            for t in (3 * r + 5, 4000):
                label = f"R={r} B=2 T={t} C=48, scales 30 / 0.01"
                err, tol, same = check(label, *inputs(2, t, 48, scales=(30.0, 0.01)))
                log(f"  strip length {label}: max_abs_err={err:.3e} ({tol}), bitwise {same}")
    finally:
        act1d.launch_rows = rule
    rows, per_encode = [], dict(ms=0.0, plain_ms=0.0, unfused_ms=0.0, bound_ms=0.0,
                                issue_floor_ms=0.0)
    for label, t, c, n in ENCODER_SHAPES:
        x, p = inputs(1, t, c)
        err, tol, same = check(label, x, p)
        r = act1d.launch_rows(1, t, c)
        ms = timer.ms(lambda: activation1d_kernel(x, p))
        plain_ms = timer.ms(lambda: activation1d_fused(x, p), iters=5)
        unfused_ms = timer.ms(lambda: filters.activation1d(x, p, fused=False), iters=5)
        bound, by = act1d_bound_ms(1, t, c)
        # instruction issue at 128 lanes a cycle on every SM, at the max clock
        issue = (1e3 * per_elem[r][0] * t * c / (act1d.SMS * 128 * clock)
                 if r in per_elem else float("nan"))
        for k, val in dict(ms=ms, plain_ms=plain_ms, unfused_ms=unfused_ms,
                           bound_ms=bound, issue_floor_ms=issue).items():
            per_encode[k] += n * val
        log(f"  {label:7s} [1, {t:6d}, {c:4d}] x{n}: max_abs_err={err:.3e} ({tol}), "
            f"bitwise {same}; R={r}, {act1d.launch_warps(1, t, c, r) / act1d.SMS:.1f} "
            f"warps per SM; "
            f"ms={ms:.4f} prev_ms={PREV_MS[('G', label)]:.4f} plain_ms={plain_ms:.4f} "
            f"unfused_ms={unfused_ms:.4f} bound_ms={bound:.5f} ({by}, "
            f"{8 * t * c / 2 ** 20:.1f} MiB moved) issue_floor_ms={issue:.5f}")
        rows.append(dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound,
                         bound_by=by))
    log("  per 22 s encode (36 launches): " + ", ".join(
        f"{k}={val:.4f}" for k, val in per_encode.items())
        + f" (prev_ms={sum(n * PREV_MS[('G', lb)] for lb, _, _, n in ENCODER_SHAPES):.4f})")
    return dict(max_abs_err=worst, **rows[0])


# --- the quantized product (kn, vd) ---------------------------------------------

QUANT_SHAPES = [("1B wq/wo", 2048, 2048), ("1B wk/wv", 2048, 512),
                ("1B w_gate/w_up", 2048, 8192), ("1B w_down", 8192, 2048),
                ("8B wq/wo", 4096, 4096), ("8B wk/wv", 4096, 1024),
                ("8B w_gate/w_up", 4096, 14336), ("8B w_down", 14336, 4096)]
QUANT_MODES = {"int8": dict(bits=8), "int4": dict(bits=4),
               "int4-g64": dict(bits=4, group_size=64),
               "int4-g128": dict(bits=4, group_size=128)}
QUANT_ROWS = (1, 8, 16)


def quant_bound_ms(x: torch.Tensor, p: dict, n_out: int, out_dtype) -> tuple[float, str]:
    """Least time for a weight-only product: the levels and scales read
    once, x read once and y written once, against 2 M K N operations at
    x's dtype's peak."""
    levels = p["q4"] if "q4" in p else p["q"]
    m, k = x.shape
    nbytes = (levels.shape[0] * levels.shape[1] + 4 * p["scale"].numel()
              + x.numel() * x.element_size() + m * n_out * torch.finfo(out_dtype).bits // 8)
    t_ops, t_bytes = 2.0 * m * k * n_out / PEAK_FLOPS[x.dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def check_quant_close(out: torch.Tensor, ref: torch.Tensor, what: str) -> tuple[float, float]:
    """Raises unless out is finite and within ``quant_matmul.KERNEL_TOL`` of
    ref (the plain version in fp32): |out - ref| <= rtol |ref| + atol
    max|ref|. Returns (max abs err, its ratio to the tolerance)."""
    from tts_max_tpu_torch.ops.quant_matmul import KERNEL_TOL

    rtol, atol = KERNEL_TOL[out.dtype]
    err = (out.float() - ref).abs()
    ratio = float((err / (rtol * ref.abs() + atol * ref.abs().max())).max())
    if not (ratio <= 1.0 and bool(torch.isfinite(out).all())):
        raise AssertionError(f"{what}: max abs err {float(err.max()):.3e}, "
                             f"{ratio:.2f}x the tolerance")
    return float(err.max()), ratio


def check_quant(timer: Timer) -> dict:
    """The quantized product against its plain version (computed in fp32 on
    the card) and beside cuBLAS on the dequantized weight: kn at every layer
    kernel of Llama-3.2-1B and Llama-3.1-8B in every mode at 1, 8 and 16
    rows, bf16 and fp32 x (timed in bf16); the untied int8 head window of
    8B (kn through the window's row stride); vd on the tied head window of
    Llama-3.2-1B, int8 and int4. Returns the numbers of the main case, a
    batch-1 1B w_gate at int8 in bf16 (every decode step of s5)."""
    from tts_max_tpu_torch.models import llama
    from tts_max_tpu_torch.models.quantization import quantize_tensor
    from tts_max_tpu_torch.ops import quant_matmul as qm

    bf = torch.bfloat16
    log("quantized product: quant_matmul (kn) / quant_tied_logits (vd) vs "
        "ops.quant_matmul.matmul_plain / tied_logits_plain on fp32 x (plain_ms: the plain "
        "version on the kernel's bf16 inputs); library = torch.matmul, cuBLAS bf16, on the "
        "weight dequantized to bf16 (reads 2x an int8, 4x an int4 weight's bytes); tol "
        f"{qm.KERNEL_TOL[bf][0]:.4g}|ref| + {qm.KERNEL_TOL[bf][1]:.0e} max|ref| (bf16), "
        f"{qm.KERNEL_TOL[torch.float32][0]:.0e}|ref| + {qm.KERNEL_TOL[torch.float32][1]:.0e} "
        "max|ref| (fp32); per line: ms / bound_ms / plain_ms / library_ms at rows 1, 8, 16")
    gen = torch.Generator(device="cuda").manual_seed(8)
    worst, worst_ratio, main, n_cases = 0.0, 0.0, None, 0

    def case(label, key, x_of, run, plain, lib, p, n_out):
        """Check one product at rows 1, 8, 16 in bf16 and fp32, two launches
        bitwise equal; time bf16 beside the earlier kernel (``PREV_MS``)."""
        nonlocal worst, worst_ratio, n_cases
        times = []
        for m in QUANT_ROWS:
            for dtype in (bf, torch.float32):
                x = x_of(m).to(dtype)
                out = run(x)
                if not torch.equal(out, run(x)):
                    raise AssertionError(f"{label} m={m} {dtype}: two launches differ")
                err, ratio = check_quant_close(out, plain(x.float()), f"{label} m={m} {dtype}")
                worst, worst_ratio, n_cases = max(worst, err), max(worst_ratio, ratio), n_cases + 1
                if dtype is bf:
                    bound, by = quant_bound_ms(x, p, n_out, out.dtype)
                    times.append(dict(ms=timer.ms(lambda: run(x)), bound_ms=bound, bound_by=by,
                                      plain_ms=timer.ms(lambda: plain(x), iters=5),
                                      library_ms=timer.ms(lambda: lib(x))))
        log(f"  {label:26s} " + "  ".join(
            f"m={m}: {t['ms']:.4f}/{t['bound_ms']:.4f}/{t['plain_ms']:.4f}/"
            f"{t['library_ms']:.4f}" + (f" prev={_prev('Q', f'{key} m={m}')}"
                                        if ('Q', f'{key} m={m}') in PREV_MS else "")
            for m, t in zip(QUANT_ROWS, times)) + f" ({times[0]['bound_by']})")
        return times

    for label, k, n in QUANT_SHAPES:
        w = torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
        xs = torch.randn(max(QUANT_ROWS), k, generator=gen, device="cuda")
        for mode, kw in QUANT_MODES.items():
            p = quantize_tensor(w, 0, **kw)
            wdeq = qm.dequantize(p, bf)
            times = case(f"{label} {mode} [{k}, {n}]", f"{label} {mode}", lambda m: xs[:m],
                         lambda x: qm.quant_matmul(x, p),
                         lambda x: qm.matmul_plain(x, p), lambda x: x @ wdeq, p, n)
            if label == "1B w_gate/w_up" and mode == "int8":
                main = times[0]
            del p, wdeq
        del w, xs
    # the untied int8 head of Llama-3.1-8B's width, through its speech window
    lo, size = 262, 65542
    cfg8 = llama.llama31_8b_config(n_layers=1)
    w = torch.randn(cfg8.dim, lo + size + 64, generator=gen, device="cuda") * cfg8.dim ** -0.5
    head = llama.slice_logits_head({"lm_head": {"kernel": quantize_tensor(w, 0)}}, cfg8, lo,
                                   size)
    del w
    wdeq = qm.dequantize(head, bf)
    xs = torch.randn(max(QUANT_ROWS), cfg8.dim, generator=gen, device="cuda")
    case(f"8B lm_head window int8 [{cfg8.dim}, {size}]", "8B lm_head window int8",
         lambda m: xs[:m],
         lambda x: qm.quant_matmul(x, head), lambda x: qm.matmul_plain(x, head),
         lambda x: x @ wdeq, head, size)
    del head, wdeq
    # the tied head of Llama-3.2-1B: embedding rows of the speech window
    cfg1 = llama.llama32_1b_config()
    emb = torch.randn(cfg1.vocab_size, cfg1.dim, generator=gen, device="cuda") * 0.02
    xs = torch.randn(max(QUANT_ROWS), cfg1.dim, generator=gen, device="cuda")
    for bits in (8, 4):
        q = quantize_tensor(emb, 1, bits=bits)
        win = llama.slice_logits_head({"embed": {"embedding": q}}, cfg1, lo, size)
        wdeq = qm.dequantize(win, bf)
        case(f"1B tied head int{bits} [{size}, {cfg1.dim}]", f"1B tied head int{bits}",
             lambda m: xs[:m],
             lambda x: qm.quant_tied_logits(x, win), lambda x: qm.tied_logits_plain(x, win),
             lambda x: x @ wdeq.T, win, size)
        del q, win, wdeq
    del emb
    log(f"  {n_cases} cases, all within tolerance and bitwise equal over two launches: "
        f"worst max_abs_err {worst:.3e}, {worst_ratio:.2f}x the tolerance at most")
    return dict(max_abs_err=worst, **main)


# --- the GPU path against the CPU path on a small model -----------------------


def check_small_model(tok, sv) -> None:
    """fp32 greedy decode of a small random model: the CPU path (plain
    versions) picks the tokens; the GPU path (kernels) is fed the same
    tokens and its logits must agree at every step. Then the model
    quantized once on the CPU (int8, int4-g64) and moved to both devices:
    the GPU path's greedy ids through ``generate`` must equal the CPU
    path's, and the quantized product must have run on every decode step."""
    from tts_max_tpu_torch import convert
    from tts_max_tpu_torch.inference.generate import generate
    from tts_max_tpu_torch.models import llama, quantization
    from tts_max_tpu_torch.models.codec import vocos
    from tts_max_tpu_torch.ops.quant_matmul import R_MAX, quant_matmul
    from tts_max_tpu_torch.ops.sampling import SamplingParams

    cfg = llama.LlamaConfig(vocab_size=len(tok), dim=256, n_layers=2, n_heads=4,
                            n_kv_heads=2, head_dim=64, ffn_dim=512,
                            dtype=torch.float32)
    cpu = llama.init_params(cfg, seed=3, device="cpu")
    gpu = convert.llama_from_numpy(_numpy_tree(cpu), cfg, device="cuda")
    prompt = np.asarray([tok.encode("a small check", add_special_tokens=True)],
                        dtype=np.int32)
    n = prompt.shape[1]
    window = sv.generation_window()
    res = generate(cpu, cfg, prompt, [n], None, sp=SamplingParams(temperature=0.0),
                   max_new_tokens=8, eos_id=-1, vocab_window=window, device="cpu")
    toks = res.tokens[0].numpy()
    head_c = llama.slice_logits_head(cpu, cfg, *window)
    head_g = llama.slice_logits_head(gpu, cfg, *window)
    cache_c = llama.init_kv_cache(cfg, 1, n + 8, device="cpu")
    cache_g = llama.init_kv_cache(cfg, 1, n + 8, device="cuda")
    lens_c = torch.tensor([n], dtype=torch.int32)
    lens_g = lens_c.cuda()
    t_c, t_g = torch.as_tensor(prompt), torch.as_tensor(prompt).cuda()
    lc, _ = llama.prefill(cpu, cfg, t_c, lens_c, cache_c, head_c)
    lg, _ = llama.prefill(gpu, cfg, t_g, lens_g, cache_g, head_g)
    worst = max_err(lg.cpu(), lc)
    for tkn in toks[:-1]:
        tc = torch.tensor([tkn], dtype=torch.int32)
        lc, _ = llama.decode_step(cpu, cfg, cache_c, tc, lens_c, head_c)
        lg, _ = llama.decode_step(gpu, cfg, cache_g, tc.cuda(), lens_g, head_g)
        lens_c += 1
        lens_g += 1
        worst = max(worst, max_err(lg.cpu(), lc))
    if not worst <= 1e-3:
        raise AssertionError(f"small model: GPU logits differ from CPU by {worst}")
    vcfg = vocos.tiny_vocos_config()
    vcpu = vocos.init_decoder(vcfg, seed=4, device="cpu")
    vgpu = convert.vocos_from_numpy(_numpy_tree(vcpu), vcfg, device="cuda")
    codes = torch.as_tensor(np.random.default_rng(5).integers(0, 65536, (1, 40)))
    wc = vocos.decode(vcpu, codes, vcfg)
    wg = vocos.decode(vgpu, codes.cuda(), vcfg).cpu()
    werr = max_err(wg, wc)
    if not werr <= 1e-3:
        raise AssertionError(f"small codec: GPU wav differs from CPU by {werr}")
    log(f"small model fp32, GPU kernels vs CPU plain: prefill + 7 decode steps "
        f"max logit err {worst:.3e} (tol 1e-3); tiny codec wav max err "
        f"{werr:.3e} (tol 1e-3)")

    def to_cuda(tree):
        return ({k: to_cuda(v) for k, v in tree.items()} if isinstance(tree, dict)
                else tree.cuda())

    for mode, kw in (("int8", dict(bits=8)), ("int4-g64", dict(bits=4, group_size=64))):
        qcpu = quantization.quantize_llama_params(cpu, **kw)
        qgpu = to_cuda(qcpu)
        ids = {}
        for params, device in ((qcpu, "cpu"), (qgpu, "cuda")):
            quant_matmul.launches = 0
            res = generate(params, cfg, prompt, [n], None, sp=SamplingParams(temperature=0.0),
                           max_new_tokens=16, eos_id=-1, vocab_window=window, device=device)
            ids[device] = res.tokens[0].cpu().numpy()
        # each decode step, and the prefill: its head, and its layers when the
        # prompt has at most R_MAX rows
        want = (7 * cfg.n_layers + 1) * res.steps + 1 + 7 * cfg.n_layers * (n <= R_MAX)
        if not (np.array_equal(ids["cpu"], ids["cuda"]) and quant_matmul.launches == want):
            raise AssertionError(f"small model {mode}: GPU ids {ids['cuda']} vs CPU "
                                 f"{ids['cpu']}; {quant_matmul.launches} quantized launches, "
                                 f"expected {want}")
        log(f"small model {mode} (quantized on the CPU, moved to both): greedy ids identical "
            f"over {res.steps} steps; quant_matmul launches {quant_matmul.launches} "
            f"(expected {want}: {7 * cfg.n_layers + 1} a step, prompt of {n} rows)")


def check_small_train() -> None:
    """One fp32 train step of a narrow 2-layer model on the CPU (plain
    versions) and on the card (kernels A and A'), from the same weights and
    batch: loss, every leaf's grad and the updated params must agree, and
    every leaf's grad on the card must be finite and non-zero (wq, wk, wv
    and attn_norm reach the loss only through attention's backward)."""
    import dataclasses as dc

    from tts_max_tpu_torch.models import llama
    from tts_max_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from tts_max_tpu_torch.training import optim, train_step as ts

    cfg = llama.LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                            head_dim=64, ffn_dim=512, rope_theta=10000.0,
                            use_llama3_rope_scaling=False, max_seq_len=256,
                            dtype=torch.float32)
    cpu = llama.init_params(cfg, seed=5, device="cpu")
    gpu = optim.tree_map(lambda t: t.cuda(), cpu)
    rng = np.random.default_rng(6)
    ids = rng.integers(0, cfg.vocab_size, (1, 2, 200)).astype(np.int32)
    labels = ids.copy()
    labels[..., :20] = -100
    batch = {"input_ids": ids, "labels": labels}
    micro = {k: v[0] for k, v in batch.items()}
    flash_attention_bwd.launches = 0
    out = {}
    for name, params in (("cpu", cpu), ("gpu", gpu)):
        loss, _, grads = ts._loss_and_grads(params, cfg, ts.to_device_batch(
            micro, llama.params_device(params)), 0)
        tx = optim.create_optimizer(1e-3)
        new, _, m = ts.train_step(params, tx.init(params), batch, cfg=cfg, tx=tx)
        out[name] = (float(loss), grads, new, m)
    if flash_attention_bwd.launches != 2 * cfg.n_layers:
        raise AssertionError(f"small train: kernel A' launched {flash_attention_bwd.launches} "
                             f"times, expected {2 * cfg.n_layers}")
    lc, gc, pc, _ = out["cpu"]
    lg, gg, pg, _ = out["gpu"]
    if not abs(lg - lc) <= 1e-5 * abs(lc):
        raise AssertionError(f"small train: loss {lg} on the card, {lc} on the CPU")
    worst_g = 0.0
    for path, a in optim.tree_items(gg):
        ref = dict(optim.tree_items(gc))[path]
        if not (bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0):
            raise AssertionError(f"small train: grad of {path} on the card is "
                                 f"{'non-finite' if not torch.isfinite(a).all() else 'zero'}")
        # fp32 on both: sum order and A's GRAD_TOL, relative to the leaf's scale
        rel = max_err(a.cpu(), ref) / float(ref.abs().max())
        worst_g = max(worst_g, rel)
        if not rel <= 1e-4:
            raise AssertionError(f"small train: grad of {path}: max err {rel:.2e} of max|g|")
    # Adam's first update is lr * g / (|g| + eps) per element: an element whose
    # tiny grad differs in sign between the devices moves by up to 2 lr. So the
    # card's step is held against the CPU's optimizer applied to the card's own
    # grads (clipped as the step clips them): fp32 elementwise rounding only.
    g_card = optim.tree_map(lambda t: t.cpu(), gg)
    gnorm = optim.global_norm(g_card)
    if float(gnorm) > 1.0:
        g_card = optim.tree_map(lambda t: t * (1.0 / gnorm), g_card)
    tx = optim.create_optimizer(1e-3)
    upd, _ = tx.update(g_card, tx.init(cpu), cpu)
    want = optim.apply_updates(cpu, upd)
    worst_p = max(max_err(a.cpu(), dict(optim.tree_items(want))[path])
                  for path, a in optim.tree_items(pg))
    if not worst_p <= 1e-6:
        raise AssertionError(f"small train: the card's AdamW step differs from the CPU's "
                             f"on the same grads by {worst_p}")
    named = [p for p, _ in optim.tree_items(gg) if re.search(r"wq|wk|wv|attn_norm", p)]
    log(f"small train fp32, GPU kernels A/A' vs CPU plain: loss {lg:.6f} vs {lc:.6f}; "
        f"grads of {len(list(optim.tree_items(gg)))} leaves finite and non-zero on the card "
        f"(incl. {', '.join(named)}), max err {worst_g:.2e} of each leaf's max (tol 1e-4); "
        f"params after one AdamW step (lr 1e-3) within {worst_p:.2e} of the CPU optimizer's "
        f"step on the card's grads (tol 1e-6)")


@contextlib.contextmanager
def nccl_world_of_one():
    """torchrun's variables for one rank, meeting on a free local port, set
    around a call and removed after: the entry points called inside join
    an NCCL group of world size 1 (``parallel/mesh.initialize_distributed``)
    and end it on return."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def check_small_nccl_step() -> None:
    """The mesh train step through an NCCL group of world size 1 against the
    one-device step, on the card, fp32, from the same weights and batch (2
    micro-steps, remat, the chunked loss), under fsdp (every split leaf
    gathered, its grad reduce-scattered) and dp: the loss and tokens equal,
    the grad norm within 1e-6 (the split leaves' squares are added after the
    whole ones'), every param within 1e-7, and the collectives the step's
    structure implies."""
    import torch.distributed as dist

    from tts_max_tpu_torch.models import llama
    from tts_max_tpu_torch.parallel import collectives, mesh as pmesh
    from tts_max_tpu_torch.training import optim, train_step as ts

    cfg = llama.LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                            head_dim=64, ffn_dim=512, rope_theta=10000.0,
                            use_llama3_rope_scaling=False, max_seq_len=256,
                            dtype=torch.float32, remat=True)
    params = llama.init_params(cfg, seed=7, device="cuda")
    rng = np.random.default_rng(8)
    ids = rng.integers(0, cfg.vocab_size, (2, 2, 200)).astype(np.int32)
    labels = ids.copy()
    labels[..., :20] = -100
    batch = {"input_ids": ids, "labels": labels}
    tx = optim.create_optimizer(1e-3)
    p1, _, m1 = ts.train_step(params, tx.init(params), batch, cfg=cfg, tx=tx,
                              loss_chunk_size=64)
    L, A = cfg.n_layers, 2
    lines = []
    with nccl_world_of_one():
        env = pmesh.initialize_distributed("cuda")
        try:
            if dist.get_backend() != "nccl":
                raise AssertionError(f"small NCCL step: backend {dist.get_backend()}")
            for strategy in ("fsdp", "dp"):
                mesh = pmesh.build_mesh((1, 1, 1), strategy)
                step = ts.make_train_step(mesh, cfg, tx, params, 1.0, 64)
                p, o = step.shard(params, tx.init(params))
                collectives.reset_counts()
                p2, _, m2 = step(p, o, batch)
                got = collectives.counts()
                split = strategy == "fsdp"
                want = dict(all_reduce_sum=4 if split else 3,
                            all_gather=1 + A * 2 * 7 * L if split else 0,
                            reduce_scatter_sum=A * 7 * L + 1 if split else 0, barrier=0)
                p2 = step.layout.gather(p2)
                worst = max(max_err(a, dict(optim.tree_items(p1))[path])
                            for path, a in optim.tree_items(p2))
                if not ((m2.loss, m2.tokens) == (m1.loss, m1.tokens)
                        and abs(m2.grad_norm - m1.grad_norm) <= 1e-6 * m1.grad_norm
                        and worst <= 1e-7 and got == want):
                    raise AssertionError(f"small NCCL step {strategy}: {m2} vs {m1}, params "
                                         f"{worst:.2e}, collectives {got} (want {want})")
                lines.append(f"{strategy} collectives {got}, params within {worst:.1e}")
        finally:
            pmesh.destroy_distributed(env)
    log(f"small train step through NCCL at world size 1 vs the one-device step (fp32, "
        f"2 x 2 x 200, remat, chunked loss): loss {m1.loss:.6f} equal, grad norm "
        f"{m1.grad_norm:.6f}; " + "; ".join(lines))


TRAIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke_train")
TRAIN_STEPS = 8
FIXED_VOCAB = 193856  # core/constants.FIXED_VOCAB_SIZE
SFT_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "example", "configs",
                          "sft.json")


def _write_train_dataset(path: str) -> None:
    """16 train and 4 val samples of 1400-1500 seeded codes (28-30 s at 50
    Hz: the data filter drops samples over 30 s) with short transcripts,
    written by the port's codes_io: prompts of ~1500-1650 tokens, padded to
    the 2048 bucket, so batches repeat across epochs at batch 4."""
    from tts_max_tpu_torch.data import codes_io
    from tts_max_tpu_torch.data.samples import Sample

    rng = np.random.default_rng(11)
    for split, n in (("train", 16), ("val", 4)):
        lens = rng.integers(1400, 1501, n)
        codes = rng.integers(0, 65536, int(lens.sum())).astype(np.int32)
        index = np.concatenate([[0], np.cumsum(lens)[:-1]])
        samples = [Sample.from_json({"wav_path": f"{split}{i}.wav",
                                     "transcript": ENGINE_TEXTS[i % len(ENGINE_TEXTS)],
                                     "language": "en", "duration": float(lens[i]) / 50,
                                     "sample_rate": 16000}, "synthetic") for i in range(n)]
        codes_io.write_shard(path, split, codes, index, samples)


def write_sft_config(train_dir: str) -> tuple[str, dict, dict, str]:
    """``example/configs/sft.json`` as users run it, with only the dataset
    paths (a seeded dataset written under ``train_dir``), the output dir,
    the checkpoints kept and the vocab changed, written to
    ``train_dir/sft.json``: (its path, the config, the changes, the data
    dir)."""
    import shutil

    shutil.rmtree(train_dir, ignore_errors=True)
    data = os.path.join(train_dir, "synthetic")
    _write_train_dataset(data)
    with open(SFT_CONFIG) as f:
        cfg = json.load(f)
    changes = {"train_weighted_datasets": {data: 1.0}, "val_weighted_datasets": {data: 1.0},
               "output_dir": os.path.join(train_dir, "out")}
    cfg.update(changes)
    cfg["checkpointing"]["keep_only_last_n_checkpoints"] = 1
    # the published width: Llama-3.2-1B with the fixed 193856-token speech
    # vocab (FIXED_VOCAB_SIZE, what an HF dir of the model carries); the byte
    # tokenizer's 65806 ids index its first rows
    cfg["modeling"]["parameters"]["vocab_size"] = FIXED_VOCAB
    path = os.path.join(train_dir, "sft.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path, cfg, changes, data


def run_training(counters, validation) -> dict:
    """SFT at the full width of Llama-3.2-1B through the entry point users
    run, ``python -m tts_max_tpu_torch.training.main --config_path ...``
    (called in-process), on ``example/configs/sft.json`` with only the
    dataset paths, the output dir, the checkpoints kept and the step count
    changed; then a one-step resume from its checkpoint that runs
    prompt-continuation quality validation after its checkpoint
    (``save_steps`` 1) with ``validation`` (q1: decoder and encoder
    checkpoint paths and a prompt wav), which must write
    ``continuations/9/continuation_0.wav``, finite. Both runs go through an
    NCCL group of world size 1 (``nccl_world_of_one``): sft.json's
    ``strategy: fsdp`` then splits every rule-sharded leaf into one block,
    and the collectives each run makes must be what its steps, eval, saves
    and validation imply. Returns the launch counts of both runs and the
    first run's losses (t1's reference); the output stays under
    ``TRAIN_DIR`` for c1."""
    import shutil

    from tts_max_tpu_torch import native
    from tts_max_tpu_torch.inference import quality
    from tts_max_tpu_torch.models import llama
    from tts_max_tpu_torch.parallel import collectives
    from tts_max_tpu_torch.training import main as train_main

    path, cfg, changes, data = write_sft_config(TRAIN_DIR)
    arch = llama.config_for_architecture(cfg["modeling"]["parameters"]["architecture"],
                                         vocab_size=FIXED_VOCAB)
    L = arch.n_layers
    log(f"SFT through tts_max_tpu_torch.training.main on {os.path.relpath(SFT_CONFIG)} "
        f"({cfg['modeling']['parameters']['architecture']}: {L} layers, dim {arch.dim}, "
        f"vocab {arch.vocab_size}, batch {cfg['training']['batch_size']}, max_seq_len "
        f"{cfg['modeling']['parameters']['max_seq_len']}, {cfg['training']['precision']}, "
        f"remat {cfg['training']['remat_policy']}, Adam mu {cfg['training']['adam_mu_dtype']}, "
        f"lr {cfg['training']['learning_rate']}, warmup {cfg['training']['warmup_ratio']}); "
        f"changed: datasets -> {os.path.relpath(data)}, output_dir -> "
        f"{os.path.relpath(changes['output_dir'])}, keep_only_last_n_checkpoints 10 -> 1, "
        f"vocab_size (unset: the byte tokenizer's 65806) -> {FIXED_VOCAB}, "
        f"--total_steps {TRAIN_STEPS}; free disk "
        f"{shutil.disk_usage(TRAIN_DIR).free / 2**30:.1f} GiB")

    _zero(counters)
    collectives.reset_counts()
    native.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _FetchCounter() as fetched, nccl_world_of_one():
        res = train_main.main(["--config_path", path, "--total_steps", str(TRAIN_STEPS)])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    got = _counts(counters)
    calls = collectives.counts()
    if fetched.n < TRAIN_STEPS * cfg["training"]["batch_size"]:
        raise AssertionError(f"SFT fetched {fetched.n} samples in {TRAIN_STEPS} steps")
    _check_host_counts("SFT", encodes_at_least=fetched.n)
    losses = [m.loss for _, m, _, _ in res.steps]
    if not (len(losses) == TRAIN_STEPS and np.isfinite(losses).all()
            and losses[-1] < losses[0]):
        raise AssertionError(f"SFT losses {losses}")
    eval_batches = 4 // cfg["training"]["batch_size"]  # at step 0 only (eval_steps 300)
    want = _want(counters)
    # remat: each layer's forward runs twice a step (with the log-sum-exp), once
    # an eval batch (without); its backward once a step
    want.update(flash_attention=L * (2 * TRAIN_STEPS + eval_batches),
                flash_attention_bwd=L * TRAIN_STEPS)
    _check_counts("SFT", got, want)
    _check_collectives("SFT", calls, sft_collectives(L, TRAIN_STEPS, eval_batches, saves=1,
                                                     validations=0, logs=1))
    out = changes["output_dir"]
    ckpt = os.path.join(out, "checkpoints", str(TRAIN_STEPS), "state.pt")
    final = os.path.join(out, "final_model", "model.safetensors")
    if not (os.path.isfile(ckpt) and os.path.isfile(final)
            and os.path.isfile(os.path.join(out, "training_config.json"))):
        raise AssertionError(f"SFT outputs missing under {out}: {os.listdir(out)}")
    secs = [s for _, _, s, _ in res.steps]
    toks = [n for _, _, _, n in res.steps]
    ms_step = 1e3 * float(np.median(secs[2:]))
    tok_s = float(np.median([n / s for n, s in zip(toks[2:], secs[2:])]))
    log(f"  SFT {TRAIN_STEPS} steps in {wall:.1f} s: losses "
        + " ".join(f"{x:.4f}" for x in losses)
        + f"; grad norms " + " ".join(f"{m.grad_norm:.3f}" for _, m, _, _ in res.steps))
    log(f"  SFT train tokens/s (tools/bench_train.py's metric, padded batch tokens / step "
        f"time, median of steps 3-{TRAIN_STEPS}): {tok_s:.0f}; ms/step {ms_step:.1f} through "
        f"an NCCL group of world size 1 with fsdp's gathers (one device, no group: "
        f"352.3-357.1 ms/step in PERF.md, H100 80GB HBM3 at 700 W) "
        f"(step seconds {' '.join(f'{s:.3f}' for s in secs)}; padded tokens a step "
        f"{toks}); peak torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB; "
        f"checkpoint {os.path.getsize(ckpt) / 2**30:.2f} GiB saved in "
        f"{res.checkpoint_seconds[-1]:.2f} s; final_model "
        f"{os.path.getsize(final) / 2**30:.2f} GiB in {res.final_model_seconds:.2f} s; "
        f"launches {got}; collectives {calls}; {gpu_line()}")
    del res

    cfg["checkpointing"]["only_load_model_weights"] = False
    dec_path, enc_path, wav_path = validation
    cfg["checkpointing"].update(validation_type="prompt_continuation", save_steps=1)
    argv = ["--config_path", path, "--total_steps", str(TRAIN_STEPS + 1),
            "--codec_decoder_checkpoint", dec_path, "--codec_encoder_checkpoint", enc_path,
            "--validation_prompt_wavs", f"{wav_path}:{REQUESTS[1][2]}"]
    with open(path, "w") as f:
        json.dump(cfg, f)
    _zero(counters)
    collectives.reset_counts()
    t0 = time.perf_counter()
    with _WavRecorder(quality) as rec, nccl_world_of_one():
        res = train_main.main(argv)
    resume_s = time.perf_counter() - t0
    got2 = _counts(counters)
    calls2 = collectives.counts()
    _check_collectives("SFT resume", calls2, sft_collectives(L, 1, 0, saves=1, validations=1,
                                                             logs=1))
    if not ([s for s, _, _, _ in res.steps] == [TRAIN_STEPS + 1]
            and res.statistics.step == TRAIN_STEPS + 1 and np.isfinite(res.steps[0][1].loss)
            and os.path.isfile(os.path.join(out, "checkpoints", str(TRAIN_STEPS + 1),
                                            "state.pt"))
            and not os.path.exists(os.path.join(out, "checkpoints", str(TRAIN_STEPS)))):
        raise AssertionError(f"SFT resume: steps {[s for s, _, _, _ in res.steps]}, "
                             f"statistics at {res.statistics.step}")
    # the step (A twice a layer with remat, A' once), then the continuation: the
    # prompt's encode (G), its prefill (A) and 1-256 decode steps (B)
    steps = got2["flash_decode_attention"] // L
    _check_counts("SFT resume", got2, _want(
        counters, flash_attention=3 * L, flash_attention_bwd=L,
        flash_decode_attention=L * steps, activation1d_kernel=G_PER_ENCODE))
    wav = os.path.join(out, "continuations", str(TRAIN_STEPS + 1), "continuation_0.wav")
    _check_wavs("q1 continuation", rec, [wav])
    if not 1 <= steps <= 256:
        raise AssertionError(f"q1: the continuation took {steps} decode steps")
    log(f"  SFT resume (only_load_model_weights true -> false): step {TRAIN_STEPS + 1} from "
        f"the step-{TRAIN_STEPS} checkpoint, loss {res.steps[0][1].loss:.4f}, checkpoint "
        f"{res.checkpoint_seconds[-1]:.2f} s, wall {resume_s:.1f} s; q1 prompt-continuation "
        f"validation (save_steps 1, the 5 s prompt): {steps} tokens, "
        f"{_check_wav_file('q1', wav) / 16000:.2f} s of audio written finite; "
        f"launches {got2}; collectives {calls2}")
    return {k: got[k] + got2[k] for k in got}, losses


TP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_tp")
TP_STEPS = 4
# t1's losses against the fsdp run's (the same config, seed, data and
# schedule up to step 3; a tp mesh of one rank multiplies the same blocks,
# and its cross entropy reduces the same fp32 logits through max, sum and
# log in place of logsumexp): steps 1-2 read the same params (the first
# update runs at lr 0), step 3 those after one update at the peak lr, whose
# bf16 weights may round one ulp apart where the fp32 grads differ in their
# last bits
TP_LOSS_RTOL = {1: 1e-5, 2: 1e-5, 3: 1e-3}


def tp_sft_collectives(L: int, steps: int, chunks: int, eval_batches: int, saves: int,
                       logs: int) -> tuple[dict, dict]:
    """The collectives of one ``training.main`` run under ``tp`` (``counts()``
    and ``counts_tp()``), by the step's structure, at one micro-step a step
    with remat and the loss in ``chunks`` chunks a micro-batch. A step's
    forward sums the embedding's lookup and each layer's two row-parallel
    products (1 + 2 L row-parallel exits); remat's recompute sums each
    layer's attention product again (the recompute stops at the layer's
    last saved tensor, before the MLP's sum): L more. Its backward sums the
    grad of each column-parallel entry, two a layer and the head's one a
    chunk. The vocab-parallel cross entropy reduces each chunk's max, sum
    of exponentials and target logit (one max and two sums), in the
    forward and again in the chunk's recompute; the step's own all-reduces
    are four (valid tokens, loss terms, the grads, the norm of the
    tensor-split leaves). An eval batch runs one forward and reduces its
    sums once. A checkpoint gathers every tensor-split leaf of the params,
    mu and nu, the final model those of the params (8: the 7 stacked
    leaves and the embedding); each save and the final model end at a
    barrier."""
    split = 8
    dp = dict(all_reduce_sum=steps * (4 + 4 * chunks) + eval_batches * (1 + 2 * chunks)
              + (1 if eval_batches else 0) + logs,
              all_gather=saves * 3 * split + split, reduce_scatter_sum=0, barrier=saves + 1)
    tp = dict(tensor_enter=steps * (2 * L + chunks),
              tensor_exit=steps * (1 + 3 * L) + eval_batches * (1 + 2 * L),
              all_reduce_max=steps * 2 * chunks + eval_batches * chunks, broadcast=0)
    return dp, tp


def run_tp_training(counters, fsdp_losses) -> dict:
    """t1: the SFT run's config with ``strategy: tp``, through the entry
    point in an NCCL group of world size 1 (a ``(1, 1, 1)`` mesh whose
    tensor axis splits into one block: every row-parallel sum, entry grad
    and vocab-parallel reduction made), ``TP_STEPS`` steps and one
    checkpoint; its losses against the fsdp SFT run's (``TP_LOSS_RTOL``),
    its kernel launches and collectives against their formulas; then one
    step resumed from its checkpoint under ``fsdp`` (the whole leaves
    re-split over the other axis). Returns the launch counts."""
    import shutil

    from tts_max_tpu_torch.models import llama
    from tts_max_tpu_torch.parallel import collectives
    from tts_max_tpu_torch.training import main as train_main

    path, cfg, changes, data = write_sft_config(TP_DIR)
    cfg["training"]["strategy"] = "tp"
    with open(path, "w") as f:
        json.dump(cfg, f)
    L = llama.config_for_architecture(cfg["modeling"]["parameters"]["architecture"]).n_layers
    seq = cfg["modeling"]["parameters"]["max_seq_len"]
    chunks = -(-(seq - 1) // cfg["training"].get("loss_chunk_size", 256))
    log(f"t1: the SFT run's config with strategy fsdp -> tp, --total_steps {TP_STEPS}, "
        f"the checkpoint at the end; {chunks} loss chunks a micro-batch")
    _zero(counters)
    collectives.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with nccl_world_of_one():
        res = train_main.main(["--config_path", path, "--total_steps", str(TP_STEPS)])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    got = _counts(counters)
    losses = [m.loss for _, m, _, _ in res.steps]
    if not (len(losses) == TP_STEPS and np.isfinite(losses).all()):
        raise AssertionError(f"t1 losses {losses}")
    for step, rtol in TP_LOSS_RTOL.items():
        a, b = losses[step - 1], fsdp_losses[step - 1]
        if not abs(a - b) <= rtol * abs(b):
            raise AssertionError(f"t1 step {step}: loss {a} vs the fsdp run's {b} "
                                 f"(rtol {rtol})")
    eval_batches = 4 // cfg["training"]["batch_size"]
    _check_counts("t1", got, _want(counters,
                                   flash_attention=L * (2 * TP_STEPS + eval_batches),
                                   flash_attention_bwd=L * TP_STEPS))
    want_dp, want_tp = tp_sft_collectives(L, TP_STEPS, chunks, eval_batches, saves=1, logs=1)
    _check_collectives("t1", collectives.counts(), want_dp)
    _check_collectives("t1 tensor-parallel", collectives.counts_tp(), want_tp)
    secs = [s for _, _, s, _ in res.steps]
    toks = [n for _, _, _, n in res.steps]
    ms_step = 1e3 * float(np.median(secs[2:]))
    tok_s = float(np.median([n / s for n, s in zip(toks[2:], secs[2:])]))
    log(f"  t1 {TP_STEPS} steps in {wall:.1f} s: losses "
        + " ".join(f"{x:.6f}" for x in losses) + " (the fsdp run's "
        + " ".join(f"{x:.6f}" for x in fsdp_losses[:TP_STEPS]) + ")")
    log(f"  t1 tensor-parallel SFT at world size 1: ms/step {ms_step:.1f}, train tokens/s "
        f"{tok_s:.0f} (median of steps 3-{TP_STEPS}; the fsdp SFT at world size 1: "
        f"376.7-404.2 ms/step in PERF.md, H100 80GB HBM3 at 700 W) (step seconds "
        f"{' '.join(f'{x:.3f}' for x in secs)}); peak torch.cuda.max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; launches {got}; collectives {collectives.counts()} "
        f"{collectives.counts_tp()}; {gpu_line()}")
    del res

    cfg["training"]["strategy"] = "fsdp"
    cfg["checkpointing"]["only_load_model_weights"] = False
    with open(path, "w") as f:
        json.dump(cfg, f)
    _zero(counters)
    collectives.reset_counts()
    with nccl_world_of_one():
        res = train_main.main(["--config_path", path, "--total_steps", str(TP_STEPS + 1)])
    got2 = _counts(counters)
    if not ([s for s, _, _, _ in res.steps] == [TP_STEPS + 1]
            and res.statistics.step == TP_STEPS + 1 and np.isfinite(res.steps[0][1].loss)):
        raise AssertionError(f"t1 resume under fsdp: steps {[s for s, _, _, _ in res.steps]}")
    _check_counts("t1 resume under fsdp", got2,
                  _want(counters, flash_attention=2 * L, flash_attention_bwd=L))
    _check_collectives("t1 resume under fsdp", collectives.counts(),
                       sft_collectives(L, 1, 0, saves=1, validations=0, logs=1))
    _check_collectives("t1 resume under fsdp", collectives.counts_tp(),
                       dict(tensor_enter=0, tensor_exit=0, all_reduce_max=0, broadcast=0))
    log(f"  t1 resumed under fsdp from the tp run's step-{TP_STEPS} checkpoint: step "
        f"{TP_STEPS + 1} loss {res.steps[0][1].loss:.6f}; collectives {collectives.counts()}")
    del res
    shutil.rmtree(TP_DIR)
    return {k: got[k] + got2[k] for k in got}


def sft_collectives(L: int, steps: int, eval_batches: int, saves: int, validations: int,
                    logs: int) -> dict:
    """The collectives of one ``training.main`` run under fsdp, by the
    step's structure (``ShardedTrainStep``), at one micro-step a step with
    remat and tied embeddings: 7 split leaves a layer and the embedding.
    A step gathers the embedding once and each layer's leaves twice (its
    forward and its recompute), reduce-scatters each layer's grads and the
    embedding's once, and all-reduces four times (the valid-token counts,
    the loss terms, the whole leaves' grads, the shards' norm). An eval
    batch gathers the embedding and each layer once and all-reduces its
    sums once, and the statistics' sum of each eval and log is one more.
    A checkpoint gathers every split leaf of the params, mu and nu; a
    validation (and building the validator) and the final model gather
    the params; each save and the final model end at a barrier."""
    leaves = 7 * L + 1
    split = 8  # the stacked leaves and the embedding, gathered whole
    return dict(
        all_gather=steps * (1 + 2 * 7 * L) + eval_batches * (1 + 7 * L) + saves * 3 * split
        + (validations + (1 if validations else 0)) * split + split,
        reduce_scatter_sum=steps * leaves,
        all_reduce_sum=4 * steps + eval_batches + (1 if eval_batches else 0) + logs,
        barrier=saves + 1)


def _check_collectives(label: str, got: dict, want: dict) -> None:
    if got != want:
        raise AssertionError(f"{label}: collectives {got}, expected {want}")


def check_small_engine(tok, sv) -> None:
    """The paged engine on the card and on the CPU, small fp32 model
    (head_dim 64), greedy, prefix cache on: token ids identical under each
    of the dense, dma and grid entry points, and the same prefix hits."""
    import os

    from tts_max_tpu_torch import convert
    from tts_max_tpu_torch.inference.engine import PagedInferenceEngine
    from tts_max_tpu_torch.models import llama
    from tts_max_tpu_torch.ops.sampling import SamplingParams

    cfg = llama.LlamaConfig(vocab_size=len(tok), dim=256, n_layers=2, n_heads=4,
                            n_kv_heads=2, head_dim=64, ffn_dim=512, dtype=torch.float32)
    cpu = llama.init_params(cfg, seed=5, device="cpu")
    gpu = convert.llama_from_numpy(_numpy_tree(cpu), cfg, device="cuda")
    shared = "a shared voice prompt, long enough to fill two blocks of the pool: " * 2
    texts = [shared + "one", "another prompt entirely", shared + "two, longer",
             shared + "three", "and a fifth"]
    prompts = [np.asarray(tok.encode(t, add_special_tokens=True), np.int32) for t in texts]

    def run(params, device):
        eng = PagedInferenceEngine(params, cfg, max_batch=2, max_len=512, block_size=64,
                                   sp=SamplingParams(temperature=0.0), vocab_window=sv.generation_window(),
                                   enable_prefix_cache=True, steps_per_dispatch=4,
                                   device=device)
        done = eng.generate_all(prompts, max_new_tokens=16, eos_id=-1)
        return [c.tokens.tolist() for c in done], eng.prefix_cache_hits

    want, hits = run(cpu, "cpu")
    if hits == 0:
        raise AssertionError("small engine: no prefix-cache hit")
    before = os.environ.get("TTS_MAX_PAGED_ATTN")
    try:
        for variant in ("dense", "dma", "grid"):
            os.environ["TTS_MAX_PAGED_ATTN"] = variant
            got, ghits = run(gpu, "cuda")
            if got != want or ghits != hits:
                raise AssertionError(f"small engine {variant}: GPU ids {got} (hits {ghits}) "
                                     f"!= CPU ids {want} (hits {hits})")
    finally:
        if before is None:
            os.environ.pop("TTS_MAX_PAGED_ATTN", None)
        else:
            os.environ["TTS_MAX_PAGED_ATTN"] = before
    log(f"small paged engine fp32, GPU (dense, dma, grid) vs CPU plain: greedy ids "
        f"identical over {len(prompts)} requests x 16 tokens, prefix hits {hits} on both")


def _liven(tree, rng, key=None):
    """A numpy parameter tree with random log-scale SnakeBeta parameters and
    conv kernels x6, so that signals survive a tiny encoder and its codes
    vary (26 distinct codes of 26 on the seeded wav)."""
    if isinstance(tree, dict):
        return {k: _liven(v, rng, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_liven(v, rng, key) for v in tree]
    if key in ("alpha", "beta"):
        return (0.3 * rng.standard_normal(tree.shape)).astype(np.float32)
    return tree * 6 if key == "kernel" and tree.ndim == 3 else tree


def check_small_encoder() -> None:
    """The tiny codec encoder over a tiny w2v-bert on the real 160 features,
    fp32, one seeded 0.5 s wav: the card (kernel G) against the CPU (its
    plain version), codes identical and acoustic features within 1e-5 of
    their largest magnitude, as tests/test_torch_encoder.py holds them."""
    from tts_max_tpu_torch import convert
    from tts_max_tpu_torch.models.codec import api, encoder, w2vbert
    from tts_max_tpu_torch.ops.act1d import activation1d_kernel

    wcfg = w2vbert.W2VBertConfig(**{**w2vbert.tiny_w2vbert_config().__dict__,
                                    "feature_dim": 160})
    ecfg = encoder.EncoderConfig(**{**encoder.tiny_encoder_config().__dict__,
                                    "semantic_input_dim": wcfg.hidden_size})
    tree = _liven(_numpy_tree(encoder.init_encoder(ecfg, seed=11, device="cpu")),
                  np.random.default_rng(12))
    w2v = _numpy_tree(w2vbert.init_params(wcfg, seed=13, device="cpu"))
    encs, acoustic = {}, {}
    wav = prompt_wav(0.5, seed=14)
    padded = encoder.pad_wav_for_encode(wav[None], ecfg.hop_length)
    for dev in ("cpu", "cuda"):
        params = convert.encoder_from_numpy(tree, ecfg, device=dev)
        semantic = w2vbert.default_semantic_fn(
            params=convert.w2vbert_from_numpy(w2v, wcfg, device=dev), cfg=wcfg, device=dev)
        encs[dev] = api.AudioEncoder(params, ecfg, semantic, device=dev)
        with torch.inference_mode():
            acoustic[dev] = encoder.acoustic_encoder(
                torch.from_numpy(padded).to(dev), params["acoustic"], ecfg).cpu()
    before = activation1d_kernel.launches
    codes = {dev: e.encode(wav) for dev, e in encs.items()}
    launches = activation1d_kernel.launches - before
    err = max_err(acoustic["cuda"], acoustic["cpu"])
    scale = float(acoustic["cpu"].abs().max())
    tol = 1e-5 * scale
    if not (np.array_equal(codes["cuda"], codes["cpu"]) and err <= tol and launches == 36):
        raise AssertionError(f"small encoder: GPU codes {codes['cuda']} vs CPU "
                             f"{codes['cpu']}, acoustic err {err} (tol {tol}), "
                             f"G launches {launches}")
    log(f"small codec encoder fp32, GPU (kernel G, {launches} launches) vs CPU plain: "
        f"{codes['cpu'].size} codes identical ({len(np.unique(codes['cpu']))} distinct), "
        f"acoustic features max err {err:.3e} (tol 1e-5 x max |feature| {scale:.3f} "
        f"= {tol:.3e})")


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_numpy_tree(v) for v in t]
    return t.numpy()


# --- seeded codec checkpoints (the inverse of models/codec/torch_import.py) -------


def _cpu(t) -> torch.Tensor:
    return t.detach().cpu().contiguous()


def _linear_sd(p, base: str) -> dict:
    """{"kernel": [in, out], "bias"?} -> a torch Linear's [out, in] weight."""
    sd = {f"{base}.weight": _cpu(p["kernel"].T)}
    if "bias" in p:
        sd[f"{base}.bias"] = _cpu(p["bias"])
    return sd


def _conv_sd(p, base: str) -> dict:
    """{"kernel": [K, Cin, Cout], "bias"?} -> a torch Conv1d's [Cout, Cin, K]."""
    sd = {f"{base}.weight": _cpu(p["kernel"].permute(2, 1, 0))}
    if "bias" in p:
        sd[f"{base}.bias"] = _cpu(p["bias"])
    return sd


def _norm_sd(p, base: str) -> dict:
    return {f"{base}.weight": _cpu(p["scale"]), f"{base}.bias": _cpu(p["bias"])}


def _snake_sd(p, base: str) -> dict:
    return {f"{base}.act.alpha": _cpu(p["alpha"]), f"{base}.act.beta": _cpu(p["beta"])}


def _resnet_sd(p, base: str) -> dict:
    sd = {**_norm_sd(p["norm1"], f"{base}.norm1"), **_conv_sd(p["conv1"], f"{base}.conv1"),
          **_norm_sd(p["norm2"], f"{base}.norm2"), **_conv_sd(p["conv2"], f"{base}.conv2")}
    if "nin_shortcut" in p:
        sd.update(_conv_sd(p["nin_shortcut"], f"{base}.nin_shortcut"))
    return sd


def decoder_state_dict(dec, project_in) -> dict:
    """The xcodec2 state dict that ``torch_import.import_decoder`` reads as
    the port's decoder parameters ``dec`` (no upsampler); ``project_in`` (the
    encoder's FSQ input projection, which the decoder does not use) fills the
    quantizer's other half."""
    bb = dec["backbone"]
    sd = {**_linear_sd(project_in, "generator.quantizer.project_in"),
          **_linear_sd(dec["quantizer"]["project_out"], "generator.quantizer.project_out"),
          **_linear_sd(dec["fc_post_a"], "fc_post_a"),
          **_conv_sd(bb["embed"], "generator.backbone.embed"),
          **_norm_sd(bb["final_norm"], "generator.backbone.final_layer_norm"),
          **_linear_sd(dec["head"]["out"], "generator.head.out")}
    for i in range(2):
        sd.update(_resnet_sd(bb["prior"][i], f"generator.backbone.prior_net.{i}"))
        sd.update(_resnet_sd(bb["post"][i], f"generator.backbone.post_net.{i}"))
    blocks = bb["blocks"]
    for i in range(blocks["att_norm"]["scale"].shape[0]):
        base = f"generator.backbone.transformers.{i}"
        sd[f"{base}.att_norm.weight"] = _cpu(blocks["att_norm"]["scale"][i])
        sd[f"{base}.ffn_norm.weight"] = _cpu(blocks["ffn_norm"]["scale"][i])
        for name, p in (("att.c_attn", blocks["att"]["c_attn"]),
                        ("att.c_proj", blocks["att"]["c_proj"]),
                        ("mlp.fc1", blocks["mlp"]["fc1"]), ("mlp.fc2", blocks["mlp"]["fc2"])):
            sd[f"{base}.{name}.weight"] = _cpu(p["kernel"][i].T)
    return sd


def encoder_state_dict(enc) -> dict:
    """The xcodec2 state dict that ``torch_import.import_encoder`` reads as
    the port's encoder parameters ``enc``."""
    ac, se = enc["acoustic"], enc["semantic"]
    sd = {**_conv_sd(ac["initial"], "CodecEnc.conv_blocks.0"),
          **_snake_sd(ac["final_act"], "CodecEnc.conv_final_block.0"),
          **_conv_sd(ac["final"], "CodecEnc.conv_final_block.1"),
          **_conv_sd(se["initial"], "SemanticEncoder_module.initial_conv"),
          **_conv_sd(se["res1"], "SemanticEncoder_module.residual_blocks.1"),
          **_conv_sd(se["res2"], "SemanticEncoder_module.residual_blocks.3"),
          **_conv_sd(se["final"], "SemanticEncoder_module.final_conv"),
          **_linear_sd(enc["fusion"], "fc_prior"),
          **_linear_sd(enc["quantizer"]["project_in"], "generator.quantizer.project_in"),
          **_linear_sd(enc["quantizer"]["project_out"], "generator.quantizer.project_out")}
    for b, blk in enumerate(ac["blocks"]):
        base = f"CodecEnc.conv_blocks.{b + 1}.block"
        for u, unit in enumerate(blk["units"]):
            sd.update(_snake_sd(unit["act1"], f"{base}.{u}.block.0"))
            sd.update(_conv_sd(unit["conv1"], f"{base}.{u}.block.1"))
            sd.update(_snake_sd(unit["act2"], f"{base}.{u}.block.2"))
            sd.update(_conv_sd(unit["conv2"], f"{base}.{u}.block.3"))
        n = len(blk["units"])
        sd.update(_snake_sd(blk["act"], f"{base}.{n}"))
        sd.update(_conv_sd(blk["down"], f"{base}.{n + 1}"))
    return sd


def w2vbert_state_dict(w2v) -> dict:
    """The HF ``Wav2Vec2BertModel`` state dict that
    ``w2vbert.import_hf_state_dict`` reads as the port's parameters ``w2v``
    (every stacked layer)."""
    lyr, fp = w2v["layers"], w2v["feature_projection"]
    sd = {**_norm_sd(fp["layer_norm"], "feature_projection.layer_norm"),
          **_linear_sd(fp["projection"], "feature_projection.projection")}

    def layer(tree, i):
        return {k: layer(v, i) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]

    for i in range(lyr["attn"]["q"]["kernel"].shape[0]):
        p, base = layer(lyr, i), f"encoder.layers.{i}"
        for ln, name in (("ffn1_ln", "ffn1_layer_norm"), ("attn_ln", "self_attn_layer_norm"),
                         ("conv_ln", "conv_module.layer_norm"), ("ffn2_ln", "ffn2_layer_norm"),
                         ("final_ln", "final_layer_norm")):
            sd.update(_norm_sd(p[ln], f"{base}.{name}"))
        for f in ("ffn1", "ffn2"):
            sd.update(_linear_sd(p[f]["intermediate"], f"{base}.{f}.intermediate_dense"))
            sd.update(_linear_sd(p[f]["output"], f"{base}.{f}.output_dense"))
        for k in ("q", "k", "v", "out"):
            sd.update(_linear_sd(p["attn"][k], f"{base}.self_attn.linear_{k}"))
        sd[f"{base}.self_attn.distance_embedding.weight"] = _cpu(p["attn"]["distance_embedding"])
        sd.update(_norm_sd(p["conv"]["dw_ln"], f"{base}.conv_module.depthwise_layer_norm"))
        for k, name in (("pw1", "pointwise_conv1"), ("dw", "depthwise_conv"),
                        ("pw2", "pointwise_conv2")):
            sd.update(_conv_sd(p["conv"][k], f"{base}.conv_module.{name}"))
    return sd


def write_codec_checkpoints(directory: str, dec, enc, w2v) -> tuple[str, str]:
    """Torch files of seeded codec weights in the layouts the port's
    importers read: ``decoder.pt`` (xcodec2's decoder half) and
    ``encoder.pt`` (the encoder half with the w2v-bert state dict beside it,
    as one xcodec2 checkpoint carries both). Returns both paths."""
    os.makedirs(directory, exist_ok=True)
    dec_path = os.path.join(directory, "decoder.pt")
    enc_path = os.path.join(directory, "encoder.pt")
    torch.save(decoder_state_dict(dec, enc["quantizer"]["project_in"]), dec_path)
    torch.save({**encoder_state_dict(enc), **w2vbert_state_dict(w2v)}, enc_path)
    return dec_path, enc_path


# --- the main path --------------------------------------------------------------


REQUESTS = [
    # (name, prompt id, transcript, voice description, enable_instruction)
    ("a voice description", "none", "", "a calm narrator with a low voice", False),
    ("b 5 s prompt wav", "p5s", "This is the reference speech.", "", True),
    ("c 22 s prompt wav", "p22s", "A much longer reference recording.", "", True),
]
PROMPT_SECONDS = {"p5s": 5.0, "p22s": 22.0}
TEXT = "The quick brown fox jumps over the lazy dog near the riverbank."
G_PER_ENCODE = sum(n for _, _, _, n in ENCODER_SHAPES)  # 36


def prompt_wav(seconds: float, seed: int) -> np.ndarray:
    """A seeded synthetic voice prompt at 16 kHz: a gliding five-harmonic
    tone under a syllable-rate envelope, plus a little noise."""
    n = int(16000 * seconds)
    t = np.arange(n) / 16000
    rng = np.random.default_rng(seed)
    f0 = 120 + 40 * np.sin(2 * np.pi * 0.3 * t + rng.uniform(0, 2 * np.pi))
    phase = 2 * np.pi * np.cumsum(f0) / 16000
    tone = sum(np.sin(k * phase) / k for k in range(1, 6))
    env = 0.2 + 0.8 * np.sin(2 * np.pi * 2.5 * t) ** 2
    return (0.15 * env * tone + 0.01 * rng.standard_normal(n)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def prompt_wavs() -> dict[str, np.ndarray]:
    return {pid: prompt_wav(sec, seed=20 + i) for i, (pid, sec) in enumerate(PROMPT_SECONDS.items())}


def n_prompt_codes(pid: str) -> int:
    """Codes of a prompt: its samples padded to the next hop multiple (a
    whole hop when already one), over the 320-sample hop."""
    return int(16000 * PROMPT_SECONDS[pid]) // 320 + 1


def prompt_length(tok, normalizer, n_codes, transcript, description, instruct):
    from tts_max_tpu_torch.core import prompting

    text = normalizer.normalize(TEXT)
    prompt = prompting.compile_inference_prompt(
        transcript, text, list(range(n_codes)), description, instruct)
    return len(tok.encode(prompt, add_special_tokens=True))


def build_main_path(tok, sv):
    """The main path's model: Llama-3.2-1B geometry, the default Vocos
    decoder, and the default codec encoder (``EncoderConfig()``) over a
    full-width wav2vec-BERT 2.0 (``W2VBertConfig()``: hidden 1024, 24 layers
    initialised, 16 run), fp32, behind a ``CachingAudioEncoder``, random
    weights from fixed seeds. Returns (model, params, cfg, codec), codec
    holding the caching encoder and the encoder's parts. Also used by
    tools/profile_torch_synthesis.py."""
    from tts_max_tpu_torch.inference.synthesize import LocalTtsModel
    from tts_max_tpu_torch.models import llama
    from tts_max_tpu_torch.models.codec import api, encoder, vocos, w2vbert

    cfg = llama.llama32_1b_config()
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=0, device="cuda")
    vcfg = vocos.VocosConfig()
    decoder = api.AudioDecoder(vocos.init_decoder(vcfg, seed=1, device="cuda"),
                               vcfg, api.DecoderConfig(), device="cuda")
    ecfg, wcfg = encoder.EncoderConfig(), w2vbert.W2VBertConfig()
    enc_params = encoder.init_encoder(ecfg, seed=2, device="cuda")
    w2v = w2vbert.init_params(wcfg, seed=3, device="cuda")
    caching = api.CachingAudioEncoder(api.AudioEncoder(
        enc_params, ecfg, w2vbert.default_semantic_fn(params=w2v, cfg=wcfg, device="cuda"),
        device="cuda"))
    torch.cuda.synchronize()
    log(f"main path: llama32_1b_config (vocab {cfg.vocab_size}, {cfg.n_layers} "
        f"layers, dim {cfg.dim}, {cfg.n_heads}/{cfg.n_kv_heads} heads, head_dim "
        f"{cfg.head_dim}, {cfg.dtype}) + VocosConfig (hidden {vcfg.hidden_dim}, "
        f"depth {vcfg.depth}, vq_dim {vcfg.vq_dim}, hop {vcfg.hop_length}) + "
        f"EncoderConfig (generator features {ecfg.num_generator_features}, strides "
        f"{ecfg.up_ratios}, acoustic {ecfg.acoustic_dim}, semantic {ecfg.semantic_dim}, "
        f"fsq dim {ecfg.fsq.dim}) + W2VBertConfig (hidden {wcfg.hidden_size}, "
        f"{wcfg.num_layers} layers, {wcfg.num_layers_to_run} run, {wcfg.num_heads} heads, "
        f"ffn {wcfg.intermediate_size}), codec fp32; random weights in "
        f"{time.perf_counter() - t0:.2f} s")
    codec = types.SimpleNamespace(encoder=caching, params=enc_params, cfg=ecfg, w2v=w2v,
                                  w2v_cfg=wcfg)
    model = LocalTtsModel(params, cfg, tok, sv, caching, decoder, device="cuda")
    return model, params, cfg, codec


def synthesize(model, settings, request):
    _, pid, transcript, desc, instruct = request
    wav = prompt_wavs().get(pid, np.zeros(16000, np.float32))
    return model.synthesize_speech(settings, TEXT, pid, wav, transcript,
                                   voice_description=desc, enable_instruction=instruct)


@torch.inference_mode()
def encode_split(codec, wav: np.ndarray) -> dict:
    """One more encode of ``wav`` stage by stage, each ended by a device
    sync: host features, the w2v-bert layers, the acoustic encoder, and the
    rest (semantic encoder, fusion, FSQ). Returns ms per stage and the codes."""
    from tts_max_tpu_torch.models.codec import encoder, fsq, vocos, w2vbert

    padded = encoder.pad_wav_for_encode(wav[None], codec.cfg.hop_length)
    half = codec.cfg.hop_length // 2
    t0 = time.perf_counter()
    feats = w2vbert.extract_features(np.pad(padded, ((0, 0), (half, half))))
    t1 = time.perf_counter()
    hidden = w2vbert.encode(codec.w2v, torch.from_numpy(feats).cuda(), codec.w2v_cfg)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ac = encoder.acoustic_encoder(torch.from_numpy(padded).cuda(), codec.params["acoustic"],
                                  codec.cfg)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    se = encoder.semantic_encoder(hidden, codec.params["semantic"], codec.cfg)
    n = min(ac.shape[1], se.shape[1])
    fused = vocos.linear(torch.cat([se[:, :n], ac[:, :n]], dim=-1), codec.params["fusion"])
    codes = fsq.encode(codec.params["quantizer"], fused, codec.cfg.fsq)[1].cpu().numpy()[0]
    t4 = time.perf_counter()
    return dict(features=1e3 * (t1 - t0), w2vbert=1e3 * (t2 - t1), acoustic=1e3 * (t3 - t2),
                rest=1e3 * (t4 - t3), codes=codes)


def run_main_path(tok, sv, counters):
    """Three synthesis requests (two of them encode their prompt wav) and an
    int8-KV generate; returns the model, its parts and the launch counts of
    this path."""
    from tts_max_tpu_torch import native
    from tts_max_tpu_torch.data import normalization
    from tts_max_tpu_torch.inference.generate import generate
    from tts_max_tpu_torch.inference.synthesize import InferenceSettings
    from tts_max_tpu_torch.ops.sampling import SamplingParams

    model, params, cfg, codec = build_main_path(tok, sv)
    settings = InferenceSettings(max_tokens=256)

    _zero(counters)
    native.reset_counts()
    steps = 0
    prefills = 0
    for request in REQUESTS:
        name, pid, transcript, desc, instruct = request
        res = synthesize(model, settings, request)
        prefills += 1
        steps += res.decode_steps
        wav = res.wav
        if not (wav.ndim == 2 and wav.shape[1] % 320 == 0 and np.isfinite(wav).all()):
            raise AssertionError(f"request {name}: bad wav {wav.shape}")
        if desc and res.encoding_time != 0.0:
            raise AssertionError("voice-description mode encoded the prompt")
        n_codes = 0
        enc = ""
        if pid in PROMPT_SECONDS:
            codes = codec.encoder.encode(pid, None)  # the request's encode, from the cache
            n_codes, sec = len(codes), PROMPT_SECONDS[pid]
            if not (codes.shape == (n_prompt_codes(pid),) and codes.dtype == np.int32
                    and ((codes >= 0) & (codes < 65536)).all()):
                raise AssertionError(f"request {name}: bad codes {codes.shape} {codes.dtype}")
            enc = (f"encode {1e3 * res.encoding_time:.2f} ms for {sec:.0f} s of prompt "
                   f"({1e3 * res.encoding_time / sec:.2f} ms per s, {n_codes} codes, "
                   f"{len(np.unique(codes))} distinct), ")
        s = prompt_length(tok, normalization.create(), n_codes, transcript, desc, instruct)
        audio_s = wav.shape[1] / 16000
        log(f"  request {name}: {enc}prompt {s} tokens, prefill "
            f"{1e3 * res.prefill_time:.2f} ms, decode "
            f"{1e3 * res.decode_time / max(res.decode_steps, 1):.3f} ms/step x "
            f"{res.decode_steps} steps ({res.decode_steps / res.decode_time:.1f} "
            f"tok/s), codec decode {1e3 * res.decoding_time:.2f} ms, "
            f"{audio_s:.2f} s of audio, real-time factor "
            f"{res.inference_time / max(audio_s, 1e-9):.4f}")
    if s <= 1024:
        raise AssertionError(f"request c prefill has only {s} tokens")

    prompt = np.asarray([tok.encode("quantized cache check", add_special_tokens=True)],
                        dtype=np.int32)
    res = generate(params, cfg, prompt, [prompt.shape[1]],
                   torch.Generator(device="cuda").manual_seed(9), sp=SamplingParams(),
                   max_new_tokens=64, eos_id=-1, quantized_kv=True,
                   vocab_window=sv.generation_window(), device="cuda")
    prefills += 1
    steps += res.steps
    toks = res.tokens[0].cpu().numpy()
    lo, size = sv.generation_window()
    if not (res.steps == 64 and ((toks >= lo) & (toks < lo + size)).all()):
        raise AssertionError(f"int8-KV generate: {res.steps} steps, tokens {toks}")
    log(f"  generate quantized_kv=True: 64 steps, "
        f"{1e3 * res.decode_time / res.steps:.3f} ms/step")

    encoded = len({r[1] for r in REQUESTS if r[1] in PROMPT_SECONDS})
    want = _want(counters)
    want.update(flash_attention=cfg.n_layers * prefills,
                flash_decode_attention=cfg.n_layers * steps,
                activation1d_kernel=G_PER_ENCODE * encoded)
    got = _counts(counters)
    log(f"launch counts over the synthesis path: {got} (expected {want}: "
        f"{encoded} prompts encoded)")
    if got != want:
        raise AssertionError(f"launch counts {got} != expected {want}")
    _check_host_counts("synthesis", encodes_at_least=prefills)

    for pid, sec in PROMPT_SECONDS.items():
        split = encode_split(codec, prompt_wavs()[pid])
        if not np.array_equal(split.pop("codes"), codec.encoder.encode(pid, None)):
            raise AssertionError(f"{pid}: the staged encode gave other codes")
        log(f"  encode split, {sec:.0f} s prompt (a second encode, stage by stage, device "
            "synchronized): " + ", ".join(f"{k} {v:.2f} ms ({v / sec:.2f} ms per s)"
                                          for k, v in split.items()))
    return model, params, cfg, codec, got


# --- the serving engines at full width -----------------------------------------

ENGINE_TEXTS = [
    TEXT,
    "Please leave your message after the tone, and we will call you back.",
    "Tomorrow will be sunny in the morning, with light rain by the evening.",
    "Turn left at the second light, then keep going for about a mile.",
]
DESCRIPTIONS = ["a calm narrator with a low voice", "a bright young voice, speaking quickly",
                "an older man with a warm, slow voice", "a clear newsreader voice"]


def engine_prompt(tok, normalizer, encoder, kind: str, i: int):
    """(prompt ids, prompt codes): a voice description with line ``i``, or
    take ``i`` of ``TEXT`` on the 5 s or 22 s voice prompt, its codes from
    the main path's encoder cache (the takes of one voice share their whole
    prompt)."""
    from tts_max_tpu_torch.core import prompting

    if kind == "desc":
        transcript, desc, instruct, codes = "", DESCRIPTIONS[i], False, []
        text = ENGINE_TEXTS[i]
    else:
        transcript = {"p5s": REQUESTS[1][2], "p22s": REQUESTS[2][2]}[kind]
        desc, instruct, text = "", True, TEXT
        codes = encoder.encode(kind, prompt_wavs()[kind]).tolist()
    prompt = prompting.compile_inference_prompt(transcript, normalizer.normalize(text),
                                                codes, desc, instruct)
    return (np.asarray(tok.encode(prompt, add_special_tokens=True), np.int32),
            np.asarray(codes, np.int64))


@contextlib.contextmanager
def flag_syncs():
    """Yields a list that gets the Python stack of every host sync
    ``torch.cuda.set_sync_debug_mode("warn")`` flags inside the block."""
    syncs = []

    def on_warning(message, *args, **kw):
        if "synchroniz" in str(message):
            syncs.append([f for f in traceback.extract_stack()[:-1]
                          if not f.filename.endswith("warnings.py")])

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield syncs
        finally:
            torch.cuda.set_sync_debug_mode("default")
            # the first switch into "warn" in a process flags itself
            syncs[:] = [st for st in syncs if st[-1].name != "set_sync_debug_mode"]


def _sync_sites(syncs) -> collections.Counter:
    """The innermost four frames of each flagged sync, counted."""
    return collections.Counter(
        " < ".join(f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
                   for f in reversed(stack[-4:])) for stack in syncs)


def drive_engine(label, eng, reqs, decoder, sv, counters, decode_kernel: str,
                 cancel: int | None = None, report: dict | None = None) -> dict:
    """Warm ``eng`` up, set the counters to 0, submit ``reqs`` (dicts: ids,
    codes, budget, seed, optional sampling and min_tokens) at once, drive it
    with ``run_iter`` (cancelling request ``cancel`` after the first poll)
    with every host sync torch can see flagged, read the counters, check
    them against the engine's own counts (group prefills and park groups
    run kernel A), that the run made no host sync besides each dispatch's
    blob wait and each park read (which the debug mode does not flag), and
    every completion, and vocode each. Returns the launch counts; fills
    ``report`` with each request's tokens, TTFTs, tokens/s, ms per lockstep
    step, the lockstep steps and the collectives of the run."""
    from tts_max_tpu_torch.parallel import collectives

    lo, size = sv.generation_window()
    buckets = tuple(sorted({-(-len(r["ids"]) // 64) * 64 for r in reqs}))
    eng.warmup(prompt_buckets=buckets)
    _zero(counters)
    collectives.reset_counts()
    t0 = time.perf_counter()
    rids = [eng.submit(r["ids"], r["budget"], sv.speech_end_id, sampling_seed=r["seed"],
                       sampling=r.get("sampling"), min_tokens=r.get("min_tokens", 0))
            for r in reqs]
    done, t_first, cancelled = {}, None, None
    with flag_syncs() as syncs:
        for batch in eng.run_iter():
            if t_first is None:
                t_first = time.perf_counter()
                if cancel is not None:
                    cancelled = rids[cancel]
                    if eng.cancel(cancelled) is not True:
                        raise AssertionError(f"{label}: cancel returned False")
            done.update((c.request_id, c) for c in batch)
            blocks = getattr(eng, "_slot_blocks", [])
            if any(0 in row for row in blocks):
                raise AssertionError(f"{label}: the sink block was allocated")
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    got = _counts(counters)

    stats = eng.stats()
    dispatches = sum(stats["dispatches_per_stage"].values())
    steps = dispatches * eng.steps_per_dispatch
    n_layers = eng.cfg.n_layers
    want = _want(counters)
    want["flash_attention"] = n_layers * (eng._prefill_groups + eng._park_groups)
    want[decode_kernel] = n_layers * steps
    log(f"  {label}: launch counts {got} (expected {want}: {eng._prefill_groups} group "
        f"prefills, {eng._park_groups} park groups, {eng._suffix_admissions} suffix "
        f"admissions, {dispatches} dispatches x K={eng.steps_per_dispatch})")
    if got != want:
        raise AssertionError(f"{label}: launch counts {got} != expected {want}")
    where = _sync_sites(syncs)
    log(f"  {label}: host syncs flagged by torch.cuda.set_sync_debug_mode inside the run: "
        f"{len(syncs)}; one blob event wait per dispatch ({dispatches})")
    if syncs:
        raise AssertionError(f"{label}: host syncs besides the blob waits: {dict(where)}")

    gen_tokens, audio_s, ttft, tokens = 0, 0.0, [], []
    t_voc = time.perf_counter()
    for r, rid in zip(reqs, rids):
        if rid == cancelled:
            if rid in done:
                raise AssertionError(f"{label}: the cancelled request completed")
            continue
        c = done.get(rid)
        if c is None or c.finish_reason not in ("eos", "length"):
            raise AssertionError(f"{label}: request {rid} did not complete: {c}")
        toks = np.asarray(c.tokens)
        if not (len(toks) == r["budget"] or toks[-1] == sv.speech_end_id):
            raise AssertionError(f"{label}: request {rid} ended early: {len(toks)} tokens")
        tokens.append(toks)
        if not ((toks >= lo) & (toks < lo + size)).all():
            raise AssertionError(f"{label}: request {rid} left the window: {toks}")
        gen = sv.codes_from_tokens(toks)
        wav = decoder.decode(np.concatenate([r["codes"], gen]))
        if not (wav.ndim == 2 and wav.shape[1] % 320 == 0 and np.isfinite(wav).all()):
            raise AssertionError(f"{label}: request {rid} bad wav {wav.shape}")
        gen_tokens += len(toks)
        audio_s += len(gen) / 50
        ttft.append(c.first_token_time - t0)
    voc_s = time.perf_counter() - t_voc
    wall = t_end - t0
    hits = (f", prefix hits {stats['prefix_cache_hits']} misses "
            f"{stats['prefix_cache_misses']}" if "prefix_cache_hits" in stats else "")
    if eng.prefill_ahead:
        hits += (f", {stats['parked_total']} requests parked in {eng._park_groups} park "
                 f"groups")
    log(f"  {label}: wall {wall:.3f} s, {gen_tokens} tokens, {gen_tokens / wall:.1f} tok/s, "
        f"{1e3 * wall / steps:.2f} ms per lockstep step over the run and "
        f"{1e3 * (t_end - t_first) / max(steps - eng.steps_per_dispatch, 1):.2f} after the "
        f"first poll ({steps} steps), {dispatches} dispatches, {eng._prefill_groups} "
        f"prefill groups, TTFT p50 {1e3 * np.percentile(ttft, 50):.1f} ms p95 "
        f"{1e3 * np.percentile(ttft, 95):.1f} ms (host clock){hits}; {audio_s:.2f} s of "
        f"audio, {wall / audio_s:.4f} s of wall per s of audio; vocoded "
        f"{len(ttft)} wavs in {voc_s:.2f} s")
    if report is not None:
        report.update(tokens=tokens, ttft=ttft, tok_s=gen_tokens / wall,
                      ms_step=1e3 * wall / steps, steps=steps,
                      collectives={**collectives.counts(), **collectives.counts_tp()})
    return got


def run_engines(tok, sv, params, cfg, encoder, decoder, counters) -> dict:
    """e1-e6 at full width; returns the launch counts summed over them.
    Each request's prompt is tokenized when its request is made, as a
    server does (the native encodes must cover every request)."""
    from tts_max_tpu_torch import native
    from tts_max_tpu_torch.data import normalization
    from tts_max_tpu_torch.inference.engine import InferenceEngine, PagedInferenceEngine
    from tts_max_tpu_torch.ops.sampling import SamplingParams

    normalizer = normalization.create()
    native.reset_counts()
    n_requests = 0

    def reqs(order, budgets):
        nonlocal n_requests
        n_requests += len(order)
        return [dict(zip(("ids", "codes"), engine_prompt(tok, normalizer, encoder, *key)),
                     budget=n, seed=100 + j)
                for j, (key, n) in enumerate(zip(order, budgets))]

    window = sv.generation_window()
    common = dict(max_batch=8, max_len=2048, vocab_window=window, steps_per_dispatch=16,
                  device="cuda")
    totals: dict = {}

    def add(got):
        for k, v in got.items():
            totals[k] = totals.get(k, 0) + v

    log("serving engines: Llama-3.2-1B + Vocos, max_batch 8, max_len 2048, K=16, "
        f"window {window}, default SamplingParams unless noted")
    # e1: paged, bf16, prefix cache, the default entry point (D); the takes
    # 1-3 of each voice are admitted after the first group, as suffix hits
    order = [("p5s", 0), ("p22s", 0), ("desc", 0), ("desc", 1), ("desc", 2), ("desc", 3),
             ("p5s", 1), ("p22s", 1), ("p5s", 2), ("p22s", 2), ("p5s", 3), ("p22s", 3)]
    e1 = reqs(order, [256, 224, 192, 208, 240, 256, 192, 232, 200, 256, 216, 248])
    e1[2]["sampling"] = SamplingParams(temperature=0.0)
    e1[3]["sampling"] = SamplingParams(top_p=0.9)
    e1[4]["min_tokens"] = 32
    eng = PagedInferenceEngine(params, cfg, block_size=64, enable_prefix_cache=True, **common)
    os.environ.pop("TTS_MAX_PAGED_ATTN", None)
    add(drive_engine("e1 paged bf16 dense, prefix cache, 12 requests", eng, e1, decoder, sv,
                     counters, "paged_decode_attention_dense", cancel=5))
    if eng.prefix_cache_hits == 0:
        raise AssertionError("e1: no prefix-cache hit")
    del eng
    # e2: paged, int8 KV, the dma entry point (E)
    order = [("desc", 0), ("p5s", 0), ("desc", 1), ("p22s", 0), ("desc", 2), ("p5s", 1)]
    os.environ["TTS_MAX_PAGED_ATTN"] = "dma"
    try:
        eng = PagedInferenceEngine(params, cfg, block_size=64, quantized_kv=True, **common)
        add(drive_engine("e2 paged int8 dma, 6 requests", eng, reqs(order, [128] * 6),
                         decoder, sv, counters, "paged_decode_attention_dma"))
        del eng
        # e4: paged, bf16, the grid entry point (F)
        os.environ["TTS_MAX_PAGED_ATTN"] = "grid"
        order = [("desc", 1), ("p5s", 2), ("desc", 3), ("p22s", 2)]
        eng = PagedInferenceEngine(params, cfg, block_size=64, **common)
        add(drive_engine("e4 paged bf16 grid, 4 requests", eng, reqs(order, [64] * 4),
                         decoder, sv, counters, "paged_decode_attention"))
        del eng
    finally:
        os.environ.pop("TTS_MAX_PAGED_ATTN", None)
    # e3: contiguous (the CLI default engine), kernel C at B = 8
    order = [("desc", 0), ("desc", 1), ("desc", 2), ("desc", 3), ("p5s", 0), ("p5s", 1),
             ("p22s", 0), ("p22s", 1)]
    eng = InferenceEngine(params, cfg, **common)
    add(drive_engine("e3 contiguous bf16, 8 requests", eng, reqs(order, [256] * 8), decoder,
                     sv, counters, "ragged_decode_attention"))
    del eng

    # e5: contiguous with prefill-ahead (K = 32, the CLIs' auto value with it;
    # park_len 512, 8 park rows): 16 requests that park while the pool is full
    # (the voice descriptions and 5 s takes, each twice with other seeds) and
    # two 22 s takes longer than park_len, which queue; beside it the same
    # requests without prefill-ahead
    parked_kw = dict(common, steps_per_dispatch=32)
    order = [("desc", i) for i in range(4)] + [("p5s", i) for i in range(4)]
    runs = {}
    for ahead in (True, False):
        e5 = reqs(order + order + [("p22s", 0), ("p22s", 1)], [128] * 18)
        eng = InferenceEngine(params, cfg, prefill_ahead=ahead, **parked_kw)
        runs[ahead] = {}
        add(drive_engine(f"e5 contiguous bf16, prefill_ahead={ahead}, 18 requests", eng, e5,
                         decoder, sv, counters, "ragged_decode_attention",
                         report=runs[ahead]))
        if ahead:
            _check_parked("e5", eng)
        del eng
    same = sum(np.array_equal(a, b) for a, b in zip(runs[True]["tokens"], runs[False]["tokens"]))
    log("  e5 with / without prefill-ahead: TTFT p50 "
        + " / ".join(f"{1e3 * np.percentile(runs[a]['ttft'], 50):.1f}" for a in (True, False))
        + " ms, p95 "
        + " / ".join(f"{1e3 * np.percentile(runs[a]['ttft'], 95):.1f}" for a in (True, False))
        + " ms, " + " / ".join(f"{runs[a]['tok_s']:.1f}" for a in (True, False))
        + " tok/s, " + " / ".join(f"{runs[a]['ms_step']:.2f}" for a in (True, False))
        + f" ms per lockstep step; {same} of {len(e5)} requests give the same tokens "
        "(not asserted: in bf16 a park group's prefill and a queued group's may differ "
        "in rows and bucket, and so in rounding)")
    # requests 8-15 wait for a slot: they park with prefill-ahead
    log("  e5 TTFT of requests 8-15 (parked with prefill-ahead) with / without it: "
        + ", ".join(f"{name} " + " / ".join(
            f"{1e3 * fn(runs[a]['ttft'][8:16]):.1f}" for a in (True, False)) + " ms"
            for name, fn in (("min", np.min), ("median", np.median), ("max", np.max))))

    # e6: paged with prefill-ahead and the prefix cache, entry D, 4 slots,
    # 64 tokens each: two voice descriptions park while the first four run,
    # and the second takes on the 5 s and 22 s prompts, prefix-cache hits,
    # take the queued suffix path
    order = [("p5s", 0), ("desc", 0), ("desc", 1), ("p22s", 0), ("desc", 2), ("desc", 3),
             ("p5s", 1), ("p22s", 1)]
    eng = PagedInferenceEngine(params, cfg, block_size=64, enable_prefix_cache=True,
                               prefill_ahead=True, **dict(parked_kw, max_batch=4))
    add(drive_engine("e6 paged bf16 dense, prefix cache, prefill_ahead, 8 requests", eng,
                     reqs(order, [64] * 8), decoder, sv, counters,
                     "paged_decode_attention_dense"))
    _check_parked("e6", eng)
    if not (eng._suffix_admissions >= 1 and eng.prefix_cache_hits > 0):
        raise AssertionError(f"e6: {eng._suffix_admissions} suffix admissions, "
                             f"{eng.prefix_cache_hits} prefix hits")
    free = len(eng._free_blocks) + len(eng._evictable)
    if free != eng.num_blocks - 1:
        raise AssertionError(f"e6: {free} free + evictable blocks of {eng.num_blocks - 1}")
    log(f"  e6: {eng._suffix_admissions} suffix admissions, blocks balanced ({free} free + "
        f"evictable of {eng.num_blocks - 1})")
    _check_host_counts("engines", encodes_at_least=n_requests)
    return totals


def run_tp_serving(tok, sv, params, cfg, encoder, decoder, counters) -> dict:
    """e-tp and TP generate: the serving engines and ``generate`` with
    ``mesh=`` a ``(1, 1, 1)`` tensor-parallel mesh in an NCCL group of world
    size 1, on the rank's blocks of the main path's weights (one block a
    leaf), each beside the same engine or generate without a mesh in this
    process: greedy ids identical, kernel launches and collectives at their
    formulas (each forward sums the embedding and each layer's two
    row-parallel products, 1 + 2 L, over a group of one; the vocab window's
    head is built whole once, at construction, so no step gathers logits).
    e-tp1 contiguous bf16 (kernel C), e-tp2 contiguous int8 KV (kernel B),
    e-tp3 paged (kernel D); 8 requests, 64 new tokens, K = 16. Returns the
    launch counts."""
    from tts_max_tpu_torch.data import normalization
    from tts_max_tpu_torch.inference.engine import InferenceEngine, PagedInferenceEngine
    from tts_max_tpu_torch.inference.generate import generate
    from tts_max_tpu_torch.ops.sampling import SamplingParams
    from tts_max_tpu_torch.parallel import collectives, mesh as pmesh
    from tts_max_tpu_torch.parallel.sharding import ShardLayout

    L = cfg.n_layers
    greedy = SamplingParams(temperature=0.0)
    normalizer = normalization.create()
    order = [("desc", 0), ("desc", 1), ("desc", 2), ("desc", 3), ("p5s", 0), ("p5s", 1),
             ("p22s", 0), ("p22s", 1)]
    prompts = [engine_prompt(tok, normalizer, encoder, kind, i) for kind, i in order]
    reqs = [dict(ids=ids, codes=codes, budget=64, seed=300 + j, sampling=greedy)
            for j, (ids, codes) in enumerate(prompts)]
    window = sv.generation_window()
    common = dict(max_batch=8, max_len=2048, vocab_window=window, steps_per_dispatch=16,
                  device="cuda")
    variants = [("e-tp1 contiguous bf16", InferenceEngine, {}, "ragged_decode_attention"),
                ("e-tp2 contiguous int8 KV", InferenceEngine, {"quantized_kv": True},
                 "flash_decode_attention"),
                ("e-tp3 paged bf16", PagedInferenceEngine, {"block_size": 64},
                 "paged_decode_attention_dense")]
    totals: dict = {}

    def add(got):
        for k, v in got.items():
            totals[k] = totals.get(k, 0) + v

    log("e-tp: the engines with mesh= a (1, 1, 1) tensor-parallel mesh (NCCL, world size "
        "1) beside the same engines without one; Llama-3.2-1B, greedy, 8 requests x 64 "
        f"tokens, max_batch 8, K=16, window {window}")
    with nccl_world_of_one():
        env = pmesh.initialize_distributed("cuda")
        try:
            mesh = pmesh.build_mesh((1, 1, 1), "tp")
            local = ShardLayout(params, mesh).shard(params)
            for label, cls, kw, kernel in variants:
                runs = {}
                for m, p in ((None, params), (mesh, local)):
                    eng = cls(p, cfg, mesh=m, **kw, **common)
                    runs[m is not None] = report = {}
                    name = label + (" with mesh" if m is not None else " without a mesh")
                    add(drive_engine(name, eng, reqs, decoder, sv, counters, kernel,
                                     report=report))
                    calls = report["collectives"]
                    units = (eng._prefill_groups + eng._park_groups + eng._suffix_admissions
                             + report["steps"])
                    want = dict.fromkeys(calls, 0)
                    if m is not None:
                        want["tensor_exit"] = (1 + 2 * L) * units
                    _check_collectives(name, calls, want)
                    del eng
                same = [np.array_equal(a, b) for a, b in zip(runs[True]["tokens"],
                                                             runs[False]["tokens"])]
                if not all(same):
                    raise AssertionError(f"{label}: ids with the mesh differ from the ids "
                                         f"without it in requests "
                                         f"{[i for i, x in enumerate(same) if not x]}")
                log(f"  {label}: ids identical with and without the mesh ({len(same)} "
                    f"requests); tok/s {runs[True]['tok_s']:.1f} with the mesh, "
                    f"{runs[False]['tok_s']:.1f} without; ms per lockstep step "
                    f"{runs[True]['ms_step']:.2f} / {runs[False]['ms_step']:.2f}; "
                    f"{gpu_line()}")

            # TP generate: the first four prompts, right-padded, 64 tokens
            ids = [p for p, _ in prompts[:4]]
            s = max(len(x) for x in ids)
            tokens = np.zeros((4, s), np.int32)
            for i, x in enumerate(ids):
                tokens[i, :len(x)] = x
            lengths = np.asarray([len(x) for x in ids], np.int32)
            out = {}
            for m, p in ((None, params), (mesh, local)):
                _zero(counters)
                collectives.reset_counts()
                res = generate(p, cfg, tokens, lengths, None, sp=greedy, max_new_tokens=64,
                               eos_id=sv.speech_end_id, vocab_window=window, device="cuda",
                               mesh=m)
                got = _counts(counters)
                add(got)
                _check_counts(f"TP generate {'with' if m else 'without'} a mesh", got,
                              _want(counters, flash_attention=L,
                                    flash_decode_attention=L * res.steps))
                calls = {**collectives.counts(), **collectives.counts_tp()}
                want = dict.fromkeys(calls, 0)
                if m is not None:
                    # the window head's sum, then each forward's
                    want["tensor_exit"] = 1 + (1 + 2 * L) * (1 + res.steps)
                _check_collectives("TP generate", calls, want)
                out[m is not None] = res
            if not torch.equal(out[True].tokens, out[False].tokens):
                raise AssertionError("TP generate: ids with the mesh differ from generate's")
            log(f"  TP generate: 4 prompts x 64 tokens, ids identical with and without the "
                f"mesh ({out[True].steps} steps); decode {out[True].decode_time:.3f} s with "
                f"the mesh, {out[False].decode_time:.3f} s without")
        finally:
            pmesh.destroy_distributed(env)
    return totals


def _check_parked(label, eng) -> None:
    """Prefill-ahead ran and left nothing behind: requests parked, every park
    row free again (every attached slot's first decode step re-derived its
    preview, or the engine would have raised)."""
    st = eng.stats()
    if not (st["parked_total"] > 0 and st["parked_requests"] == 0
            and st["free_park_rows"] == st["park_rows"] and eng._park_groups > 0):
        raise AssertionError(f"{label}: prefill-ahead stats {st}, {eng._park_groups} park groups")


# --- speculative decoding at full width -----------------------------------------


def run_speculative(tok, sv, params, cfg, encoder, counters, sp3) -> dict:
    """sp1: fp32 Llama-3.2-1B as both draft and target (TF32 off), batch 2 on
    request (b)'s prompt, 64 tokens, gamma 4, greedy: the ids of fp32 greedy
    ``generate``, every candidate accepted. sp2: bf16, a 2-layer draft of the
    1B widths (seed 1) for the 1B target, batch 4 (the voice descriptions),
    128 tokens, gamma 4, temperature 0.9, top-k 50, beside plain ``generate``
    at the same batch and budget, and logged beside ``sp3`` (``run_sp3``'s
    numbers for the distilled draft). Returns the launch counts of both."""
    import dataclasses

    from tts_max_tpu_torch.data import normalization
    from tts_max_tpu_torch.inference.generate import generate
    from tts_max_tpu_torch.inference.speculative import speculative_generate
    from tts_max_tpu_torch.models import llama
    from tts_max_tpu_torch.ops.sampling import SamplingParams

    window = sv.generation_window()
    lo, size = window
    gamma, n_layers = 4, cfg.n_layers
    normalizer = normalization.create()
    totals = _want(counters)

    def count(want, label):
        got = _counts(counters)
        _check_counts(label, got, _want(counters, **want))
        for k, v in got.items():
            totals[k] += v
        _zero(counters)

    # sp1
    ids = engine_prompt(tok, normalizer, encoder, "p5s", 0)[0]
    prompt = np.stack([ids, ids])
    lens = [len(ids)] * 2
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = llama._map(lambda t: t.float() if t.is_floating_point() else t, params)
    greedy = SamplingParams(temperature=0.0)
    _zero(counters)
    res = speculative_generate(params32, cfg32, params32, cfg32, prompt, lens, None, sp=greedy,
                               max_new_tokens=64, eos_id=-1, gamma=gamma, vocab_window=window)
    count({"flash_attention": 2 * n_layers,
           "flash_decode_attention": n_layers * (gamma + 1) * res.steps}, "sp1 speculative")
    ref = generate(params32, cfg32, prompt, lens, None, sp=greedy, max_new_tokens=64,
                   eos_id=-1, vocab_window=window)
    count({"flash_attention": n_layers, "flash_decode_attention": n_layers * ref.steps},
          "sp1 generate")
    same = torch.equal(res.tokens, ref.tokens)
    log(f"  sp1 fp32 draft = target, batch 2, {len(ids)}-token prompt, 64 tokens, gamma "
        f"{gamma}, greedy: {res.steps} rounds (want {-(-63 // (gamma + 1))}), ids equal to "
        f"generate's: {same}; {1e3 * res.decode_time / res.steps:.2f} ms per round, "
        f"generate {1e3 * ref.decode_time / ref.steps:.2f} ms per step")
    if not (same and res.steps == -(-63 // (gamma + 1))):
        raise AssertionError(f"sp1: {res.steps} rounds; ids {res.tokens.tolist()} vs generate "
                             f"{ref.tokens.tolist()}")
    del params32, res, ref

    # sp2
    draft_cfg = llama.llama32_1b_config(n_layers=2)
    draft = llama.init_params(draft_cfg, seed=1, device="cuda")
    rows = [engine_prompt(tok, normalizer, encoder, "desc", i)[0] for i in range(4)]
    lens = [len(r) for r in rows]
    prompt = np.zeros((4, max(lens)), np.int32)
    for i, r in enumerate(rows):
        prompt[i, :len(r)] = r
    sp = SamplingParams(temperature=0.9, top_k=50)
    finite = []
    decode_window = llama.decode_window

    def checked(*args, **kw):  # every verify pass's logits, read after the run
        logits, cache = decode_window(*args, **kw)
        finite.append(torch.isfinite(logits).all())
        return logits, cache

    llama.decode_window = checked
    try:
        res = speculative_generate(params, cfg, draft, draft_cfg, prompt, lens,
                                   torch.Generator(device="cuda").manual_seed(7), sp=sp,
                                   max_new_tokens=128, eos_id=sv.speech_end_id, gamma=gamma,
                                   vocab_window=window)
    finally:
        llama.decode_window = decode_window
    count({"flash_attention": n_layers + draft_cfg.n_layers,
           "flash_decode_attention": draft_cfg.n_layers * (gamma + 1) * res.steps},
          "sp2 speculative")
    ref = generate(params, cfg, prompt, lens, torch.Generator(device="cuda").manual_seed(7),
                   sp=sp, max_new_tokens=128, eos_id=sv.speech_end_id, vocab_window=window)
    count({"flash_attention": n_layers, "flash_decode_attention": n_layers * ref.steps},
          "sp2 generate")
    toks, n_gen = res.tokens.cpu().numpy(), res.num_generated.cpu().numpy()
    for row, n in zip(toks, n_gen):
        if not (((row[:n] >= lo) & (row[:n] < lo + size)).all()
                and (n == 128 or row[n - 1] == sv.speech_end_id)):
            raise AssertionError(f"sp2: a row of {n} tokens: {row[:n]}")
    if not (len(finite) == res.steps and bool(torch.stack(finite).all())):
        raise AssertionError(f"sp2: non-finite verify logits in {len(finite)} rounds")
    per_round = float(np.mean((n_gen - 1) / res.steps))
    log(f"  sp2 bf16, 2-layer draft, batch 4, 128 tokens, gamma {gamma}, temperature 0.9, "
        f"top-k 50: {res.steps} rounds, {per_round:.3f} tokens per round a row, "
        f"{int(n_gen.sum()) / res.decode_time:.1f} tok/s ({1e3 * res.decode_time:.1f} ms); "
        f"generate: {ref.steps} steps, "
        f"{int(ref.num_generated.sum()) / ref.decode_time:.1f} tok/s "
        f"({1e3 * ref.decode_time:.1f} ms); verify logits finite in every round")
    log(f"  sp3 beside sp2 (same batch and budget): distilled {D1_LAYERS}-layer draft "
        f"{sp3['per_round']:.3f} tokens per round a row, {sp3['tok_s']:.1f} tok/s; "
        f"random 2-layer draft {per_round:.3f}, "
        f"{int(n_gen.sum()) / res.decode_time:.1f} tok/s; generate "
        f"{int(ref.num_generated.sum()) / ref.decode_time:.1f} tok/s")
    return totals


# --- the serving entry points at full width ------------------------------------

SERVING_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
BATCH_BUDGETS = [128, 256, 160, 224, 192, 256, 144, 208]


def _zero(counters) -> None:
    for c in counters:
        c.launches = 0


def _counts(counters) -> dict:
    return {c.__name__: c.launches for c in counters}


def _want(counters, **kw) -> dict:
    """Every counter at 0 but those named in ``kw``."""
    return {**{c.__name__: 0 for c in counters}, **kw}


def _check_counts(label, got, want) -> None:
    log(f"  {label}: launch counts {got} (expected {want})")
    if got != want:
        raise AssertionError(f"{label}: launch counts {got} != expected {want}")


def _check_wav_file(label, path) -> int:
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if not (sr == 16000 and data.dtype == np.int16 and data.ndim == 1
            and len(data) % 320 == 0 and len(data) > 0):
        raise AssertionError(f"{label}: {path} is {sr} Hz {data.dtype} {data.shape}")
    return len(data)


def run_serving(tok, sv, params, cfg, counters) -> dict:
    """The three serving CLIs of the port, in this process, on an HF
    directory of Llama-3.2-1B geometry written by the port's writer (the
    main path's seed-0 weights, stored in BF16 as a real HF checkpoint
    stores them, and an HF config.json); the codec in smoke mode, as the
    CLIs run without codec checkpoints (s1-s3). Then weight-only quantized
    serving: ``serve_batch --quantize int4-g128`` on the same dir (s4) and
    ``serving_inference`` on a pre-quantized int8 dir of the same weights,
    written by the port's ``save_quantized_dir`` (s5). Returns the launch
    counts summed over the five."""
    import http.client
    import shutil
    import threading
    from http.server import ThreadingHTTPServer

    from tts_max_tpu_torch.data.audio_io import save_wav
    from tts_max_tpu_torch.models import hf_import, quantization
    from tts_max_tpu_torch.tools import serve_batch, serve_http, serving_inference

    shutil.rmtree(SERVING_DIR, ignore_errors=True)
    model_dir = os.path.join(SERVING_DIR, "model")
    t0 = time.perf_counter()
    hf_import.save_model_to_hf_dir(params, cfg, model_dir, eos_token_id=sv.speech_end_id,
                                   dtype=torch.bfloat16)
    size = sum(os.path.getsize(os.path.join(model_dir, f)) for f in os.listdir(model_dir))
    log(f"serving: wrote {model_dir} (Llama-3.2-1B geometry, BF16, {size / 2 ** 30:.2f} GiB) "
        f"in {time.perf_counter() - t0:.2f} s")
    wavs = {}
    for pid in PROMPT_SECONDS:
        wavs[pid] = os.path.join(SERVING_DIR, f"{pid}.wav")
        save_wav(wavs[pid], prompt_wavs()[pid], 16000)
    n_layers, totals = cfg.n_layers, {}

    def add(got):
        for k, v in got.items():
            totals[k] = totals.get(k, 0) + v

    # 1. single shot: one request on the 5 s prompt wav, 128 tokens
    _zero(counters)
    out = os.path.join(SERVING_DIR, "single.wav")
    rep = serving_inference.main([
        "--model_dir", model_dir, "--text", TEXT, "--output", out,
        "--prompt_wav", wavs["p5s"], "--prompt_transcript", REQUESTS[1][2],
        "--max_tokens", "128"])
    res = rep["result"]
    got = _counts(counters)
    want = _want(counters)
    want.update(flash_attention=n_layers, flash_decode_attention=n_layers * res.decode_steps,
                activation1d_kernel=G_PER_ENCODE)
    _check_counts("serving_inference", got, want)
    n = _check_wav_file("serving_inference", out)
    if not (np.isfinite(res.wav).all() and res.wav.shape == (1, n)):
        raise AssertionError(f"serving_inference: wav {res.wav.shape}, file {n} samples")
    log(f"  serving_inference: load {rep['load_s']:.2f} s, prompt encode "
        f"{1e3 * res.encoding_time:.2f} ms, prefill {1e3 * res.prefill_time:.2f} ms, "
        f"{res.decode_steps} steps "
        f"({res.decode_steps / res.decode_time:.1f} tok/s, "
        f"{1e3 * res.decode_time / res.decode_steps:.3f} ms/step), {n / 16000:.2f} s of audio")
    add(got)

    # 2. batch: 8 JSONL requests, voice descriptions and both prompt wavs
    reqs_path = os.path.join(SERVING_DIR, "requests.jsonl")
    with open(reqs_path, "w") as f:
        for i, budget in enumerate(BATCH_BUDGETS):
            if i % 2 == 0:
                req = dict(text=ENGINE_TEXTS[i // 2], voice_description=DESCRIPTIONS[i // 2])
            else:
                pid = "p5s" if i % 4 == 1 else "p22s"
                req = dict(text=TEXT, prompt_wav=wavs[pid],
                           prompt_transcript={"p5s": REQUESTS[1][2], "p22s": REQUESTS[2][2]}[pid])
            f.write(json.dumps(dict(req, max_tokens=budget)) + "\n")
    _zero(counters)
    rep = serve_batch.main(["--model_dir", model_dir, "--requests", reqs_path,
                            "--out_dir", os.path.join(SERVING_DIR, "batch"),
                            "--max_batch", "8", "--max_len", "2048", "--max_tokens", "256"])
    got = _counts(counters)
    eng = rep["engine"]
    steps = sum(eng.stats()["dispatches_per_stage"].values()) * eng.steps_per_dispatch
    warm_buckets = 2  # warmup(): one prefill per prompt bucket (64, 256), one decode step
    want = _want(counters)
    want.update(flash_attention=n_layers * (eng._prefill_groups + warm_buckets),
                ragged_decode_attention=n_layers * (steps + 1),
                activation1d_kernel=G_PER_ENCODE * len(PROMPT_SECONDS))
    _check_counts(f"serve_batch ({eng._prefill_groups} prefill groups, {steps} lockstep "
                  f"steps + 1 warmup step, K={eng.steps_per_dispatch})", got, want)
    if sorted(rep["outputs"]) != list(range(len(BATCH_BUDGETS))):
        raise AssertionError(f"serve_batch: wavs for requests {sorted(rep['outputs'])}")
    samples = sum(_check_wav_file("serve_batch", p) for p in rep["outputs"].values())
    tokens = sum(len(c.tokens) for c in rep["completions"])
    log(f"  serve_batch: load {rep['load_s']:.2f} s, {len(rep['completions'])} completions, "
        f"{tokens} tokens in {rep['gen_s']:.3f} s ({tokens / rep['gen_s']:.1f} tok/s, "
        f"{1e3 * rep['gen_s'] / steps:.2f} ms per lockstep step), TTFT "
        f"p50 {1e3 * np.percentile(rep['ttft_s'], 50):.1f} ms p95 "
        f"{1e3 * np.percentile(rep['ttft_s'], 95):.1f} ms (host clock), "
        f"{samples / 16000:.2f} s of audio in {len(rep['outputs'])} wavs")
    add(got)
    del rep, eng

    # 3. HTTP: a TtsServer on an ephemeral port; one request whole, the same
    # request (same seed) streamed, then /stats
    _zero(counters)
    t0 = time.perf_counter()
    server = serve_http.build_server(serve_http.parse_args(
        ["--model_dir", model_dir, "--max_batch", "8", "--max_len", "2048",
         "--max_tokens", "128"]))
    t_build = time.perf_counter() - t0
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve_http.make_handler(server))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_address[1]
    body = json.dumps({"text": TEXT, "prompt_wav": wavs["p22s"], "seed": 11,
                       "prompt_transcript": REQUESTS[2][2], "max_tokens": 128})

    def post(path):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        t_req = time.perf_counter()
        conn.request("POST", path, body=body)
        resp = conn.getresponse()
        data, t_audio = b"", None
        while chunk := resp.read1(1 << 16):
            data += chunk
            if t_audio is None and len(data) > 44:
                t_audio = time.perf_counter() - t_req
        conn.close()
        if resp.status != 200 or data[:4] != b"RIFF":
            raise AssertionError(f"serve_http {path}: {resp.status} {data[:200]!r}")
        return data, t_audio, time.perf_counter() - t_req

    try:
        whole, _, t_whole = post("/synthesize")
        streamed, t_first, t_stream = post("/stream")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        httpd.shutdown()
        server.shutdown()
        thread.join(timeout=10)
        httpd.server_close()
    got = _counts(counters)
    eng = server.engine
    steps = sum(eng.stats()["dispatches_per_stage"].values()) * eng.steps_per_dispatch
    want = _want(counters)
    want.update(flash_attention=n_layers * (eng._prefill_groups + warm_buckets),
                ragged_decode_attention=n_layers * (steps + 1),
                activation1d_kernel=G_PER_ENCODE)
    _check_counts(f"serve_http ({eng._prefill_groups} prefill groups, {steps} lockstep "
                  "steps + 1 warmup step)", got, want)
    n_whole = struct.unpack("<I", whole[40:44])[0]
    if not (n_whole == len(whole) - 44 and n_whole % 640 == 0 and n_whole > 0
            and len(streamed) - 44 == n_whole):
        raise AssertionError(f"serve_http: whole wav {n_whole} bytes of samples, streamed "
                             f"{len(streamed) - 44}")
    if not (stats["completed_requests"] == 2 and stats["active_slots"] == 0):
        raise AssertionError(f"serve_http: /stats {stats}")
    log(f"  serve_http: build_server (load, engine, warmup) {t_build:.2f} s, "
        f"POST /synthesize {t_whole:.3f} s, POST /stream first audio after "
        f"{t_first:.3f} s, done {t_stream:.3f} s; {n_whole // 2} samples both ways; "
        f"/stats {stats}")
    add(got)
    del server, eng

    # 4. batch, weight-only int4-g128: the same 8 requests, the BF16 dir
    # quantized at load
    _zero(counters)
    rep = serve_batch.main(["--model_dir", model_dir, "--requests", reqs_path,
                            "--out_dir", os.path.join(SERVING_DIR, "batch_int4"),
                            "--max_batch", "8", "--max_len", "2048", "--max_tokens", "256",
                            "--quantize", "int4-g128"])
    got = _counts(counters)
    eng = rep["engine"]
    leaf = eng.params["layers"]["mlp"]["w_gate"]["kernel"]
    if not (quantization.is_grouped(leaf) and leaf["q4"].dtype == torch.uint8):
        raise AssertionError("serve_batch --quantize int4-g128: the layers are not int4-g128")
    steps = sum(eng.stats()["dispatches_per_stage"].values()) * eng.steps_per_dispatch
    groups = eng._prefill_groups + warm_buckets
    want = _want(counters)
    want.update(flash_attention=n_layers * groups,
                ragged_decode_attention=n_layers * (steps + 1),
                activation1d_kernel=G_PER_ENCODE * len(PROMPT_SECONDS),
                quant_matmul=(7 * n_layers + 1) * (steps + 1) + groups)
    _check_counts(f"serve_batch --quantize int4-g128 ({eng._prefill_groups} prefill groups, "
                  f"{steps} lockstep steps + 1 warmup step: {7 * n_layers + 1} quantized "
                  "products a step, 1 a group prefill's head)", got, want)
    samples = sum(_check_wav_file("serve_batch int4-g128", p) for p in rep["outputs"].values())
    tokens = sum(len(c.tokens) for c in rep["completions"])
    if len(rep["outputs"]) != len(BATCH_BUDGETS):
        raise AssertionError(f"serve_batch int4-g128: {len(rep['outputs'])} wavs")
    log(f"  serve_batch --quantize int4-g128: load and quantize {rep['load_s']:.2f} s, "
        f"{tokens} tokens in {rep['gen_s']:.3f} s ({tokens / rep['gen_s']:.1f} tok/s, "
        f"{1e3 * rep['gen_s'] / steps:.2f} ms per lockstep step), TTFT p50 "
        f"{1e3 * np.percentile(rep['ttft_s'], 50):.1f} ms, {samples / 16000:.2f} s of audio")
    add(got)
    del rep, eng, leaf

    # 5. single shot on a pre-quantized int8 dir the port's writer stores
    q_dir = os.path.join(SERVING_DIR, "model_int8")
    t0 = time.perf_counter()
    hf_import.save_quantized_dir(quantization.quantize_llama_params(params, bits=8), cfg,
                                 q_dir, bits=8)
    size = sum(os.path.getsize(os.path.join(q_dir, f)) for f in os.listdir(q_dir))
    log(f"serving: wrote {q_dir} (pre-quantized int8, {size / 2 ** 30:.2f} GiB) in "
        f"{time.perf_counter() - t0:.2f} s")
    _zero(counters)
    out = os.path.join(SERVING_DIR, "single_int8.wav")
    rep = serving_inference.main([
        "--model_dir", q_dir, "--text", TEXT, "--output", out,
        "--prompt_wav", wavs["p5s"], "--prompt_transcript", REQUESTS[1][2],
        "--max_tokens", "128"])
    res = rep["result"]
    got = _counts(counters)
    want = _want(counters)
    want.update(flash_attention=n_layers, flash_decode_attention=n_layers * res.decode_steps,
                activation1d_kernel=G_PER_ENCODE,
                quant_matmul=(7 * n_layers + 1) * res.decode_steps + 1)
    _check_counts("serving_inference, pre-quantized int8 dir", got, want)
    n = _check_wav_file("serving_inference int8", out)
    if not (np.isfinite(res.wav).all() and res.wav.shape == (1, n)):
        raise AssertionError(f"serving_inference int8: wav {res.wav.shape}, file {n} samples")
    log(f"  serving_inference int8 dir: load {rep['load_s']:.2f} s, prefill "
        f"{1e3 * res.prefill_time:.2f} ms, {res.decode_steps} steps "
        f"({res.decode_steps / res.decode_time:.1f} tok/s, "
        f"{1e3 * res.decode_time / res.decode_steps:.3f} ms/step), {n / 16000:.2f} s of audio")
    add(got)
    return totals


# --- the train-to-serve chain at full width (v1, c1, d1, sp3, l1, q1, qq) -------

CHAIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke_chain")
CHAIN_ARCH = "llama-3.2-1b"
D1_LAYERS, D1_BATCH, D1_SEQ, D1_STEPS = 4, 8, 512, 8
L1_BATCH, L1_SEQ = 2, 2048
QQ_MODES = ("int8", "int4-g128")


def _gib(path: str) -> float:
    """GiB of the files under ``path``."""
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path)
               for f in fs) / 2 ** 30


class _WavRecorder:
    """Wraps a module's ``save_wav`` to record, per path, whether the float
    wav it was given was finite (a 16-bit file cannot show a NaN)."""

    def __init__(self, module):
        self.module, self.save, self.finite = module, module.save_wav, {}

    def __enter__(self):
        def save(path, wav, sample_rate):
            self.finite[path] = bool(np.isfinite(wav).all())
            self.save(path, wav, sample_rate)

        self.module.save_wav = save
        return self

    def __exit__(self, *exc):
        self.module.save_wav = self.save


def run_vectorize(counters) -> tuple[str, dict]:
    """v1: ``example/make_synthetic_samples.py`` writes V1_SAMPLES samples of
    0.5-3 s; ``tools.data_vectorizer`` encodes them with the full-width
    seeded encoder (all-zero semantics, no ``--tiny``) at batch 8 on the
    card, each batch one acoustic encode (36 launches of kernel G, at the
    shapes ``check_kernel_g`` held against its plain version: checked
    here); ``tools.data_merger`` merges the shard. The merged files must load
    through ``codes_io`` with every sample and its own code count. Logs each
    batch's encode seconds and the rate over the train batches after the
    first. Returns the dataset dir and the launch counts."""
    from tts_max_tpu_torch.data import codes_io
    from tts_max_tpu_torch.models.codec import api, filters
    from tts_max_tpu_torch.tools import data_merger, data_vectorizer

    samples = os.path.join(CHAIN_DIR, "samples")
    ds = os.path.join(CHAIN_DIR, "dataset")
    subprocess.run([sys.executable, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                 "example", "make_synthetic_samples.py"),
                    "--output_dir", samples, "--n", str(V1_SAMPLES)],
                   check=True, capture_output=True, timeout=300)
    kernel, encode, shapes, batches = filters.activation1d_kernel, api.AudioEncoder.encode, \
        set(), []

    def record_kernel(x, p):
        shapes.add(tuple(x.shape))
        return kernel(x, p)

    def timed_encode(self, wav):  # the codes come back to the host: no sync needed
        t = time.perf_counter()
        codes = encode(self, wav)
        batches.append((len(wav), time.perf_counter() - t))
        return codes

    filters.activation1d_kernel, api.AudioEncoder.encode = record_kernel, timed_encode
    try:
        _zero(counters)
        t0 = time.perf_counter()
        written = data_vectorizer.main(
            ["--samples_path", os.path.join(samples, "samples.jsonl"), "--output_dir", ds,
             "--batch_size", "8", "--device", "cuda"])
        wall = time.perf_counter() - t0
    finally:
        filters.activation1d_kernel, api.AudioEncoder.encode = kernel, encode
    merged = data_merger.main(["--dataset_dir", ds])
    got = _counts(counters)
    _check_counts("v1 vectorize", got, _want(counters, activation1d_kernel=G_PER_ENCODE
                                             * len(batches)))
    checked = {(b, t, c) for b in V1_BATCHES for _, t, c, _ in encoder_shapes(V1_T)}
    if not shapes <= checked:
        raise AssertionError(f"v1 ran kernel G at shapes check_kernel_g did not hold "
                             f"against its plain version: {sorted(shapes - checked)}")
    n_codes = 0
    for split, (n, codes_n) in written.items():
        codes, kept, spans, _ = codes_io.load_and_filter_audio_codes_and_samples(ds, split)
        own = [int(16000 * s.duration) // 320 + 1 for s in kept]
        if not (len(kept) == n and len(codes) == codes_n == sum(own)
                and [b - a for a, b in spans] == own):
            raise AssertionError(f"v1: merged {split} has {len(kept)} samples, {len(codes)} "
                                 f"codes; spans {spans}, own counts {own}")
        n_codes += len(codes)
    n = sum(n for n, _ in written.values())
    n_train = -(-written["train"][0] // 8)  # the train split is encoded first
    warm = batches[1:n_train]
    log(f"  v1 data_vectorizer: {n} samples ({written['train'][0]} train, "
        f"{written['val'][0]} val), full-width seeded encoder, G at {len(shapes)} shapes; "
        f"encode seconds a batch (size): "
        + " ".join(f"{t:.3f} ({b})" for b, t in batches)
        + f"; train batches 2-{n_train}: {sum(b for b, _ in warm) / sum(t for _, t in warm):.2f}"
        f" samples/s encoded; the tool's wall {wall:.2f} s (wav reads, the encoder's "
        f"set-up and the first batch's cuDNN set-up included), {n_codes} codes; "
        f"data_merger {merged}; launches {got}")
    return ds, got


def run_convert_and_serve(train_out: str, counters, vocab: int = FIXED_VOCAB
                          ) -> tuple[str, dict, dict]:
    """c1: ``tools.convert_checkpoint`` turns the SFT's final model into an
    HF dir (``--architecture llama-3.2-1b --vocab_size 193856 --quantize
    int8``, with a seeded r 16 adapter written by ``lora.save_adapter``); the
    merged weights must equal ``lora.merge`` of the final model, bitwise,
    in the dir as read back. Then ``tools.serving_inference`` runs 128
    tokens on the dir (A, B) and on its ``quantized-int8`` dir (A, Q).
    Returns the HF dir (the quantized one deleted), the launch counts and
    the final model's weights (on the host, as trained)."""
    import shutil

    from tts_max_tpu_torch.models import hf_import, lora, safetensors_io
    from tts_max_tpu_torch.tools import convert_checkpoint, serving_inference
    from tts_max_tpu_torch.training.optim import tree_items, tree_map

    hf_dir = os.path.join(CHAIN_DIR, "serving")
    trained = hf_import._unflatten_tree(safetensors_io.load_file(
        os.path.join(train_out, "final_model", "model.safetensors")))
    adapter = lora.init_lora(trained, r=16, seed=5, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(6)
    for path, t in lora.adapter_items(adapter):
        if path.endswith("/b"):  # b = 0 would merge to nothing
            t.copy_(torch.randn(t.shape, generator=gen, device="cuda") * 0.01)
    adapter_path = os.path.join(CHAIN_DIR, "adapter.npz")
    lora.save_adapter(adapter_path, adapter)
    _zero(counters)
    t0 = time.perf_counter()
    merged, cfg = convert_checkpoint.main([
        "--checkpoint_dir", train_out, "--output_dir", hf_dir, "--architecture", CHAIN_ARCH,
        "--vocab_size", str(vocab), "--lora_adapter", adapter_path, "--lora_r", "16",
        "--lora_alpha", "32", "--quantize", "int8", "--device", "cuda"])
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    _check_counts("c1 convert_checkpoint", _counts(counters), _want(counters))
    q_dir = os.path.join(hf_dir, "quantized-int8")
    sizes = (os.path.getsize(os.path.join(hf_dir, "model.safetensors")) / 2 ** 30,
             _gib(q_dir), os.path.getsize(adapter_path) / 2 ** 20)
    with torch.no_grad():
        want = lora.merge(tree_map(lambda t: t.to("cuda").float(), trained), adapter, 32, 16)
    loaded, lcfg = hf_import.load_model_from_hf_dir(hf_dir, device="cuda", dtype=torch.float32)
    n_leaves = 0
    for (name, a), (_, b), (_, c) in zip(tree_items(merged), tree_items(want),
                                         tree_items(loaded)):
        if not (torch.equal(a, b) and torch.equal(a, c)):
            raise AssertionError(f"c1: {name} of the HF dir is not lora.merge of the final "
                                 f"model (max err {max_err(a, b):.3e}, {max_err(a, c):.3e})")
        n_leaves += 1
    moved = max_err(want["layers"]["mlp"]["w_up"]["kernel"],
                    trained["layers"]["mlp"]["w_up"]["kernel"].to("cuda"))
    if not (lcfg.vocab_size == vocab == cfg.vocab_size and n_leaves == len(
            list(tree_items(trained))) and moved > 0):
        raise AssertionError(f"c1: vocab {lcfg.vocab_size}, {n_leaves} leaves, merge moved "
                             f"w_up by {moved}")
    del merged, want, loaded
    log(f"  c1 convert_checkpoint ({CHAIN_ARCH}, vocab {vocab}, r 16 alpha 32 adapter of "
        f"{sizes[2]:.1f} MiB, --quantize int8): {convert_s:.2f} s; HF dir "
        f"{sizes[0]:.2f} GiB (fp32, as the JAX tool writes), quantized-int8 {sizes[1]:.2f} "
        f"GiB; all {n_leaves} tensors bitwise lora.merge of the final model (w_up moved "
        f"by up to {moved:.3e})")

    L, totals = cfg.n_layers, _want(counters)
    for label, model_dir in (("HF dir", hf_dir), ("quantized-int8", q_dir)):
        _zero(counters)
        out = os.path.join(CHAIN_DIR, f"c1_{label.split()[0]}.wav")
        rep = serving_inference.main([
            "--model_dir", model_dir, "--text", TEXT, "--output", out,
            "--voice_description", DESCRIPTIONS[0], "--max_tokens", "128", "--device", "cuda"])
        res, got = rep["result"], _counts(counters)
        want = dict(flash_attention=L, flash_decode_attention=L * res.decode_steps,
                    activation1d_kernel=G_PER_ENCODE)
        if model_dir == q_dir:
            want["quant_matmul"] = (7 * L + 1) * res.decode_steps + 1
        _check_counts(f"c1 serving_inference on the {label}", got, _want(counters, **want))
        n = _check_wav_file(f"c1 {label}", out)
        if not (np.isfinite(res.wav).all() and res.wav.shape == (1, n)):
            raise AssertionError(f"c1 {label}: wav {res.wav.shape}, file {n} samples")
        log(f"  c1 serving_inference on the {label}: load {rep['load_s']:.2f} s, prefill "
            f"{1e3 * res.prefill_time:.2f} ms, {res.decode_steps} steps "
            f"({res.decode_steps / res.decode_time:.1f} tok/s), {n / 16000:.2f} s of audio")
        totals = {k: totals[k] + v for k, v in got.items()}
    shutil.rmtree(q_dir)
    return hf_dir, totals, trained


def run_distill(hf_dir: str, ds: str, counters) -> tuple[str, dict]:
    """d1: ``tools.distill_draft --model_dir <c1's dir> --dataset_dir <v1's>
    --draft_layers 4 --batch 8 --seq 512 --steps 8``: each step runs kernel
    A once a target layer without the training outputs and once a draft
    layer with them, and A' once a draft layer. The steps must make no host
    sync inside the step (flagged by the sync debug mode): the host reads
    only step 1's KL (the tool logs every 20th) and, after the loop, every
    step's. Logs
    KL and grad norm per step, ms/step over steps 2-8 (one read at their
    end), padded and real tokens/s and peak memory. Returns the draft dir
    and the launch counts."""
    from tts_max_tpu_torch.models import hf_import
    from tts_max_tpu_torch.tools import distill_draft

    draft_dir = os.path.join(CHAIN_DIR, "draft")
    L = hf_import.config_from_hf(hf_dir).n_layers
    _zero(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with flag_syncs() as syncs:
        res = distill_draft.main([
            "--model_dir", hf_dir, "--dataset_dir", ds, "--output_dir", draft_dir,
            "--draft_layers", str(D1_LAYERS), "--batch", str(D1_BATCH), "--seq", str(D1_SEQ),
            "--steps", str(D1_STEPS), "--device", "cuda"])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    got = _counts(counters)
    _check_counts("d1 distill_draft", got, _want(
        counters, flash_attention=(L + D1_LAYERS) * D1_STEPS,
        flash_attention_bwd=D1_LAYERS * D1_STEPS))
    if not (len(res.kl) == D1_STEPS and np.isfinite(res.kl).all()
            and np.isfinite(res.grad_norm).all() and res.draft_cfg.n_layers == D1_LAYERS
            and os.path.isfile(os.path.join(draft_dir, "model.safetensors"))):
        raise AssertionError(f"d1: kl {res.kl}, grad norms {res.grad_norm}")
    in_step = [st for st in syncs if any(f.filename.endswith(os.path.join("training", name))
                                         for f in st for name in ("distill.py", "optim.py"))]
    if in_step:
        raise AssertionError(f"d1: host syncs inside the distillation step: "
                             f"{dict(_sync_sites(in_step))}")
    loop = collections.Counter(f"distill_draft.py:{f.lineno}" for st in syncs for f in st
                               if f.filename.endswith("distill_draft.py")
                               and f.name == "main")
    ms = 1e3 * res.rest_seconds / (D1_STEPS - 1)
    share = sum(res.real_tokens) / (res.tokens_per_step * D1_STEPS)
    log(f"  d1 distill_draft (target {L} layers from the c1 dir, bf16; draft {D1_LAYERS} "
        f"layers; batch {D1_BATCH} x seq {D1_SEQ}, {D1_STEPS} steps, AdamW 3e-4): KL "
        + " ".join(f"{x:.4f}" for x in res.kl) + "; grad norms "
        + " ".join(f"{x:.3f}" for x in res.grad_norm)
        + f"; {ms:.1f} ms/step over steps 2-{D1_STEPS} (read once at their end; step 1 "
        f"{res.first_seconds:.3f} s with its set-up), "
        f"{res.tokens_per_step / ms * 1e3:.0f} padded tokens/s, "
        f"{sum(res.real_tokens[1:]) / (D1_STEPS - 1) / ms * 1e3:.0f} real; real tokens a "
        f"step {res.real_tokens} ({share:.1%} of the padded); host syncs in the tool's main "
        f"(reads and the save) {dict(loop)}, none inside a step; peak max_memory_allocated "
        f"{peak:.2f} GiB; draft dir {_gib(draft_dir):.2f} GiB; wall {wall:.1f} s; "
        f"launches {got}")
    return draft_dir, got


def run_sp3(tok, sv, hf_dir: str, draft_dir: str, counters) -> tuple[dict, dict]:
    """sp3: ``speculative_generate`` with c1's target and d1's draft, both
    read from their dirs in bf16, on sp2's batch and budget (the four voice
    descriptions, 128 tokens, gamma 4, temperature 0.9, top-k 50). The
    weights are random and barely trained, so the acceptance measures the
    pipeline, not speech. Returns its numbers and the launch counts."""
    from tts_max_tpu_torch.data import normalization
    from tts_max_tpu_torch.inference.speculative import speculative_generate
    from tts_max_tpu_torch.models import hf_import
    from tts_max_tpu_torch.ops.sampling import SamplingParams

    target, tcfg = hf_import.load_model_from_hf_dir(hf_dir, device="cuda", dtype=torch.bfloat16)
    draft, dcfg = hf_import.load_model_from_hf_dir(draft_dir, device="cuda",
                                                   dtype=torch.bfloat16)
    normalizer = normalization.create()
    rows = [engine_prompt(tok, normalizer, None, "desc", i)[0] for i in range(4)]
    lens = [len(r) for r in rows]
    prompt = np.zeros((4, max(lens)), np.int32)
    for i, r in enumerate(rows):
        prompt[i, :len(r)] = r
    window, gamma = sv.generation_window(), 4
    _zero(counters)
    res = speculative_generate(target, tcfg, draft, dcfg, prompt, lens,
                               torch.Generator(device="cuda").manual_seed(7),
                               sp=SamplingParams(temperature=0.9, top_k=50),
                               max_new_tokens=128, eos_id=sv.speech_end_id, gamma=gamma,
                               vocab_window=window, device="cuda")
    got = _counts(counters)
    _check_counts("sp3 speculative", got, _want(
        counters, flash_attention=tcfg.n_layers + dcfg.n_layers,
        flash_decode_attention=dcfg.n_layers * (gamma + 1) * res.steps))
    toks, n_gen = res.tokens.cpu().numpy(), res.num_generated.cpu().numpy()
    lo, size = window
    for row, n in zip(toks, n_gen):
        if not (((row[:n] >= lo) & (row[:n] < lo + size)).all()
                and (n == 128 or row[n - 1] == sv.speech_end_id)):
            raise AssertionError(f"sp3: a row of {n} tokens: {row[:n]}")
    out = dict(rounds=res.steps, per_round=float(np.mean((n_gen - 1) / res.steps)),
               tok_s=int(n_gen.sum()) / res.decode_time, ms=1e3 * res.decode_time)
    log(f"  sp3 bf16, c1's {tcfg.n_layers}-layer target and d1's distilled {dcfg.n_layers}-"
        f"layer draft from their dirs, batch 4, 128 tokens, gamma {gamma}, temperature 0.9, "
        f"top-k 50: {res.steps} rounds, {out['per_round']:.3f} tokens per round a row, "
        f"{out['tok_s']:.1f} tok/s ({out['ms']:.1f} ms); random weights, so the acceptance "
        f"measures the pipeline, not speech")
    return out, got


def run_lora_step(params, cfg, counters) -> dict:
    """l1: one forward and backward of ``lora.lora_loss_fn`` around the
    chunked causal-LM loss (chunk 256), r 16 and alpha 32 on every attn/mlp
    kernel of the main path's Llama-3.2-1B, batch 2 x 2048, remat full as
    ``sft.json`` has it, run twice (the second timed): every adapter grad
    finite and non-zero, no base leaf with a grad, the base bytes unchanged.
    Returns the launch counts of both runs."""
    import dataclasses

    from tts_max_tpu_torch.models import lora
    from tts_max_tpu_torch.training import train_step as ts
    from tts_max_tpu_torch.training.optim import tree_items, tree_map

    rcfg = dataclasses.replace(cfg, remat=True, remat_policy=None)
    before = tree_map(lambda t: t.clone(), params)
    adapters = lora.init_lora(params, r=16, seed=8)
    gen = torch.Generator(device="cuda").manual_seed(9)
    for path, t in lora.adapter_items(adapters):
        if path.endswith("/b"):  # with b = 0 the grads of a would be zero
            t.copy_(torch.randn(t.shape, generator=gen, device="cuda") * 0.01)
        t.requires_grad_(True)
    leaves = [t for _, t in lora.adapter_items(adapters)]
    rng = np.random.default_rng(10)
    ids = rng.integers(0, 65806, (L1_BATCH, L1_SEQ)).astype(np.int32)
    labels = ids.copy()
    labels[:, :L1_SEQ // 4] = -100
    batch = ts.to_device_batch({"input_ids": ids, "labels": labels}, "cuda")
    fn = lora.lora_loss_fn(params, 32, 16, lambda p, b: ts.loss_fn(p, rcfg, b, 256)[0])
    L, totals, times = cfg.n_layers, _want(counters), []
    for _ in range(2):
        _zero(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = fn(adapters, batch)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        got = _counts(counters)
        _check_counts("l1 LoRA step", got, _want(counters, flash_attention=2 * L,
                                                 flash_attention_bwd=L))
        totals = {k: totals[k] + v for k, v in got.items()}
    bad = [name for (name, _), g in zip(lora.adapter_items(adapters), grads)
           if not (bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0)]
    touched = [name for (name, a), (_, b) in zip(tree_items(params), tree_items(before))
               if a.requires_grad or a.grad is not None or not torch.equal(a, b)]
    if bad or touched or not bool(torch.isfinite(loss.detach())):
        raise AssertionError(f"l1: loss {float(loss.detach())}, bad adapter grads {bad}, base leaves "
                             f"touched {touched}")
    log(f"  l1 LoRA step ({lora.trainable_count(adapters)} adapter params on "
        f"{len(leaves) // 2} stacked kernels, batch {L1_BATCH} x {L1_SEQ}, remat full): loss "
        f"{float(loss.detach()):.4f}; {1e3 * times[1]:.1f} ms forward and backward (first run "
        f"{1e3 * times[0]:.1f} ms); every adapter grad finite and non-zero, the base "
        f"unchanged and gradless; launches {got} a run")
    return totals


def _check_wavs(label, rec, paths) -> None:
    for path in paths:
        _check_wav_file(label, path)
        if not rec.finite.get(path):
            raise AssertionError(f"{label}: {path} was not written finite ({rec.finite})")


def _q1_dir() -> str:
    """q1's files, beside the chain's: they outlive the chain's directory."""
    return os.path.join(os.path.dirname(CHAIN_DIR), "chip_smoke_q1")


def write_seeded_codec_checkpoints() -> tuple[str, str, str]:
    """q1's inputs: the main path's codec at full width, drawn from its seeds
    (the Vocos decoder, the encoder and a 24-layer w2v-bert; the weights
    ``build_main_path`` draws later, but for the decoder's biases, here drawn
    from N(0, 0.02^2) as a trained decoder's are not zero), written as torch
    checkpoints in the layouts the port's importers read and read back
    bitwise; and a seeded 5 s prompt wav. g1 trains from this decoder
    checkpoint on v1's codes, where the seeded encoder gives every frame
    FSQ's zero code: a decoder with zero biases maps those to all-zero
    activations, where each of its normalizations scales the gradient by
    1/sqrt(eps), and its grads overflow (NaN at g1's second step on the
    H100). Returns the decoder and encoder checkpoint paths and the wav's
    path; the directory goes after the phrases of q1."""
    from tts_max_tpu_torch import convert
    from tts_max_tpu_torch.data.audio_io import save_wav
    from tts_max_tpu_torch.models.codec import encoder, torch_import, vocos, w2vbert
    from tts_max_tpu_torch.training import optim

    vcfg, ecfg, wcfg = vocos.VocosConfig(), encoder.EncoderConfig(), w2vbert.W2VBertConfig()
    dec = vocos.init_decoder(vcfg, seed=1, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(9)
    with torch.no_grad():
        for path, t in optim.tree_items(dec):
            if path.endswith("bias"):
                t.copy_(0.02 * torch.randn(t.shape, generator=gen, device="cuda"))
    enc = encoder.init_encoder(ecfg, seed=2, device="cuda")
    w2v = w2vbert.init_params(wcfg, seed=3, device="cuda")
    t0 = time.perf_counter()
    dec_path, enc_path = write_codec_checkpoints(os.path.join(_q1_dir(), "codec"), dec, enc,
                                                 w2v)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dec_sd = torch_import.load_torch_checkpoint(dec_path)
    enc_sd = torch_import.load_torch_checkpoint(enc_path)
    dec_back = torch_import.import_decoder(dec_sd, vcfg, device="cuda")
    enc_back = torch_import.import_encoder(enc_sd, ecfg, device="cuda")
    w2v_back = convert.w2vbert_from_numpy(w2vbert.import_hf_state_dict(enc_sd, wcfg), wcfg,
                                          device="cuda")
    read_s = time.perf_counter() - t0
    # the trees read back, written out again, give the files' tensors bitwise
    again = {**decoder_state_dict(dec_back, enc_back["quantizer"]["project_in"]),
             **encoder_state_dict(enc_back), **w2vbert_state_dict(w2v_back)}
    written = {**dec_sd, **enc_sd}
    bad = [k for k in written
           if k not in again or not torch.equal(again[k], torch.as_tensor(written[k]))]
    if bad or len(again) != len(written):
        raise AssertionError(f"q1: codec checkpoint tensors that do not read back bitwise: "
                             f"{bad[:8]} ({len(again)} rewritten, {len(written)} written)")
    n = len(written)
    wav_path = os.path.join(_q1_dir(), "p5s.wav")
    save_wav(wav_path, prompt_wavs()["p5s"], 16000)
    log(f"  q1 seeded codec checkpoints (Vocos {vcfg.hidden_dim} x {vcfg.depth}, encoder, "
        f"w2v-bert {wcfg.hidden_size} x {wcfg.num_layers}): decoder "
        f"{os.path.getsize(dec_path) / 2 ** 30:.2f} GiB, encoder with w2v-bert "
        f"{os.path.getsize(enc_path) / 2 ** 30:.2f} GiB written in {write_s:.2f} s, read back "
        f"in {read_s:.2f} s: all {n} tensors bitwise")
    return dec_path, enc_path, wav_path


def run_random_phrases(tok, sv, model, codec, trained, wav_path: str, counters) -> dict:
    """q1's second half: ``RandomPhrasesSynthesizer`` on the SFT's trained
    weights (c1 read them) with two phrases and ``max_tokens`` 64, through
    the main path's codec (the same seeded weights as q1's checkpoints): both
    wavs must be written, finite. The validator logs and swallows its
    exceptions, so a missing wav fails the phase. Returns the launch counts."""
    import shutil

    from tts_max_tpu_torch.inference import quality
    from tts_max_tpu_torch.inference.synthesize import InferenceSettings, LocalTtsModel
    from tts_max_tpu_torch.models import llama
    from tts_max_tpu_torch.training.optim import tree_map

    params = tree_map(lambda t: t.to("cuda"), trained)
    cfg = llama.config_for_architecture(CHAIN_ARCH, vocab_size=FIXED_VOCAB)
    tts = LocalTtsModel(params, cfg, tok, sv, codec.encoder, model._audio_decoder, device="cuda")
    out = os.path.join(_q1_dir(), "phrases")
    L = cfg.n_layers
    _zero(counters)
    t0 = time.perf_counter()
    with _WavRecorder(quality) as rec:
        quality.RandomPhrasesSynthesizer(
            tts, out, prompt_wavs={wav_path: REQUESTS[1][2]},
            phrases=quality.DEFAULT_PHRASES[:2],
            settings=InferenceSettings(max_tokens=64)).validate(params, TRAIN_STEPS + 1)
    wall = time.perf_counter() - t0
    got = _counts(counters)
    steps = got["flash_decode_attention"] // L
    _check_counts("q1 RandomPhrasesSynthesizer", got, _want(
        counters, flash_attention=2 * L, flash_decode_attention=L * steps,
        activation1d_kernel=G_PER_ENCODE))
    _check_wavs("q1 random phrases", rec, [
        os.path.join(out, "generations", str(TRAIN_STEPS + 1), f"rank0_{i}.wav")
        for i in range(2)])
    if not 2 <= steps <= 128:
        raise AssertionError(f"q1 random phrases: {steps} decode steps")
    log(f"  q1 RandomPhrasesSynthesizer on the trained weights, two phrases, max_tokens 64: "
        f"both wavs written finite ({steps} decode steps) in {wall:.2f} s; launches {got}")
    shutil.rmtree(_q1_dir())
    return got


def run_quant_quality(counters) -> dict:
    """qq: ``tools.quant_quality`` at the 1B width with the tool's defaults
    (batch 8, prompt 128, 64 greedy steps, seeded bf16 weights), modes int8
    and int4-g128: per mode two prefills of both models (A), two greedy
    decodes (B), and the quantized decode's products and head through kernel
    Q at 8 rows. Returns the launch counts."""
    from tts_max_tpu_torch.models import llama
    from tts_max_tpu_torch.tools import quant_quality

    modes = list(QQ_MODES)
    _zero(counters)
    t0 = time.perf_counter()
    rows = quant_quality.main(["--arch", CHAIN_ARCH, "--modes", ",".join(modes),
                               "--device", "cuda"])
    wall = time.perf_counter() - t0
    got = _counts(counters)
    L, steps = llama.config_for_architecture(CHAIN_ARCH).n_layers, 64
    _check_counts("qq quant_quality", got, _want(
        counters, flash_attention=4 * L * len(modes),
        flash_decode_attention=2 * L * steps * len(modes),
        quant_matmul=((7 * L + 1) * steps + 1) * len(modes)))
    for r in rows:
        if not np.isfinite([r["snr_db"], r["top1"], r["top8"], r["rmse"], r["div"]]).all():
            raise AssertionError(f"qq: {r}")
    log(f"  qq quant_quality {CHAIN_ARCH} (random init, batch 8 x prompt 128, {steps} "
        f"greedy steps) in {wall:.1f} s: " + "; ".join(
            f"{r['mode']} snr {r['snr_db']:.2f} dB, top1 {r['top1']:.3f}, top8 "
            f"{r['top8']:.3f}, rmse {r['rmse']:.4f}, div@ {r['div']:.1f}, tok= "
            f"{r['match']:.3f}" for r in rows)
        + f"; {quant_quality.RANDOM_NOTE} launches {got}")
    return got


# --- the codec GAN (g1, its small check) and SFT from an HF directory (h1) ---

GAN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_gan")
GAN_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "example", "configs",
                          "codec_training_config.json")
G1_STEPS, G1_SAVE, G1_TRACED = 8, 4, 5
H1_STEPS, H1_TRACED = 5, 2  # a warm-up step, a traced one, three timed ones
TOKENIZER_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                 "fixtures", "llama3_style_tokenizer")
SMALL_GAN_TOL = {"metrics": 1e-4, "params": 1e-4}


class StepProbe:
    """Wraps a module's step function for one phase. Each call runs inside
    ``flag_syncs`` (the syncs of call i in ``syncs[i]``), and call
    ``traced`` (1-based) under ``utils/profiling.trace``, timed inside the
    trace between two ``torch.cuda.synchronize()`` (outside the step): its
    busy time is the union of the card's kernel and copy intervals. The
    profiler slows the host, so the share is given both over that traced
    wall and over an untraced step's wall (the same device work)."""

    def __init__(self, module, name: str, traced: int, log_dir: str):
        self.module, self.name, self.traced, self.log_dir = module, name, traced, log_dir
        self.syncs, self.busy_ms, self.wall_ms = [], None, None

    def __enter__(self):
        from tts_max_tpu_torch.utils import profiling

        real = self.real = getattr(self.module, self.name)

        def step(*args, **kw):
            if len(self.syncs) + 1 != self.traced:
                with flag_syncs() as syncs:
                    out = real(*args, **kw)
                self.syncs.append(syncs)
                return out
            with profiling.trace(self.log_dir) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with flag_syncs() as syncs:
                    out = real(*args, **kw)
                torch.cuda.synchronize()
                self.wall_ms = 1e3 * (time.perf_counter() - t0)
            self.busy_ms = profiling.device_busy_us(prof) / 1e3
            self.syncs.append(syncs)
            return out

        setattr(self.module, self.name, step)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)

    def busy_line(self, untraced_ms: float) -> str:
        if not self.busy_ms:
            return (f"device-busy share of step {self.traced}: not measured (the profiler "
                    f"recorded no device time; traced wall {self.wall_ms:.2f} ms)")
        return (f"device-busy share of step {self.traced} (utils/profiling.trace): "
                f"{self.busy_ms:.2f} ms busy of its traced wall {self.wall_ms:.2f} ms = "
                f"{self.busy_ms / self.wall_ms:.4f}; of an untraced step's "
                f"{untraced_ms:.2f} ms = {self.busy_ms / untraced_ms:.4f}")

    def check_no_sync(self, label: str) -> None:
        bad = {i + 1: _sync_sites(s) for i, s in enumerate(self.syncs) if s}
        if bad:
            raise AssertionError(f"{label}: host syncs inside a step: {bad}")


def check_small_gan() -> None:
    """One GAN step of the tiny codec configs on the CPU (plain PyTorch) and
    on the card (cuDNN conv2d, cuFFT; TF32 off), from the same weights and
    batch, Adam eps 1e-3 on both (the first update is then smooth in the
    grads, not lr * sign(g)): every metric within 1e-4 relative, and every
    updated leaf of the generator and the discriminators within 1e-4 of
    max(|leaf|, 1), a tenth of the lr 1e-3 one update moves a weight by."""
    from tts_max_tpu_torch.core.config import CodecTrainingConfig
    from tts_max_tpu_torch.models.codec import discriminator as disc, vocos
    from tts_max_tpu_torch.training import optim
    from tts_max_tpu_torch.training.codec import gan

    vcfg, mcfg, scfg = vocos.tiny_vocos_config(), disc.tiny_mpd_config(), disc.tiny_msd_config()
    cfg = CodecTrainingConfig(generator_lr=1e-3, discriminator_lr=1e-3)
    gp = vocos.init_decoder(vcfg, seed=4, device="cpu")
    dp = optim.tree_map(lambda t: t * 5.0, {"mpd": disc.init_mpd(mcfg, 1, "cpu"),
                                            "msd": disc.init_msd(scfg, 2, "cpu")})
    rng = np.random.default_rng(7)
    batch = {"audio_codes": rng.integers(0, 65536, (2, 16)).astype(np.int32),
             "wav": (0.1 * rng.standard_normal((2, 16 * 320))).astype(np.float32)}
    out = {}
    for dev in ("cpu", "cuda"):
        gt, gf = gan.split_generator_params(optim.tree_map(lambda t: t.to(dev), gp))
        d = optim.tree_map(lambda t: t.to(dev), dp)
        txs = gan.create_gan_optimizers(cfg)
        for tx in txs:
            tx.eps = 1e-3
        step = gan.make_gan_step(vcfg, mcfg, scfg, cfg, gf, *txs)
        out[dev] = step(gt, d, txs[0].init(gt), txs[1].init(d),
                        {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
    cpu, card = out["cpu"], out["cuda"]
    worst_m = max(abs(float(a) - float(b)) / abs(float(b))
                  for a, b in zip(card[-1], cpu[-1]))
    worst_p = 0.0
    for i in (0, 1):
        ref = dict(optim.tree_items(cpu[i]))
        for path, t in optim.tree_items(card[i]):
            r = ref[path]
            worst_p = max(worst_p, max_err(t.cpu(), r) / max(float(r.abs().max()), 1.0))
    if not (worst_m <= SMALL_GAN_TOL["metrics"] and worst_p <= SMALL_GAN_TOL["params"]):
        raise AssertionError(f"small GAN step: card vs CPU metrics {worst_m:.2e} "
                             f"(tol {SMALL_GAN_TOL['metrics']}), params {worst_p:.2e} "
                             f"(tol {SMALL_GAN_TOL['params']})")
    log(f"small GAN step fp32 (tiny Vocos, MPD, MSD), card vs CPU from the same weights: "
        f"metrics " + " ".join(f"{n} {float(v):.5f}" for n, v in zip(card[-1]._fields, card[-1]))
        + f"; worst metric {worst_m:.2e} relative (tol {SMALL_GAN_TOL['metrics']}), worst "
        f"updated leaf {worst_p:.2e} of max(|leaf|, 1) (tol {SMALL_GAN_TOL['params']})")


def run_gan(ds: str, dec_path: str, counters) -> dict:
    """g1: ``python -m tts_max_tpu_torch.training.codec.gan_loop`` (called
    in-process) at full width: ``VocosConfig()``, ``MPDConfig()``,
    ``MSDConfig()``, on ``example/configs/codec_training_config.json`` with
    the dataset (v1's), the output dir and ``save_steps`` changed (batch 8,
    80-code windows: 1.6 s), from the seeded decoder checkpoint q1 wrote,
    as written. G1_STEPS steps with a checkpoint and validation every
    G1_SAVE (the last checkpoint kept). Every loss must be finite, the FSQ
    quantizer the steps ran with bitwise the checkpoint's, 4 generated
    and 4 true wavs written finite, ``model_config.json`` must read back,
    and no host sync may fall inside a step. The run goes through an NCCL
    group of world size 1 (``nccl_world_of_one``): the data-parallel step,
    whose collectives must be three all-reduces a step (the
    discriminators' grads, the generator's, the six losses) and two
    barriers a save. Returns the launch counts (none: the GAN step runs no
    Pallas kernel in the JAX package)."""
    import shutil

    from tts_max_tpu_torch.models.codec import api
    from tts_max_tpu_torch.parallel import collectives
    from tts_max_tpu_torch.training import optim
    from tts_max_tpu_torch.training.codec import gan, gan_loop

    shutil.rmtree(GAN_DIR, ignore_errors=True)
    os.makedirs(GAN_DIR)
    _, frozen = gan.split_generator_params(api.create_decoder(dec_path, device="cpu")._params)
    with open(GAN_CONFIG) as f:
        cfg = json.load(f)
    cfg.update(train_weighted_datasets={ds: 1.0}, output_dir=os.path.join(GAN_DIR, "out"))
    cfg["checkpointing"].update(save_steps=G1_SAVE, keep_only_last_n_checkpoints=1)
    path = os.path.join(GAN_DIR, "codec_training_config.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    _zero(counters)
    collectives.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with StepProbe(gan, "gan_train_step", G1_TRACED, os.path.join(GAN_DIR, "trace")) \
            as probe, _WavRecorder(gan_loop) as rec, nccl_world_of_one():
        res = gan_loop.main(["--config_path", path, "--decoder_checkpoint", dec_path,
                             "--total_steps", str(G1_STEPS), "--device", "cuda"])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    got = _counts(counters)
    _check_counts("g1 GAN", got, _want(counters))
    calls = collectives.counts()
    _check_collectives("g1 GAN", calls, dict(
        all_reduce_sum=3 * G1_STEPS, all_gather=0, reduce_scatter_sum=0,
        barrier=2 * (G1_STEPS // G1_SAVE)))
    out = cfg["output_dir"]
    losses = [v for _, v, _ in res.steps]
    if not (len(losses) == G1_STEPS and all(np.isfinite(list(v.values())).all()
                                            for v in losses)):
        raise AssertionError(f"g1: losses {losses}")
    ran, want = dict(optim.tree_items(res.gen_frozen)), dict(optim.tree_items(frozen))
    same = ran.keys() == want.keys() and all(torch.equal(ran[k].cpu(), want[k]) for k in want)
    if not same or "quantizer" not in res.gen_frozen or "quantizer" in res.gen_trainable:
        raise AssertionError("g1: the FSQ quantizer moved")
    wavs = [os.path.join(out, "quality", f"step_{G1_SAVE}", f"{k}_{i}.wav")
            for k in ("generated", "true") for i in range(4)]
    _check_wavs("g1 validation", rec, wavs)
    dcfg = api.DecoderConfig.from_json(os.path.join(out, "model_config.json"))
    if dcfg != api.DecoderConfig(sample_rate=16000, token_rate=50, hop_length=320):
        raise AssertionError(f"g1: model_config.json reads back as {dcfg}")
    if os.listdir(os.path.join(out, "checkpoints")) != [str(G1_STEPS)]:
        raise AssertionError(f"g1: checkpoints {os.listdir(os.path.join(out, 'checkpoints'))}")
    probe.check_no_sync("g1")
    secs = [s for _, _, s in res.steps]
    ms = 1e3 * float(np.median([s for i, s in enumerate(secs[1:], 2) if i != G1_TRACED]))
    log(f"  g1 GAN (gan_loop on {os.path.relpath(GAN_CONFIG)}: Vocos 1024 x 12, MPD periods "
        f"2/3/5/7/11, MSD 8 resolutions, batch {cfg['training']['batch_size']} x "
        f"{cfg['codec']['code_window_size']} codes; changed: dataset -> v1's, output_dir, "
        f"save_steps 500 -> {G1_SAVE}, keep 5 -> 1; from q1's seeded decoder checkpoint) "
        f"{G1_STEPS} steps in {wall:.1f} s through an NCCL group of world size 1: ms/step "
        f"(median of steps 2-{G1_STEPS} but the traced {G1_TRACED}, each to its loss read) "
        f"{ms:.1f} (one device, no group: 186.3-250.0 in PERF.md, H100 80GB HBM3 at 700 W); "
        f"collectives {calls}; step seconds "
        + " ".join(f"{s:.3f}" for s in secs)
        + f"; peak torch.cuda.max_memory_allocated {peak / 2 ** 30:.2f} GiB; checkpoint "
        f"({_gib(os.path.join(out, 'checkpoints')):.2f} GiB) seconds "
        + " ".join(f"{s:.2f}" for s in res.checkpoint_seconds) + ", with validation "
        + " ".join(f"{s:.2f}" for s in res.save_seconds) + "; "
        f"losses gen " + " ".join(f"{v['gen']:.3f}" for v in losses) + "; disc "
        + " ".join(f"{v['disc']:.3f}" for v in losses) + "; mel "
        + " ".join(f"{v['mel']:.3f}" for v in losses)
        + f"; no host sync inside a step; {probe.busy_line(ms)}; quantizer bitwise the "
        f"checkpoint's; "
        f"4 + 4 wavs finite; {gpu_line()}")
    shutil.rmtree(GAN_DIR)
    return got


def run_hf_sft(model_dir: str, counters) -> dict:
    """h1: ``training.main`` with ``modeling.parameters.model_name`` set to
    an HF directory at Llama-3.2-1B width (the BF16 dir s1 served, with the
    repository's Llama-3-style fixture ``tokenizer.json`` copied in), on
    ``example/configs/sft.json`` with the SFT path's seeded data, H1_STEPS
    optimizer steps (the first warms up, the second is traced, the median of
    the rest is ms/step). The tokenizer, extended to the fixed 193856 ids
    (190k added tokens), must give the fixture's golden ids; A and A' run as
    in the SFT path; the losses are finite. Returns the launch counts."""
    import shutil

    from tts_max_tpu_torch.core import hf_tokenizer
    from tts_max_tpu_torch.models import hf_import
    from tts_max_tpu_torch.training import main as train_main, train_step as ts

    for name in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copy(os.path.join(TOKENIZER_FIXTURE, name), model_dir)
    h1_dir = os.path.join(os.path.dirname(TRAIN_DIR), "chip_smoke_h1")
    path, cfg, changes, data = write_sft_config(h1_dir)
    cfg["modeling"]["parameters"]["model_name"] = model_dir
    with open(path, "w") as f:
        json.dump(cfg, f)
    built, encodes = {}, []
    build, encode = train_main.build_tokenizer, hf_tokenizer.HFTokenizer.encode

    def record_build(*a, **kw):
        t = time.perf_counter()
        built["tok"] = build(*a, **kw)
        built["s"] = time.perf_counter() - t
        return built["tok"]

    def timed_encode(self, text, *a, **kw):
        t = time.perf_counter()
        ids = encode(self, text, *a, **kw)
        encodes.append((time.perf_counter() - t, len(ids)))
        return ids

    train_main.build_tokenizer, hf_tokenizer.HFTokenizer.encode = record_build, timed_encode
    _zero(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with StepProbe(ts, "train_step", H1_TRACED, os.path.join(h1_dir, "trace")) as probe:
            res = train_main.main(["--config_path", path, "--total_steps", str(H1_STEPS)])
    finally:
        train_main.build_tokenizer, hf_tokenizer.HFTokenizer.encode = build, encode
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    got = _counts(counters)
    tok, build_s = built["tok"], built["s"]
    with open(os.path.join(TOKENIZER_FIXTURE, "golden.json")) as f:
        golden = json.load(f)
    bad = [s for s, ids in golden["ids"].items() if tok.encode(s) != ids]
    if bad or len(tok) != golden["vocab_size"] or tok.pad_token_id != golden["pad_token_id"]:
        raise AssertionError(f"h1: tokenizer {len(tok)} ids, pad {tok.pad_token_id}; golden "
                             f"strings with other ids: {bad}")
    losses = [m.loss for _, m, _, _ in res.steps]
    if not (len(losses) == H1_STEPS and np.isfinite(losses).all()):
        raise AssertionError(f"h1 losses {losses}")
    L = hf_import.config_from_hf(model_dir).n_layers
    eval_batches = 4 // cfg["training"]["batch_size"]
    _check_counts("h1 SFT from an HF dir", got, _want(
        counters, flash_attention=L * (2 * H1_STEPS + eval_batches),
        flash_attention_bwd=L * H1_STEPS))
    enc_s = sum(s for s, _ in encodes)
    secs = [s for _, _, s, _ in res.steps]
    ms = 1e3 * float(np.median(secs[H1_TRACED:]))
    log(f"  h1 SFT from an HF dir ({os.path.relpath(model_dir)}: Llama-3.2-1B geometry, BF16, "
        f"vocab 193856, with the fixture tokenizer.json) through training.main, "
        f"{H1_STEPS} steps in {wall:.1f} s: tokenizer built in {build_s:.2f} s "
        f"({len(tok)} ids, {len(tok) - len(tok.vocab)} added tokens), golden ids equal; "
        f"{len(encodes)} encodes while the datasets were built, "
        f"{len(encodes) / enc_s:.1f} samples/s ({sum(n for _, n in encodes) / enc_s:.0f} "
        f"tokens/s); losses " + " ".join(f"{x:.4f}" for x in losses)
        + f"; step seconds " + " ".join(f"{s:.3f}" for s in secs)
        + f" (ms/step, median of steps {H1_TRACED + 1}-{H1_STEPS}, {ms:.1f}); peak "
        f"torch.cuda.max_memory_allocated {peak / 2 ** 30:.2f} GiB; "
        f"{probe.busy_line(ms)}; "
        f"launches {got}")
    shutil.rmtree(h1_dir)
    return got


# --- r1 / r1e: GRPO RLHF through training.rlhf.main ------------------------------

R1_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_r1")
RLHF_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "example", "configs",
                           "rlhf.json")
R1_STEPS = 2
R1E_COMPLETION = 128
WHISPER_TOKENIZER_MAKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                       "fixtures", "make_whisper_style_tokenizer.py")


def check_small_rlhf() -> None:
    """The RLHF slice's small checks, card against CPU: ``grpo_loss`` and its
    grads on a narrow fp32 model (kernels A and A' on the card; loss within
    1e-5, grads within 1e-4 of each leaf's max) and one ``make_grpo_step``
    held against the CPU's AdamW on the card's own grads (1e-6); a small
    fp32 Whisper's greedy tokens identical; a conv/pool/BatchNorm/Gemm ONNX
    graph through ``onnx_lite.run`` within 1e-5."""
    from tts_max_tpu_torch.models import llama, whisper
    from tts_max_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from tts_max_tpu_torch.training import optim
    from tts_max_tpu_torch.training.rlhf import grpo
    from tts_max_tpu_torch.utils import onnx_lite as ox

    cfg = llama.LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                            head_dim=64, ffn_dim=512, rope_theta=10000.0,
                            use_llama3_rope_scaling=False, max_seq_len=256,
                            dtype=torch.float32)
    cpu = llama.init_params(cfg, seed=7, device="cpu")
    rng = np.random.default_rng(8)
    toks = torch.from_numpy(rng.integers(0, 512, (4, 160)))
    mask = torch.zeros(4, 160, dtype=torch.bool)
    mask[:, 60:150] = True
    adv = torch.tensor([1.5, -0.5, 0.25, -1.25])
    out = {}
    for dev in ("cpu", "cuda"):
        leaves = []

        def track(p):
            q = p.detach().to(dev).requires_grad_(True)
            leaves.append(q)
            return q

        live = optim.tree_map(track, cpu)
        loss, _ = grpo.grpo_loss(live, toks.to(dev), mask.to(dev), adv.to(dev), None, cfg=cfg)
        grads = torch.autograd.grad(loss, leaves)
        it = iter([g.cpu() for g in grads])
        out[dev] = (float(loss.detach()), optim.tree_map(lambda _: next(it), cpu))
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    if not abs(lg - lc) <= 1e-5 * max(abs(lc), 1e-3):
        raise AssertionError(f"small GRPO: loss {lg} on the card, {lc} on the CPU")
    ref = dict(optim.tree_items(gc))
    worst_g = 0.0
    for path, a in optim.tree_items(gg):
        rel = max_err(a, ref[path]) / float(ref[path].abs().max())
        worst_g = max(worst_g, rel)
        if not (bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0 and rel <= 1e-4):
            raise AssertionError(f"small GRPO: grad of {path} on the card: max err {rel:.2e} "
                                 f"of max|g|")
    gpu = optim.tree_map(lambda t: t.cuda(), cpu)
    tx = optim.AdamW(1e-4, betas=(0.9, 0.95), weight_decay=0.1, mu_dtype="bf16")
    step = grpo.make_grpo_step(cfg, tx, 0.0)
    flash_attention.launches = flash_attention_bwd.launches = 0
    new, _, m = step(gpu, tx.init(gpu), toks.cuda(), mask.cuda(), adv.cuda(), None)
    if (flash_attention.launches, flash_attention_bwd.launches) != (2, 2):
        raise AssertionError(f"small GRPO step: A {flash_attention.launches}, A' "
                             f"{flash_attention_bwd.launches} launches, expected 2 and 2")
    # the card's step against the CPU optimizer on the card's grads (Adam's
    # first update takes the sign of grads that are rounding noise)
    g_card = gg
    if m.grad_norm > 1.0:
        g_card = optim.tree_map(lambda t: t * (1.0 / m.grad_norm), gg)
    upd, _ = tx.update(g_card, tx.init(cpu), cpu)
    want = dict(optim.tree_items(optim.apply_updates(cpu, upd)))
    worst_p = max(max_err(a.cpu(), want[p]) for p, a in optim.tree_items(new))
    if not (worst_p <= 1e-6 and np.isfinite([m.loss, m.mean_logp, m.grad_norm]).all()):
        raise AssertionError(f"small GRPO step: params {worst_p} off the CPU's step on the "
                             f"card's grads; metrics {m}")

    wcfg = whisper.WhisperConfig(n_mels=80, vocab_size=700, d_model=128, encoder_layers=2,
                                 decoder_layers=2, num_heads=4, ffn_dim=256,
                                 max_source_positions=100, max_target_positions=64,
                                 decoder_start_token_id=600, eos_token_id=599)
    wp = whisper.init_params(wcfg, seed=9, device="cpu")
    wav = torch.from_numpy((rng.standard_normal((2, 32000)) * 0.1).astype(np.float32))
    prompt = torch.tensor([[600, 601, 602], [600, 603, 602]], dtype=torch.int32)
    dec = {}
    for dev in ("cpu", "cuda"):
        p = optim.tree_map(lambda t: t.to(dev), wp)
        enc = whisper.encode(p, wcfg, whisper.log_mel_spectrogram(wav.to(dev), wcfg.n_mels))
        dec[dev] = [t.cpu() for t in whisper.greedy_decode(p, wcfg, enc, prompt.to(dev), 40)]
    if not all(torch.equal(a, b) for a, b in zip(dec["cuda"], dec["cpu"])):
        raise AssertionError(f"small Whisper: greedy tokens {dec['cuda']} on the card, "
                             f"{dec['cpu']} on the CPU")

    primary, _ = dnsmos_graphs(seed=10, width=16)
    g = ox.parse_model(primary)
    x = (rng.standard_normal((1, 144160)) * 0.1).astype(np.float32)
    (a,), (b,) = ox.run(g, {"input_1": x}, "cuda"), ox.run(g, {"input_1": x}, "cpu")
    onnx_err = max_err(a.cpu(), b) / max(float(b.abs().max()), 1.0)
    if not (a.device.type == "cuda" and onnx_err <= 1e-5):
        raise AssertionError(f"small ONNX graph: {onnx_err:.2e} between card and CPU")
    log(f"small RLHF checks, card vs CPU (fp32): GRPO loss {lg:.6f} vs {lc:.6f}, grads max err "
        f"{worst_g:.2e} of each leaf's max (tol 1e-4); one GRPO step (A 2, A' 2 launches) "
        f"within {worst_p:.2e} of the CPU's AdamW on the card's grads (tol 1e-6); Whisper "
        f"greedy tokens identical ({dec['cuda'][1].tolist()} long); DNSMOS-shaped ONNX graph "
        f"within {onnx_err:.2e} (tol 1e-5)")


def dnsmos_graphs(seed: int = 0, width: int = 64) -> tuple[bytes, bytes]:
    """Seeded stand-ins for DNSMOS's two ONNX graphs at its inputs, written
    with the port's ONNX writer from convs, pools, a BatchNorm and Gemms:
    ``sig_bak_ovr`` (raw 16 kHz [1, 144160] -> three raw scores) and
    ``model_v8`` (the P.808 mel [1, T, 120] -> one)."""
    from tts_max_tpu_torch.utils import onnx_lite as ox

    r = np.random.default_rng(seed)
    c = width

    def f32(*shape, scale=1.0):
        return (r.standard_normal(shape) * scale).astype(np.float32)

    primary = ox.build_model_bytes([
        ox.encode_node("Unsqueeze", ["input_1", "ax1"], ["x"]),
        ox.encode_node("Conv", ["x", "w1", "b1"], ["c1"], kernel_shape=[400], strides=[160]),
        ox.encode_node("Relu", ["c1"], ["r1"]),
        ox.encode_node("MaxPool", ["r1"], ["p1"], kernel_shape=[4], strides=[4]),
        ox.encode_node("Conv", ["p1", "w2", "b2"], ["c2"], kernel_shape=[3],
                       auto_pad=b"SAME_UPPER"),
        ox.encode_node("Relu", ["c2"], ["r2"]),
        ox.encode_node("GlobalAveragePool", ["r2"], ["g"]),
        ox.encode_node("Flatten", ["g"], ["f"], axis=1),
        ox.encode_node("Gemm", ["f", "wd", "bd"], ["out"], transB=1),
    ], ["input_1"], ["out"], {
        "ax1": np.asarray([1], np.int64), "w1": f32(c, 1, 400, scale=0.05),
        "b1": f32(c, scale=0.1), "w2": f32(c, c, 3, scale=(3 * c) ** -0.5),
        "b2": f32(c, scale=0.1), "wd": f32(3, c, scale=c ** -0.5),
        "bd": np.asarray([3.0, 3.5, 3.2], np.float32)})
    p808 = ox.build_model_bytes([
        ox.encode_node("Unsqueeze", ["input_1", "ax1"], ["x"]),
        ox.encode_node("Conv", ["x", "w1", "b1"], ["c1"], kernel_shape=[3, 3],
                       pads=[1, 1, 1, 1]),
        ox.encode_node("Relu", ["c1"], ["r1"]),
        ox.encode_node("MaxPool", ["r1"], ["p1"], kernel_shape=[2, 2], strides=[2, 2]),
        ox.encode_node("BatchNormalization", ["p1", "s", "bb", "m", "v"], ["n1"]),
        ox.encode_node("Conv", ["n1", "w2", "b2"], ["c2"], kernel_shape=[3, 3],
                       pads=[1, 1, 1, 1]),
        ox.encode_node("Relu", ["c2"], ["r2"]),
        ox.encode_node("GlobalMaxPool", ["r2"], ["g"]),
        ox.encode_node("Flatten", ["g"], ["f"], axis=1),
        ox.encode_node("Gemm", ["f", "wd", "bd"], ["out"], transB=1),
    ], ["input_1"], ["out"], {
        "ax1": np.asarray([1], np.int64), "w1": f32(c, 1, 3, 3, scale=0.3),
        "b1": f32(c, scale=0.1), "s": np.ones(c, np.float32), "bb": np.zeros(c, np.float32),
        "m": np.zeros(c, np.float32), "v": np.ones(c, np.float32),
        "w2": f32(c, c, 3, 3, scale=(9 * c) ** -0.5), "b2": f32(c, scale=0.1),
        "wd": f32(1, c, scale=0.1 * c ** -0.5), "bd": np.asarray([3.0], np.float32)})
    return primary, p808


def write_reward_models(directory: str) -> dict:
    """r1's reward models at their published widths, seeded, written as real
    checkpoints come: Whisper large-v3 (128 mels, d 1280, 32 + 32 layers, 20
    heads, 51866 ids) as a BF16 HF dir with the full-size Whisper-shaped
    tokenizer (``tests/fixtures/make_whisper_style_tokenizer.py``);
    WavLM-Large (1024 x 24) as an fp32 HF dir; ECAPA-TDNN (``feat_dim``
    1024, channels 512) as a UniSpeech-named torch checkpoint with a seeded
    ``feature_weight`` (``module.``-prefixed under "model", as UniSpeech
    saves it); the two DNSMOS graphs (``dnsmos_graphs``). Returns the paths,
    sizes and seconds."""
    import importlib.util

    from tts_max_tpu_torch.models import wavlm, whisper
    from tts_max_tpu_torch.training.rlhf import ecapa

    t0 = time.perf_counter()
    out = {"whisper_dir": os.path.join(directory, "whisper"),
           "dnsmos_dir": os.path.join(directory, "dnsmos"),
           "wavlm_dir": os.path.join(directory, "wavlm"),
           "ecapa_checkpoint": os.path.join(directory, "ecapa.pt")}
    wcfg = whisper.WhisperConfig()
    params = whisper.init_params(wcfg, seed=11, dtype=torch.bfloat16, device="cuda")
    whisper.save_hf_dir(params, wcfg, out["whisper_dir"])
    del params
    spec = importlib.util.spec_from_file_location("make_whisper_style_tokenizer",
                                                  WHISPER_TOKENIZER_MAKER)
    maker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(maker)
    n_ids = maker.write(out["whisper_dir"])
    if n_ids != wcfg.vocab_size:
        raise AssertionError(f"r1: the Whisper-shaped tokenizer has {n_ids} ids")
    vcfg = wavlm.WavLMConfig()
    wavlm.save_hf_dir(wavlm.init_params(vcfg, seed=12, device="cuda"), vcfg, out["wavlm_dir"])
    ecfg = ecapa.ECAPAConfig(feat_dim=vcfg.hidden_size)
    sd = ecapa.export_torch_state_dict(ecapa.init_params(ecfg, seed=13, device="cuda"), ecfg)
    sd["feature_weight"] = torch.randn(vcfg.num_layers + 1,
                                       generator=torch.Generator().manual_seed(14))
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}}, out["ecapa_checkpoint"])
    os.makedirs(out["dnsmos_dir"], exist_ok=True)
    for name, data in zip(("sig_bak_ovr.onnx", "model_v8.onnx"), dnsmos_graphs(seed=15)):
        with open(os.path.join(out["dnsmos_dir"], name), "wb") as f:
            f.write(data)
    out["seconds"] = time.perf_counter() - t0
    out["gib"] = {k: _gib(v) if os.path.isdir(v) else os.path.getsize(v) / 2 ** 30
                  for k, v in out.items() if k.endswith(("_dir", "_checkpoint"))}
    return out


def write_extended_tokenizer(model_dir: str) -> int:
    """The repository's Llama-3-style fixture tokenizer, extended with the
    speech vocabulary to the fixed 193856 ids and written into ``model_dir``
    with every added token in its ``tokenizer.json``, as an SFT checkpoint's
    saved tokenizer carries them (the policy samples from all 193856 ids,
    and every id a rollout emits must be one the tokenizer knows). Returns
    the number of ids."""
    import shutil

    from tts_max_tpu_torch.core import hf_tokenizer, tokenization

    tok = tokenization.extend_tokenizer(hf_tokenizer.HFTokenizer.from_dir(TOKENIZER_FIXTURE),
                                        expected_vocab_size=FIXED_VOCAB)
    with open(os.path.join(TOKENIZER_FIXTURE, "tokenizer.json"), encoding="utf-8") as f:
        spec = json.load(f)
    spec["added_tokens"] = [
        {"id": i, "content": t.content, "single_word": t.single_word, "lstrip": t.lstrip,
         "rstrip": t.rstrip, "normalized": t.normalized, "special": t.special}
        for i, t in sorted(tok._added_tokens.items())]
    with open(os.path.join(model_dir, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    shutil.copy(os.path.join(TOKENIZER_FIXTURE, "tokenizer_config.json"), model_dir)
    return len(tok)


def write_rlhf_config(out_dir: str, **rlhf) -> tuple[str, dict]:
    """``example/configs/rlhf.json`` with r1's changes: one prompt a step
    (``batch_size`` 4 -> 1: one GRPO group of ``num_generations`` 8; 4
    prompts would put 32 clips a step through Whisper, four times r1's
    reward time), ``save_steps`` 50 -> 2, ``keep_only_last_n_checkpoints``
    3 -> 1, ``save_completions_every_n_steps`` 50 -> 2 and ``output_dir``;
    ``rlhf`` overrides more rlhf keys (r1e)."""
    with open(RLHF_CONFIG) as f:
        cfg = json.load(f)
    cfg["training"]["batch_size"] = 1
    cfg["checkpointing"].update(save_steps=2, keep_only_last_n_checkpoints=1)
    cfg["rlhf"].update({"save_completions_every_n_steps": 2, **rlhf})
    cfg["output_dir"] = out_dir
    path = out_dir + ".json"
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path, cfg


class _GRPORecorder:
    """Wraps ``GRPOTrainer.train_step`` and ``make_grpo_step`` for r1: per
    step the parameter tree before it, the tree its rollout sampled from,
    the tree after it, the share of parameter elements the update changed,
    the advantages and the stats; and the update of step ``traced`` under
    ``utils/profiling.trace`` (its busy time and wall, synchronized)."""

    def __init__(self, log_dir: str, traced: int):
        self.log_dir, self.traced = log_dir, traced
        self.steps, self.updates = [], 0
        self.busy_ms = self.wall_ms = None

    def __enter__(self):
        from tts_max_tpu_torch.training.optim import tree_leaves
        from tts_max_tpu_torch.training.rlhf import grpo
        from tts_max_tpu_torch.utils import profiling

        self.grpo = grpo
        self.real_step, self.real_make = grpo.GRPOTrainer.train_step, grpo.make_grpo_step
        rec = self

        def train_step(trainer, prompts):
            before = trainer.params
            stats = rec.real_step(trainer, prompts)
            with torch.no_grad():
                moved = sum(int((a != b).sum()) for a, b in zip(
                    tree_leaves(before), tree_leaves(trainer.params)))
                total = sum(t.numel() for t in tree_leaves(before))
            rec.steps.append(dict(before=id(before), rollout=id(trainer.rollout_params),
                                  after=id(trainer.params), moved=moved / total,
                                  adv=trainer.last_batch.advantages.copy(), stats=stats))
            log(f"  r1 step {len(rec.steps)} done: " + " ".join(
                f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                for k, v in stats.items()) + f"; peak so far "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
            return stats

        def make(*a, **kw):
            real = rec.real_make(*a, **kw)

            def step(*args):
                rec.updates += 1
                if rec.updates != rec.traced:
                    return real(*args)
                with profiling.trace(rec.log_dir) as prof:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = real(*args)
                    torch.cuda.synchronize()
                    rec.wall_ms = 1e3 * (time.perf_counter() - t0)
                rec.busy_ms = profiling.device_busy_us(prof) / 1e3
                return out

            return step

        grpo.GRPOTrainer.train_step, grpo.make_grpo_step = train_step, make
        return self

    def __exit__(self, *exc):
        self.grpo.GRPOTrainer.train_step = self.real_step
        self.grpo.make_grpo_step = self.real_make


def run_rlhf(hf_dir: str, ds: str, dec_path: str, counters, rec: _HostRecorder) -> dict:
    """r1: ``training.rlhf.main`` on ``example/configs/rlhf.json`` as users
    run it (``write_rlhf_config``'s changes, R1_STEPS steps) from c1's
    Llama-3.2-1B HF dir (the SFT's final model, with the fixture tokenizer
    extended to 193856 ids written in, ``write_extended_tokenizer``) on v1's
    dataset (40 samples whose wavs exist), q1's seeded full-width Vocos
    decoder, and all three rewards backed by ``write_reward_models``'s
    full-width models. Checks: every completion transcribed (8 a step),
    embedded (16) and scored (8) by its backend with no call failing;
    advantages finite and not all zero; loss, mean logprob and grad norm
    finite, grad norm > 0; round 2 sampled from step 1's updated tensors;
    fp32 weights with remat, over half of them moved by each step; a
    checkpoint at step 2; the launches A = 3 x layers a step (the
    rollout's prefill, the update's forward and its remat recompute), A' =
    layers a step, B = layers a decode step; a native edit distance for each
    WER reward whose reference has a word (``rec`` records them). Then r1e:
    one step through the contiguous engine
    (``--rollout_via_engine``, ``max_completion_length`` 128,
    ``constrain_to_speech`` on so that the engine keeps a head window; no
    Whisper dir, so its WER reward takes the no-backend score: r1 holds
    Whisper, and its 8 clips would double r1e's time), after which the
    engine's params and head window are the trainer's; its launches: A =
    layers for each prefill group and twice for the update, C = layers a
    decode step. Returns the launch counts of both."""
    import shutil

    from tts_max_tpu_torch import native
    from tts_max_tpu_torch.models import hf_import, llama
    from tts_max_tpu_torch.training.optim import tree_leaves
    from tts_max_tpu_torch.training.rlhf import main as rlhf_main

    shutil.rmtree(R1_DIR, ignore_errors=True)
    os.makedirs(R1_DIR)
    t0 = time.perf_counter()
    n_ids = write_extended_tokenizer(hf_dir)
    tok_s = time.perf_counter() - t0
    models = write_reward_models(os.path.join(R1_DIR, "rewards"))
    log(f"  r1 inputs: c1's dir with the fixture tokenizer extended to {n_ids} ids "
        f"({tok_s:.2f} s); reward models written in {models['seconds']:.1f} s: "
        + ", ".join(f"{k} {v:.2f} GiB" for k, v in models["gib"].items()))
    L = hf_import.config_from_hf(hf_dir).n_layers
    backend_args = ["--whisper_dir", models["whisper_dir"], "--dnsmos_dir",
                    models["dnsmos_dir"], "--wavlm_dir", models["wavlm_dir"],
                    "--ecapa_checkpoint", models["ecapa_checkpoint"]]
    path, cfg = write_rlhf_config(os.path.join(R1_DIR, "out"))
    G = cfg["rlhf"]["num_generations"]
    _zero(counters)
    native.reset_counts()
    n_wer = len(rec.wer_pairs)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _GRPORecorder(os.path.join(R1_DIR, "trace"), traced=2) as grpo_rec:
        res = rlhf_main.main(["--config_path", path, "--dataset_dir", ds, "--model_dir",
                              hf_dir, "--codec_decoder", dec_path, "--total_steps",
                              str(R1_STEPS), "--device", "cuda", *backend_args])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    got = _counts(counters)
    scored = rec.wer_scored(rec.label)
    log(f"  r1: {len(rec.wer_pairs) - n_wer} WER rewards reached a transcript, {scored} of "
        f"them with a reference that has a word")
    _check_host_counts("r1", encodes_at_least=0, levenshtein=scored)
    steps = [s["stats"] for s in grpo_rec.steps]
    decode = sum(s["decode_steps"] for s in steps)
    _check_counts("r1 GRPO RLHF", got, _want(
        counters, flash_attention=3 * L * R1_STEPS, flash_attention_bwd=L * R1_STEPS,
        flash_decode_attention=L * decode))
    b = res.backends
    want_calls = {"transcribe_fn": G * R1_STEPS, "embed_fn": 2 * G * R1_STEPS,
                  "dnsmos_fn": G * R1_STEPS}
    calls = {k: (b[k].calls, b[k].completed) for k in want_calls}
    if calls != {k: (n, n) for k, n in want_calls.items()}:
        raise AssertionError(f"r1: backend (calls, completed) {calls}, expected "
                             f"{want_calls} each with every call completed")
    for i, s in enumerate(grpo_rec.steps):
        st = s["stats"]
        if not (np.isfinite(s["adv"]).all() and np.abs(s["adv"]).max() > 0
                and np.isfinite([st["loss"], st["mean_logp"], st["grad_norm"]]).all()
                and st["grad_norm"] > 0):
            raise AssertionError(f"r1 step {i + 1}: advantages {s['adv']}, stats {st}")
    r1s = grpo_rec.steps
    if not (r1s[1]["rollout"] == r1s[0]["after"] != r1s[0]["before"]):
        raise AssertionError("r1: round 2 did not sample from the trainer's updated tensors")
    dtypes = {t.dtype for t in tree_leaves(res.trainer.params)}
    moved = [s["moved"] for s in grpo_rec.steps]
    # fp32 master weights take rlhf.json's 1e-6 step almost everywhere (bf16
    # weights would round most of it away)
    if dtypes != {torch.float32} or not res.trainer.cfg.remat or min(moved) <= 0.5:
        raise AssertionError(f"r1: weights {dtypes}, remat {res.trainer.cfg.remat}, share "
                             f"of weights each step moved {moved}")
    ckpts = os.listdir(os.path.join(cfg["output_dir"], "checkpoints"))
    ckpt_gib = _gib(os.path.join(cfg["output_dir"], "checkpoints", "2"))
    wavs = os.listdir(os.path.join(cfg["output_dir"], "completion_samples"))
    if ckpts != ["2"] or len(res.checkpoint_seconds) != 1 or not wavs:
        raise AssertionError(f"r1: checkpoints {ckpts}, saves {res.checkpoint_seconds}, "
                             f"{len(wavs)} completion wavs")
    trainer = res.trainer
    log(f"  r1 GRPO RLHF through training.rlhf.main ({R1_STEPS} steps, 1 prompt x "
        f"{G} completions of up to {cfg['rlhf']['max_completion_length']} tokens, the "
        f"update at {trainer.last_batch.tokens.shape[0]} x {trainer.last_batch.tokens.shape[1]}"
        f" tokens, fp32 weights, remat): wall {wall:.1f} s, "
        f"peak torch.cuda.max_memory_allocated {peak:.2f} GiB")
    for i, s in enumerate(grpo_rec.steps):
        st = s["stats"]
        rewards = {k: st[k] for k in ("WERRewardFunc", "DNSMOSRewardFunc",
                                      "SimilarityRewardFunc")}
        secs = {k: st[k + "_seconds"] for k in rewards}
        log(f"  r1 step {i + 1}: rollout {st['rollout_seconds']:.2f} s, {st['decode_steps']} "
            f"decode steps, {1e3 * st['rollout_seconds'] / st['decode_steps']:.2f} ms/step "
            f"(prefill included); completion length {st['completion_len']:.1f}; reward "
            f"seconds " + " ".join(f"{k} {v:.2f}" for k, v in secs.items())
            + f"; update {st['update_seconds']:.3f} s; reward means "
            + " ".join(f"{k} {v:.4f}" for k, v in rewards.items())
            + f" (total {st['reward_mean']:.4f}, std {st['reward_std']:.4f}); advantages "
            + " ".join(f"{a:+.3f}" for a in s["adv"])
            + f"; loss {st['loss']:.6f}, mean logp {st['mean_logp']:.4f}, grad norm "
            f"{st['grad_norm']:.4f}; share of weights the update moved {s['moved']:.4f}")
    busy = ("not measured (the profiler recorded no device time)" if not grpo_rec.busy_ms else
            f"{grpo_rec.busy_ms:.2f} ms busy of its traced wall {grpo_rec.wall_ms:.2f} ms = "
            f"{grpo_rec.busy_ms / grpo_rec.wall_ms:.4f}")
    log(f"  r1 update of step 2, device-busy share (utils/profiling.trace): {busy}; "
        f"checkpoint {ckpt_gib:.2f} GiB in {res.checkpoint_seconds[0]:.2f} s; "
        f"{len(wavs)} completion wavs; backends (calls, completed) {calls}; launches {got}")
    del res, trainer, grpo_rec
    torch.cuda.empty_cache()

    # r1e: one step with the rollouts through the contiguous engine (kernel C)
    path, cfg = write_rlhf_config(os.path.join(R1_DIR, "out_e"),
                                  max_completion_length=R1E_COMPLETION,
                                  constrain_to_speech=True)
    _zero(counters)
    t0 = time.perf_counter()
    res = rlhf_main.main(["--config_path", path, "--dataset_dir", ds, "--model_dir", hf_dir,
                          "--codec_decoder", dec_path, "--total_steps", "1",
                          "--rollout_via_engine", "--device", "cuda", *backend_args[2:]])
    wall_e = time.perf_counter() - t0
    got_e = _counts(counters)
    trainer, st = res.trainer, res.steps[0]
    eng = trainer._engine
    _check_counts("r1e GRPO RLHF, rollouts through the engine", got_e, _want(
        counters, flash_attention=L * (eng._prefill_groups + 2), flash_attention_bwd=L,
        ragged_decode_attention=L * st["decode_steps"]))
    head = llama.slice_logits_head(trainer.params, trainer.cfg, *trainer.sv.generation_window())
    if not (eng.params is trainer.params and trainer.rollout_params is not trainer.params
            and torch.equal(eng._head, head)):
        raise AssertionError("r1e: the engine does not hold the trainer's updated params and "
                             "head window after the step")
    calls_e = {k: (v.calls, v.completed) for k, v in res.backends.items()}
    if calls_e != {"dnsmos_fn": (G, G), "embed_fn": (2 * G, 2 * G)}:
        raise AssertionError(f"r1e: backend (calls, completed) {calls_e}")
    log(f"  r1e one step through the contiguous engine ({R1E_COMPLETION} tokens, "
        f"constrain_to_speech, no Whisper): wall {wall_e:.1f} s, rollout "
        f"{st['rollout_seconds']:.2f} s, "
        f"{st['decode_steps']} decode steps; loss {st['loss']:.6f}, grad norm "
        f"{st['grad_norm']:.4f}; after the step the engine's params and head window are "
        f"the trainer's; backends {calls_e}; launches {got_e}")
    del res, trainer, eng
    shutil.rmtree(R1_DIR)
    torch.cuda.empty_cache()
    return {k: got[k] + got_e[k] for k in got}


# --- host_native: the port's C++ host library -----------------------------------

HOST_ALPHABET = list("<|>s_0123456789 aZ~\n") + ["é", "日", "😀", "Ω"]
HOST_FRAGMENTS = ["<|", "|>", "<|s_", "<|s_0|>", "<|s_7|>", "<|s_65535|>", "<|s_65536|>",
                  "<|s_007|>", "<|s_" + "0" * 31 + "1|>", "<|s_18446744073709551617|>",
                  "<|speech_start|>", "<|eot_id|>", "<||>", "<|s_|>", "<|a|b|>"]
HOST_COUNTS: dict = {}  # each path's native calls, checked where the path ran


class _HostRecorder:
    """Records, under the current phase's ``label``, every text a byte
    tokenizer encodes (with the tokenizer), every text an HF tokenizer
    encodes (r1's prompts, h1's samples), and every (reference, hypothesis)
    pair of a WER or CER reward, for host_native's parity checks."""

    def __init__(self):
        self.label = "setup"
        self.byte_texts, self.hf_texts, self.wer_pairs = [], [], []

    def install(self) -> None:
        from tts_max_tpu_torch.core import hf_tokenizer, tokenization
        from tts_max_tpu_torch.training.rlhf import reward_utils

        rec = self
        byte_encode = tokenization.ByteTokenizer.encode
        hf_encode = hf_tokenizer.HFTokenizer.encode
        wer, cer = reward_utils.word_error_rate, reward_utils.char_error_rate

        def record_byte(tok, text, *a, **kw):
            rec.byte_texts.append((rec.label, tok, text))
            return byte_encode(tok, text, *a, **kw)

        def record_hf(tok, text, *a, **kw):
            rec.hf_texts.append((rec.label, text))
            return hf_encode(tok, text, *a, **kw)

        def record_wer(ref, hyp):
            rec.wer_pairs.append((rec.label, "wer", ref, hyp))
            return wer(ref, hyp)

        def record_cer(ref, hyp):
            rec.wer_pairs.append((rec.label, "cer", ref, hyp))
            return cer(ref, hyp)

        self.patched = [(tokenization.ByteTokenizer, "encode", byte_encode, record_byte),
                        (hf_tokenizer.HFTokenizer, "encode", hf_encode, record_hf),
                        (reward_utils, "word_error_rate", wer, record_wer),
                        (reward_utils, "char_error_rate", cer, record_cer)]
        for owner, name, _, wrap in self.patched:
            setattr(owner, name, wrap)

    def uninstall(self) -> None:
        for owner, name, real, _ in self.patched:
            setattr(owner, name, real)

    def wer_scored(self, label: str) -> int:
        """The WER/CER rewards of phase ``label`` that computed an edit
        distance (a reference with a word, or a character)."""
        return sum(bool(r.split() if how == "wer" else r)
                   for lbl, how, r, _ in self.wer_pairs if lbl == label)


class _FetchCounter:
    """Counts ``TtsFineTuningDataset.__getitem__`` calls that returned (each
    encodes its sample's prompt once before it returns)."""

    def __enter__(self):
        from tts_max_tpu_torch.data import datasets

        self.cls, self.real, self.n = datasets.TtsFineTuningDataset, \
            datasets.TtsFineTuningDataset.__getitem__, 0
        rec = self

        def getitem(ds, idx):
            out = rec.real(ds, idx)
            rec.n += 1
            return out

        self.cls.__getitem__ = getitem
        return self

    def __exit__(self, *exc):
        self.cls.__getitem__ = self.real


def _check_host_counts(label: str, encodes_at_least: int, levenshtein: int = 0) -> None:
    """The native calls since the last ``native.reset_counts()``: at least
    ``encodes_at_least`` encodes, exactly ``levenshtein`` edit distances."""
    from tts_max_tpu_torch import native

    got = native.counts()
    HOST_COUNTS[label] = dict(got, encodes_at_least=encodes_at_least)
    log(f"  {label}: native calls {got} (encodes at least {encodes_at_least}, edit "
        f"distances {levenshtein})")
    if got["encode"] < encodes_at_least or got["levenshtein"] != levenshtein:
        raise AssertionError(f"{label}: native calls {got}, expected at least "
                             f"{encodes_at_least} encodes and {levenshtein} edit distances")


def _median_us(fn, arg_sets, rounds: int = 50) -> float:
    """Median over ``rounds`` of the host µs a call, each round one call on
    each of ``arg_sets``."""
    per = []
    for _ in range(rounds):
        t0 = time.perf_counter_ns()
        for args in arg_sets:
            fn(*args)
        per.append((time.perf_counter_ns() - t0) / 1e3 / len(arg_sets))
    return float(np.median(per))


def host_cpu() -> str:
    """The host CPU as ``/proc/cpuinfo`` gives it (an emulated kernel, such
    as gVisor's, may report its model name as unknown: its vendor, family
    and model then still name it)."""
    with open("/proc/cpuinfo") as f:
        blocks = [dict(line.split(":", 1) for line in b.splitlines() if ":" in line)
                  for b in f.read().strip().split("\n\n")]
    cpu = {k.strip(): v.strip() for k, v in blocks[0].items()}
    return (f"{cpu.get('model name', 'not measured')} ({cpu.get('vendor_id', '?')} family "
            f"{cpu.get('cpu family', '?')} model {cpu.get('model', '?')}, {len(blocks)} "
            f"logical CPUs)")


def run_host_native(rec: _HostRecorder, tok, build_s: float, n_random: int = 3000) -> dict:
    """host_native: the native encode against ``encode_plain`` on every
    text a path encoded (each with its own tokenizer; r1's and h1's HF
    tokenizer texts with ``tok``), on ``n_random`` seeded strings over the
    specials' characters, digits, ASCII and multi-byte UTF-8, and the
    native edit distance against ``edit_distance_plain`` on r1's WER/CER
    pairs and seeded word and character sequences; then the host µs of
    both on an SFT sample and on r1's pairs. Returns the phase's summary."""
    from tts_max_tpu_torch import native
    from tts_max_tpu_torch.training.rlhf import reward_utils

    seen = set()
    checked = collections.Counter()
    for label, t, text in rec.byte_texts + [(lbl, tok, text) for lbl, text in rec.hf_texts]:
        if (id(t), text) in seen:
            continue
        seen.add((id(t), text))
        if t.encode(text) != t.encode_plain(text):
            raise AssertionError(f"host_native: native encode != encode_plain on a text of "
                                 f"{label}: {text[:200]!r}")
        checked[label] += 1
    rng = np.random.default_rng(18)
    for _ in range(n_random):
        parts = [HOST_FRAGMENTS[rng.integers(len(HOST_FRAGMENTS))] if rng.random() < 0.4
                 else "".join(rng.choice(HOST_ALPHABET, rng.integers(0, 7)))
                 for _ in range(rng.integers(0, 13))]
        text = "".join(parts)
        if tok.encode(text) != tok.encode_plain(text):
            raise AssertionError(f"host_native: native encode != encode_plain on {text!r}")
    pairs = [(r.split(), h.split()) if how == "wer" else (list(r), list(h))
             for label, how, r, h in rec.wer_pairs if label.startswith("r1")]
    words = [f"w{i}" for i in range(30)]
    seeded = [([str(w) for w in rng.choice(words, rng.integers(0, 300))],
               [str(w) for w in rng.choice(words, rng.integers(0, 300))]) for _ in range(100)]
    seeded += [(list(rng.choice(HOST_ALPHABET, rng.integers(0, 300))),
                list(rng.choice(HOST_ALPHABET, rng.integers(0, 300)))) for _ in range(100)]
    seeded += [([], []), (["a"], []), ([], ["a"])]
    for r, h in pairs + seeded:
        if native.levenshtein(r, h) != reward_utils.edit_distance_plain(r, h):
            raise AssertionError(f"host_native: levenshtein != edit_distance_plain on "
                                 f"{r[:20]} / {h[:20]}")

    t_sft, text = next((t, x) for label, t, x in rec.byte_texts if label == "SFT path")
    timing_pairs = [p for p in pairs if p[0]] or seeded[:8]
    summary = {
        "counts": HOST_COUNTS,
        "parity": {"texts_by_phase": dict(checked), "random_texts": n_random,
                   "r1_pairs": len(pairs), "seeded_pairs": len(seeded)},
        "encode_per_sft_sample": {
            "native_us": _median_us(t_sft.encode, [(text,)]),
            "plain_us": _median_us(t_sft.encode_plain, [(text,)]),
            "ids": len(t_sft.encode(text))},
        "edit_distance_per_r1_wer": {
            "native_us": _median_us(native.levenshtein, timing_pairs),
            "plain_us": _median_us(reward_utils.edit_distance_plain, timing_pairs),
            "pairs": len(timing_pairs), "from_r1": bool(pairs)},
        "build_s": build_s,
        "host_cpu": host_cpu(),
    }
    log(f"  host_native: parity on {sum(checked.values())} recorded texts "
        f"{dict(checked)}, {n_random} random texts, {len(pairs)} r1 pairs and "
        f"{len(seeded)} seeded pairs; " + json.dumps(summary))
    return summary


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a "
              "CUDA card", file=sys.stderr)
        return 1
    from tts_max_tpu_torch import native
    from tts_max_tpu_torch.core import tokenization
    from tts_max_tpu_torch.device import full_fp32
    from tts_max_tpu_torch.ops import cuda_build
    from tts_max_tpu_torch.ops.act1d import activation1d_kernel
    from tts_max_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from tts_max_tpu_torch.ops.flash_decode import flash_decode_attention
    from tts_max_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_dense,
        paged_decode_attention_dma,
    )
    from tts_max_tpu_torch.ops.quant_matmul import quant_matmul
    from tts_max_tpu_torch.ops.ragged_decode import ragged_decode_attention

    full_fp32()
    t_start = time.perf_counter()

    rec = _HostRecorder()

    def phase(name: str) -> None:
        log(f"[{time.perf_counter() - t_start:.1f} s] {name}")
        rec.label = name

    card = gpu_line()
    log(f"gpu: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; TF32 off for matmul and cuDNN")

    t0 = time.perf_counter()
    cuda_build.build_all()
    log(f"kernel build (nvcc sm_90a, {len(cuda_build.SOURCES)} sources in "
        f"parallel): {time.perf_counter() - t0:.1f} s")
    for name in cuda_build.SOURCES:
        entry = ""
        for line in cuda_build.build_log(name).splitlines():
            if "Compiling entry function" in line:  # e.g. bwd_dkdv_tcILi64E: D = 64
                m = re.search(r"_cu_[0-9a-f]{8}\d+(\w+?)EEv", line)
                entry = m.group(1) if m else ""
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name} {entry}: {line.strip()}")
            # every kernel is sized to fit its registers; a stack frame (sinf's
            # slow path in act1d) is allowed, and logged on the same line
            if "spill" in line and " 0 bytes spill stores, 0 bytes spill loads" not in line:
                raise AssertionError(f"ptxas {name} spills: {line.strip()}")
        counts = sass_counts(cuda_build.library_path(name))
        log(f"  SASS {name}: " + ("not measured (no cuobjdump)" if counts is None else
                                  " ".join(f"{op}={n}" for op, n in counts.items())))
        # the quantized product's multiply-adds and A''s bf16 products run on
        # the tensor cores, A''s operands brought in by cp.async
        if name == "quant_matmul" and not (counts and counts["HMMA"] > 0):
            raise AssertionError(f"quant_matmul: no HMMA in its SASS ({counts})")
        if name == "flash_attention_bwd" and not (counts and counts["HMMA"] > 0
                                                  and counts["LDGSTS"] > 0):
            raise AssertionError(f"flash_attention_bwd: no HMMA or LDGSTS in its SASS "
                                 f"({counts})")

    # the host library, built here by this machine's g++ (a copy of a build
    # directory may hold one from elsewhere)
    native.library_path().unlink(missing_ok=True)
    t0 = time.perf_counter()
    native.get_lib()
    host_build_s = time.perf_counter() - t0
    cxx = subprocess.run([native.CXX, "--version"], check=True, capture_output=True,
                         text=True).stdout.splitlines()[0]
    log(f"host library build ({cxx}, {' '.join(native.CXX_FLAGS)}): {host_build_s:.2f} s, "
        f"{os.path.relpath(native.library_path())}")
    rec.install()

    tok = tokenization.build_byte_tokenizer()
    sv = tokenization.speech_vocab(tok)
    if len(tok) != 65806 or sv.generation_window() != (262, 65542):
        raise AssertionError(f"tokenizer {len(tok)} ids, window "
                             f"{sv.generation_window()}")
    # the main path's shapes for request (c): prompt bucket and a mid-decode length
    from tts_max_tpu_torch.data import normalization

    _, pid, transcript, desc, instruct = REQUESTS[2]
    s_c = prompt_length(tok, normalization.create(), n_prompt_codes(pid), transcript, desc,
                        instruct)
    bucket_c = -(-s_c // 64) * 64

    phase("kernel checks")
    timer = Timer()
    a = check_kernel_a(timer, main_s=bucket_c)
    a_bwd = check_kernel_a_bwd(timer)
    b = check_kernel_b(timer, main_t=bucket_c + 256, main_len=s_c + 128)
    c = check_kernel_c(timer, main_t=bucket_c + 256, main_len=s_c + 128)
    paged = check_paged(timer)
    g = check_kernel_g(timer)
    quant = check_quant(timer)
    del timer
    phase("small-model checks")
    check_small_model(tok, sv)
    check_small_engine(tok, sv)
    check_small_encoder()
    check_small_train()
    check_small_nccl_step()
    check_small_gan()
    check_small_rlhf()
    counters = [flash_attention, flash_attention_bwd, flash_decode_attention,
                ragged_decode_attention, paged_decode_attention_dense,
                paged_decode_attention_dma, paged_decode_attention, activation1d_kernel,
                quant_matmul]
    import shutil

    shutil.rmtree(CHAIN_DIR, ignore_errors=True)
    shutil.rmtree(_q1_dir(), ignore_errors=True)
    chain = _want(counters)

    def add_chain(got):
        for k, v in got.items():
            chain[k] += v

    phase("v1 vectorize")
    ds, got = run_vectorize(counters)
    add_chain(got)
    phase("q1 seeded codec checkpoints")
    q1 = write_seeded_codec_checkpoints()
    phase("SFT path")
    t_tr = time.perf_counter()
    trained, sft_losses = run_training(counters, validation=q1)
    log(f"  SFT path wall {time.perf_counter() - t_tr:.1f} s")
    phase("t1 tensor-parallel SFT")
    t_tp = time.perf_counter()
    for name, n in run_tp_training(counters, sft_losses).items():
        trained[name] += n
    log(f"  t1 wall {time.perf_counter() - t_tp:.1f} s")
    phase("g1 codec GAN")
    add_chain(run_gan(ds, q1[0], counters))
    phase("c1 convert and serve")
    hf_dir, got, trained_params = run_convert_and_serve(os.path.join(TRAIN_DIR, "out"),
                                                        counters)
    add_chain(got)
    shutil.rmtree(TRAIN_DIR)
    phase("d1 distill")
    draft_dir, got = run_distill(hf_dir, ds, counters)
    add_chain(got)
    phase("sp3 speculative with the distilled draft")
    sp3, got = run_sp3(tok, sv, hf_dir, draft_dir, counters)
    add_chain(got)
    phase("r1 GRPO RLHF and r1e through the engine")
    add_chain(run_rlhf(hf_dir, ds, q1[0], counters, rec))
    shutil.rmtree(os.path.dirname(q1[0]))  # the codec checkpoints
    shutil.rmtree(CHAIN_DIR)
    phase("synthesis path")
    model, params, cfg, codec, launches = run_main_path(tok, sv, counters)
    for name, n in trained.items():
        launches[name] += n
    phase("l1 LoRA step")
    add_chain(run_lora_step(params, cfg, counters))
    phase("q1 random phrases")
    add_chain(run_random_phrases(tok, sv, model, codec, trained_params, q1[2], counters))
    del trained_params
    phase("qq quant quality")
    add_chain(run_quant_quality(counters))
    for name, n in chain.items():
        launches[name] += n
    phase("engines")
    for name, n in run_engines(tok, sv, params, cfg, codec.encoder, model._audio_decoder,
                               counters).items():
        launches[name] += n
    phase("e-tp engines and generate with a tensor-parallel mesh")
    for name, n in run_tp_serving(tok, sv, params, cfg, codec.encoder, model._audio_decoder,
                                  counters).items():
        launches[name] += n
    phase("speculative decoding")
    log("speculative decoding: Llama-3.2-1B target, window (262, 65542)")
    t_sp = time.perf_counter()
    for name, n in run_speculative(tok, sv, params, cfg, codec.encoder, counters,
                                   sp3=sp3).items():
        launches[name] += n
    log(f"  sp1 + sp2 wall {time.perf_counter() - t_sp:.1f} s")
    phase("serving CLIs")
    for name, n in run_serving(tok, sv, params, cfg, counters).items():
        launches[name] += n
    phase("h1 SFT from an HF directory")
    for name, n in run_hf_sft(os.path.join(SERVING_DIR, "model"), counters).items():
        launches[name] += n
    shutil.rmtree(SERVING_DIR)
    rec.uninstall()
    phase("host_native")
    host = run_host_native(rec, tok, host_build_s)
    phase("done")
    log(f"launch counts summed over the main paths: {launches}")

    def row(fn, source, replaces, numbers):
        return dict(name=fn.__name__, route="cuda", source=f"tts_max_tpu_torch/csrc/{source}",
                    replaces=replaces, launches=launches[fn.__name__], **numbers)

    kernels = [
        row(flash_attention, "flash_attention.cu", "tts_max_tpu/ops/pallas_attention.py:79",
            a),
        row(flash_attention_bwd, "flash_attention_bwd.cu",
            "tts_max_tpu/ops/pallas_attention.py:118 (and tts_max_tpu/ops/attention.py:88)",
            a_bwd),
        row(flash_decode_attention, "flash_decode.cu", "tts_max_tpu/ops/pallas_decode.py:363",
            b),
        row(ragged_decode_attention, "ragged_decode.cu",
            "tts_max_tpu/ops/pallas_decode.py:104", c),
        row(paged_decode_attention_dense, "paged_decode.cu",
            "tts_max_tpu/ops/paged_attention.py:536", paged["D"]),
        row(paged_decode_attention_dma, "paged_decode.cu",
            "tts_max_tpu/ops/paged_attention.py:246", paged["E"]),
        row(paged_decode_attention, "paged_decode.cu",
            "tts_max_tpu/ops/paged_attention.py:663", paged["F"]),
        row(activation1d_kernel, "act1d.cu", "tts_max_tpu/ops/pallas_act1d.py:137", g),
        row(quant_matmul, "quant_matmul.cu", "tts_max_tpu/models/quantization.py:256", quant),
    ]
    print(json.dumps({"host_native": dict(host, card=card)}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
