#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

From the root of a checkout, with one CUDA card. It builds the port's CUDA
kernels from ``tts_max_tpu_torch/csrc`` with nvcc, holds each against its
plain PyTorch version on the card, checks the port's GPU path against its
CPU path on a small model, then drives the main path — text to waveform
through ``LocalTtsModel.synthesize_speech`` at the full width of
Llama-3.2-1B and the full Vocos decoder, random weights from a seed — and
checks with launch counters that every prefill and decode step went
through the kernels. The next-to-last line is a JSON summary of the kernels
and the last line ``{"ok": true, "device": {...}}``. Any failed check
raises, so the run ends with a nonzero exit and no result line. Without a
CUDA card it exits 1 at once. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

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


def attention_bound_ms(b, s, hq, hkv, d, dtype, kv_len=None) -> tuple[float, str]:
    """Least time for causal attention: 4 * Hq * D FLOPs per (query, key)
    pair with key <= query < S and key < kv_len, against the bytes of q, k,
    v read once and the output written once."""
    kv_len = s if kv_len is None else kv_len
    pairs = sum(min(i + 1, kv_len) for i in range(s))
    flops = 4.0 * b * hq * d * pairs
    nbytes = (2 * b * s * hq * d + 2 * b * s * hkv * d) * torch.finfo(dtype).bits // 8
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def check_kernel_a(timer: Timer, cases, main_s: int) -> dict:
    from tts_max_tpu_torch.ops import attention
    from tts_max_tpu_torch.ops.flash_attention import flash_attention

    log("kernel A: flash_attention vs ops.attention.causal_attention "
        "(plain, fp32 math, TF32 off); library = F.scaled_dot_product_attention")
    worst, main = 0.0, None
    gen = torch.Generator(device="cuda").manual_seed(1)
    for (s, d, dtype) in list(cases) + [(main_s, 64, torch.bfloat16)]:
        b, hq, hkv = 1, 32, 8
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
                   for h in (hq, hkv, hkv))
        out = flash_attention(q, k, v, causal=True)
        ref = attention.causal_attention(q, k, v)
        err, tol = check_close(out, ref, f"kernel A S={s} D={d} {dtype}")
        worst = max(worst, err)
        ms = timer.ms(lambda: flash_attention(q, k, v, causal=True))
        plain_ms = timer.ms(lambda: attention.causal_attention(q, k, v), iters=5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = timer.ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        bound, by = attention_bound_ms(b, s, hq, hkv, d, dtype)
        log(f"  S={s:5d} D={d:3d} {str(dtype):14s} max_abs_err={err:.3e} "
            f"({tol})  ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={bound:.4f} ({by})")
        main = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                    bound_by=by)
    return dict(max_abs_err=worst, **main)


# --- kernel B -----------------------------------------------------------------


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


def _decode_inputs(gen, b, t, d, lengths, quant, nan_tail):
    from tts_max_tpu_torch.models.llama import _quantize_kv

    hq, hkv = 32, 8
    q = torch.randn(b, hq, d, generator=gen, device="cuda").to(torch.bfloat16)
    kv = [torch.randn(b, t, hkv, d, generator=gen, device="cuda").to(torch.bfloat16)
          for _ in range(2)]
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    if quant:
        kv = [_quantize_kv(x) for x in kv]
    if nan_tail:
        dead = torch.arange(t, device="cuda")[None, :] >= lens[:, None]
        for c in kv:
            if quant:
                c["scale"][dead] = float("nan")
            else:
                c[dead] = float("nan")
    return q, kv[0], kv[1], lens


def check_kernel_b(timer: Timer, main_t: int, main_len: int) -> dict:
    from tts_max_tpu_torch.ops import attention
    from tts_max_tpu_torch.ops.flash_decode import flash_decode_attention

    log("kernel B: flash_decode_attention vs ops.attention.decode_attention "
        "(plain); library = F.scaled_dot_product_attention with a length mask "
        "(bf16 cache only)")
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = []
    for b in (1, 8):
        for t in (256, 2048):
            lens = [t] if b == 1 else [1, t, 7, t // 2, t - 1, 100, 33, t // 3]
            for quant in (False, True):
                cases.append((b, t, 64, lens, quant, False))
    ragged = [1, 2048, 7, 1024, 2047, 100, 33, 682]
    for d in (64, 128):  # 128: Llama-3.1-8B's head_dim
        for quant in (False, True):
            cases.append((8, 2048, d, ragged, quant, True))
    cases.append((1, main_t, 64, [main_len], False, False))  # the main path's shape
    worst, main = 0.0, None
    for (b, t, d, lens, quant, nan_tail) in cases:
        q, kc, vc, lengths = _decode_inputs(gen, b, t, d, lens, quant, nan_tail)
        out = flash_decode_attention(q, kc, vc, lengths)
        ref = attention.decode_attention(q, kc, vc, lengths)
        err, tol = check_close(out, ref, f"kernel B B={b} T={t} D={d} quant={quant} "
                                         f"nan_tail={nan_tail}")
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
        log(f"  B={b} T={t:5d} D={d:3d} {'int8' if quant else 'bf16'} "
            f"{'NaN-tail ' if nan_tail else ''}max_abs_err={err:.3e} "
            f"({tol})  ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib} bound_ms={bound:.5f} ({by})")
        main = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                    bound_by=by)
    return dict(max_abs_err=worst, **main)


# --- the GPU path against the CPU path on a small model -----------------------


def check_small_model(tok, sv) -> None:
    """fp32 greedy decode of a small random model: the CPU path (plain
    versions) picks the tokens; the GPU path (kernels) is fed the same
    tokens and its logits must agree at every step."""
    from tts_max_tpu_torch import convert
    from tts_max_tpu_torch.inference.generate import generate
    from tts_max_tpu_torch.models import llama
    from tts_max_tpu_torch.models.codec import vocos
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


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_numpy_tree(v) for v in t]
    return t.numpy()


# --- the main path --------------------------------------------------------------


class StubEncoder:
    """Seeded prompt codes per prompt id, in place of the audio encoder
    (not ported yet)."""

    sample_rate = 16000
    token_rate = 50

    def __init__(self, lengths: dict[str, int]):
        rng = np.random.default_rng(7)
        self.codes = {pid: rng.integers(0, 65536, n) for pid, n in lengths.items()}

    def encode(self, prompt_id, wav):
        return self.codes[prompt_id]


REQUESTS = [
    # (name, prompt id, transcript, voice description, enable_instruction)
    ("a voice description", "none", "", "a calm narrator with a low voice", False),
    ("b 250 prompt codes", "p250", "This is the reference speech.", "", True),
    ("c 1100 prompt codes", "p1100", "A much longer reference recording.", "", True),
]
TEXT = "The quick brown fox jumps over the lazy dog near the riverbank."


def prompt_length(tok, normalizer, n_codes, transcript, description, instruct):
    from tts_max_tpu_torch.core import prompting

    text = normalizer.normalize(TEXT)
    prompt = prompting.compile_inference_prompt(
        transcript, text, list(range(n_codes)), description, instruct)
    return len(tok.encode(prompt, add_special_tokens=True))


def build_main_path(tok, sv):
    """The main path's model: Llama-3.2-1B geometry and the default Vocos
    decoder with random weights from fixed seeds, and the stub encoder of
    ``REQUESTS``. Returns (model, params, cfg, encoder). Also used by
    tools/profile_torch_synthesis.py."""
    from tts_max_tpu_torch.inference.synthesize import LocalTtsModel
    from tts_max_tpu_torch.models import llama
    from tts_max_tpu_torch.models.codec import api, vocos

    cfg = llama.llama32_1b_config()
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=0, device="cuda")
    vcfg = vocos.VocosConfig()
    decoder = api.AudioDecoder(vocos.init_decoder(vcfg, seed=1, device="cuda"),
                               vcfg, api.DecoderConfig(), device="cuda")
    torch.cuda.synchronize()
    log(f"main path: llama32_1b_config (vocab {cfg.vocab_size}, {cfg.n_layers} "
        f"layers, dim {cfg.dim}, {cfg.n_heads}/{cfg.n_kv_heads} heads, head_dim "
        f"{cfg.head_dim}, {cfg.dtype}) + VocosConfig (hidden {vcfg.hidden_dim}, "
        f"depth {vcfg.depth}, vq_dim {vcfg.vq_dim}, hop {vcfg.hop_length}); "
        f"random weights in {time.perf_counter() - t0:.2f} s")
    encoder = StubEncoder({"p250": 250, "p1100": 1100})
    model = LocalTtsModel(params, cfg, tok, sv, encoder, decoder, device="cuda")
    return model, params, cfg, encoder


def synthesize(model, settings, request):
    _, pid, transcript, desc, instruct = request
    return model.synthesize_speech(settings, TEXT, pid, np.zeros(16000, np.float32),
                                   transcript, voice_description=desc,
                                   enable_instruction=instruct)


def run_main_path(tok, sv, counters) -> None:
    from tts_max_tpu_torch.data import normalization
    from tts_max_tpu_torch.inference.generate import generate
    from tts_max_tpu_torch.inference.synthesize import InferenceSettings
    from tts_max_tpu_torch.ops.sampling import SamplingParams

    model, params, cfg, encoder = build_main_path(tok, sv)
    settings = InferenceSettings(max_tokens=256)

    for c in counters:
        c.launches = 0
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
        n_codes = len(encoder.codes.get(pid, []))
        s = prompt_length(tok, normalization.create(), n_codes, transcript, desc, instruct)
        audio_s = wav.shape[1] / 16000
        log(f"  request {name}: prompt {s} tokens, prefill "
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

    want = {"flash_attention": cfg.n_layers * prefills,
            "flash_decode_attention": cfg.n_layers * steps}
    got = {c.__name__: c.launches for c in counters}
    log(f"launch counts over the main path: {got} (expected {want})")
    if got != want:
        raise AssertionError(f"launch counts {got} != expected {want}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a "
              "CUDA card", file=sys.stderr)
        return 1
    from tts_max_tpu_torch.core import tokenization
    from tts_max_tpu_torch.ops import cuda_build
    from tts_max_tpu_torch.ops.flash_attention import flash_attention
    from tts_max_tpu_torch.ops.flash_decode import flash_decode_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    log(f"gpu: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; TF32 off for matmul and cuDNN")

    t0 = time.perf_counter()
    cuda_build.build_all()
    log(f"kernel build (nvcc sm_90a, {len(cuda_build.SOURCES)} sources in "
        f"parallel): {time.perf_counter() - t0:.1f} s")
    for name in cuda_build.SOURCES:
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    tok = tokenization.build_byte_tokenizer()
    sv = tokenization.speech_vocab(tok)
    if len(tok) != 65806 or sv.generation_window() != (262, 65542):
        raise AssertionError(f"tokenizer {len(tok)} ids, window "
                             f"{sv.generation_window()}")
    # the main path's shapes for request (c): prompt bucket and a mid-decode length
    from tts_max_tpu_torch.data import normalization

    _, pid, transcript, desc, instruct = REQUESTS[2]
    s_c = prompt_length(tok, normalization.create(), 1100, transcript, desc, instruct)
    bucket_c = -(-s_c // 64) * 64

    timer = Timer()
    a = check_kernel_a(timer, [(137, 64, torch.bfloat16), (1024, 64, torch.bfloat16),
                               (2048, 64, torch.bfloat16), (1024, 128, torch.bfloat16),
                               (1024, 64, torch.float32)], main_s=bucket_c)
    b = check_kernel_b(timer, main_t=bucket_c + 256, main_len=s_c + 128)
    del timer
    check_small_model(tok, sv)
    run_main_path(tok, sv, [flash_attention, flash_decode_attention])

    kernels = [
        dict(name="flash_attention", route="cuda",
             source="tts_max_tpu_torch/csrc/flash_attention.cu",
             replaces="tts_max_tpu/ops/pallas_attention.py:79",
             launches=flash_attention.launches, **a),
        dict(name="flash_decode_attention", route="cuda",
             source="tts_max_tpu_torch/csrc/flash_decode.cu",
             replaces="tts_max_tpu/ops/pallas_decode.py:363",
             launches=flash_decode_attention.launches, **b),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
