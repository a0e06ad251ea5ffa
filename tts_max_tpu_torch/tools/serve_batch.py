"""Batch TTS serving CLI over the continuous-batching engine (counterpart of
``tools/serve_batch.py``).

A JSONL of requests drives the port's ``InferenceEngine`` (contiguous KV,
decode attention through kernel C; the default) or ``PagedInferenceEngine``
(block pool with prefix caching, the paged kernel): mid-flight admission,
per-request sampling, speech-window constrained decode. Every completion is
vocoded to a 16 kHz wav.

Request JSONL fields (one object per line):
  text                 (required) text to synthesize
  prompt_wav           optional voice-prompt wav path
  prompt_transcript    transcript of the voice prompt
  voice_description    optional voice description
  language             optional language tag for text normalization
  temperature/top_k/top_p/repetition_penalty/frequency_penalty/max_tokens/
  min_tokens           optional per-request overrides
  output               optional wav path (default <out_dir>/req_<i>.wav)

Runs on the card unless ``--device cpu`` is given:

  python -m tts_max_tpu_torch.tools.serve_batch --model_dir serving \\
      --requests reqs.jsonl --out_dir wavs [--engine contiguous|paged] \\
      [--max_batch 8] [--max_len 2048] [--steps_per_dispatch 0] [--block_size 64] \\
      [--quantized_kv] [--no_prefix_cache] [--no_constrain] [--no_warmup] \\
      [--admission_policy fifo|shortest] [--max_tokens 1792] [--seed 42] \\
      [--prefill_ahead] [--park_rows 0] [--park_len 0] [--park_groups_per_poll 0] \\
      [--codec_decoder dec.pt --codec_encoder enc.pt] \\
      [--quantize [int8|int4|int4-g64|int4-g128]] [--dtype bfloat16] [--device cuda]

``--quantize`` and pre-quantized dirs as in ``serving_inference``.
``--prefill_ahead`` prefills queued requests into a park buffer while the
pool is full and emits their first token at once (the engine's
``prefill_ahead``); with it ``--steps_per_dispatch 0`` means 32, else 16.

Not taken (it fails in argparse): ``--no_staged_cache`` (the port's decode
kernels follow each slot's length, so it has no staged cache to turn off).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from tts_max_tpu_torch.core import prompting
from tts_max_tpu_torch.core.constants import CODEC_SAMPLE_RATE, CODEC_TOKEN_RATE
from tts_max_tpu_torch.core.tokenization import build_byte_tokenizer, speech_vocab
from tts_max_tpu_torch.data import normalization
from tts_max_tpu_torch.data.audio_io import load_wav, save_wav
from tts_max_tpu_torch.inference.engine import InferenceEngine, PagedInferenceEngine
from tts_max_tpu_torch.ops.sampling import SamplingParams, sampling_from_overrides
from tts_max_tpu_torch.tools.serving_inference import add_model_args, build_codec, load_model
from tts_max_tpu_torch.utils.logging import get_logger, setup_logging

log = get_logger("serve_batch")

# What --steps_per_dispatch 0 means: the reference's auto values, without
# and with --prefill_ahead
AUTO_STEPS_PER_DISPATCH = 16
AUTO_STEPS_PER_DISPATCH_PARKED = 32


def add_engine_args(parser: argparse.ArgumentParser) -> None:
    """The engine flags ``serve_batch`` and ``serve_http`` share."""
    parser.add_argument("--engine", choices=["contiguous", "paged"], default="contiguous",
                        help="KV layout: 'contiguous' (decode through kernel C) or "
                             "'paged' (block pool, prefix cache)")
    parser.add_argument("--max_batch", type=int, default=8)
    parser.add_argument("--max_len", type=int, default=2048)
    parser.add_argument("--block_size", type=int, default=64)
    parser.add_argument("--max_tokens", type=int, default=1792)
    parser.add_argument("--quantized_kv", action="store_true")
    parser.add_argument("--no_constrain", action="store_true",
                        help="disable the speech-window sampling constraint")
    parser.add_argument("--steps_per_dispatch", type=int, default=0,
                        help="lockstep decode steps per dispatch (one host sync each); "
                             f"0 = auto ({AUTO_STEPS_PER_DISPATCH}; "
                             f"{AUTO_STEPS_PER_DISPATCH_PARKED} with --prefill_ahead)")
    parser.add_argument("--admission_policy", choices=["fifo", "shortest"], default="fifo")
    parser.add_argument("--prefill_ahead", action="store_true",
                        help="while the pool is full, prefill queued requests ahead of "
                             "slot availability (park buffer) and emit their first token "
                             "at once: cuts TTFT; costs the park buffer's memory")
    parser.add_argument("--park_rows", type=int, default=0,
                        help="prefill-ahead park rows (0 = max_batch); size to the "
                             "expected queue depth for the lowest TTFT")
    parser.add_argument("--park_len", type=int, default=0,
                        help="park buffer token capacity (0 = min(512, max_len))")
    parser.add_argument("--park_groups_per_poll", type=int, default=0,
                        help="throttle parking (0 = park the whole eligible queue at once)")
    parser.add_argument("--no_warmup", action="store_true",
                        help="skip the startup warmup (kernel build, one prefill per "
                             "bucket, one decode dispatch)")


def build_engine(args, params, cfg, sv, prefix_cache: bool):
    """The engine ``args.engine`` names on ``args.device``, warmed up unless
    ``--no_warmup``."""
    window = None if args.no_constrain else sv.generation_window()
    if window and window[0] + window[1] > cfg.vocab_size:
        log.warning("speech window %s exceeds model vocab %d; disabling the constraint",
                    window, cfg.vocab_size)
        window = None
    kw = dict(max_batch=args.max_batch, max_len=args.max_len,
              quantized_kv=args.quantized_kv, vocab_window=window,
              steps_per_dispatch=args.steps_per_dispatch or (
                  AUTO_STEPS_PER_DISPATCH_PARKED if args.prefill_ahead
                  else AUTO_STEPS_PER_DISPATCH),
              admission_policy=args.admission_policy, prefill_ahead=args.prefill_ahead,
              park_rows=args.park_rows or None, park_len=args.park_len or None,
              park_groups_per_poll=args.park_groups_per_poll, device=args.device)
    if args.engine == "paged":
        engine = PagedInferenceEngine(params, cfg, block_size=args.block_size,
                                      enable_prefix_cache=prefix_cache, **kw)
    else:
        engine = InferenceEngine(params, cfg, **kw)
    if not args.no_warmup:
        t_w = time.perf_counter()
        engine.warmup()
        log.info("Warmup done in %.1fs", time.perf_counter() - t_w)
    return engine


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(allow_abbrev=False)
    add_model_args(parser)
    add_engine_args(parser)
    parser.add_argument("--requests", required=True, help="JSONL of requests")
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--no_prefix_cache", action="store_true")
    parser.add_argument("--seed", type=int, default=42)
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Serve the JSONL; returns {"completions", "engine", "outputs" (request
    index -> wav path), "load_s", "gen_s", "ttft_s" (per completion, host
    clock from the first submit)}."""
    args = parse_args(argv)
    setup_logging(0)
    os.makedirs(args.out_dir, exist_ok=True)

    tokenizer = build_byte_tokenizer()
    sv = speech_vocab(tokenizer)
    params, cfg, load_s = load_model(args)
    encoder, decoder = build_codec(args)
    if args.engine == "contiguous" and not args.no_prefix_cache:
        log.info("contiguous engine: prefix caching is paged-only "
                 "(shared voice prompts re-prefill each time)")
    engine = build_engine(args, params, cfg, sv, prefix_cache=not args.no_prefix_cache)

    with open(args.requests) as f:
        requests = [json.loads(line) for line in f if line.strip()]
    normalizer = normalization.create()
    meta: dict[int, dict] = {}
    t0 = time.perf_counter()
    for i, req in enumerate(requests):
        speech_ids: list[int] = []
        if req.get("prompt_wav"):
            wav, _ = load_wav(req["prompt_wav"], CODEC_SAMPLE_RATE)
            speech_ids = np.asarray(encoder.encode(req["prompt_wav"], wav)).ravel().tolist()
        text = normalizer.normalize(req["text"], req.get("language") or None)
        prompt = prompting.compile_inference_prompt(
            req.get("prompt_transcript", ""), text, speech_ids,
            req.get("voice_description", ""), True)
        input_ids = np.asarray(tokenizer.encode(prompt, add_special_tokens=True), np.int32)
        budget = min(args.max_tokens, req.get("max_tokens", args.max_tokens),
                     args.max_len - len(input_ids))
        if budget <= 0:
            # one oversized request must not abort the whole batch: skip it
            log.warning("request %d skipped: prompt %d tokens leaves no budget within "
                        "max_len %d", i, len(input_ids), args.max_len)
            continue
        rid = engine.submit(input_ids, max_new_tokens=budget, eos_id=sv.speech_end_id,
                            sampling_seed=args.seed + i,
                            sampling=sampling_from_overrides(req, SamplingParams()),
                            min_tokens=req.get("min_tokens", 0))
        meta[rid] = {"idx": i, "speech_ids": speech_ids,
                     "output": req.get("output", f"{args.out_dir}/req_{i}.wav")}

    completions = engine.run()
    gen_s = time.perf_counter() - t0
    total_tokens = sum(len(c.tokens) for c in completions)
    ttft_s = [c.first_token_time - t0 for c in completions]
    log.info("Generated %d completions, %d tokens in %.2fs (%.1f tok/s), TTFT p50 %.1f ms",
             len(completions), total_tokens, gen_s, total_tokens / gen_s,
             1e3 * float(np.median(ttft_s)) if ttft_s else float("nan"))
    if isinstance(engine, PagedInferenceEngine):
        log.info("prefix cache: %d block hits / %d misses", engine.prefix_cache_hits,
                 engine.prefix_cache_misses)

    outputs: dict[int, str] = {}
    for c in completions:
        m = meta[c.request_id]
        all_codes = np.concatenate([np.asarray(m["speech_ids"], dtype=np.int64),
                                    sv.codes_from_tokens(np.asarray(c.tokens))])
        if len(all_codes) == 0:
            log.warning("request %d produced no speech tokens", m["idx"])
            continue
        wav = decoder.decode(all_codes)
        skip = int(len(m["speech_ids"]) / CODEC_TOKEN_RATE * CODEC_SAMPLE_RATE)
        save_wav(m["output"], wav[:, skip:], CODEC_SAMPLE_RATE)
        outputs[m["idx"]] = m["output"]
        log.info("Wrote %s (%.2fs audio)", m["output"], (wav.shape[1] - skip) / CODEC_SAMPLE_RATE)
    return {"completions": completions, "engine": engine, "outputs": outputs,
            "load_s": load_s, "gen_s": gen_s, "ttft_s": ttft_s}


if __name__ == "__main__":
    main()
