"""KV-cached autoregressive generation (counterpart of
``tts_max_tpu/inference/generate.py``).

One preallocated cache of ``cache_len`` rows, a prefill, then a decode loop
that samples a token, writes its K/V rows in place and stops when every row
has emitted EOS or ``max_new_tokens`` are out. The JAX package stages the
cache and batches cache writes (delta-KV) to keep XLA from copying a
loop-carried cache; here the cache is updated in place, so neither is
needed, and greedy ids match the JAX loop with or without its delta-KV.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from tts_max_tpu_torch.device import resolve_device
from tts_max_tpu_torch.models import llama
from tts_max_tpu_torch.ops import sampling


class GenerateResult(NamedTuple):
    tokens: torch.Tensor  # [B, max_new_tokens] int32 ids (pad after EOS)
    num_generated: torch.Tensor  # [B] int32 tokens generated incl. EOS
    steps: int  # decode iterations executed (= decode_step calls)
    prefill_time: float  # seconds, host clock, device synchronized
    decode_time: float  # seconds, host clock, device synchronized


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def generate(
    params,
    cfg: llama.LlamaConfig,
    prompt_tokens,
    prompt_lengths,
    generator: torch.Generator | None,
    *,
    sp: sampling.SamplingParams,
    max_new_tokens: int,
    eos_id: int,
    pad_id: int = 0,
    cache_len: int | None = None,
    quantized_kv: bool = False,
    vocab_window: tuple[int, int] | None = None,
    min_new_tokens: int = 0,
    device="cuda",
) -> GenerateResult:
    """prompt_tokens: right-padded [B, S]; prompt_lengths: [B]; returns the
    generated tokens only.

    ``vocab_window=(lo, size)`` constrains generation to token ids
    [lo, lo+size): logits cover only those head rows, sampling and the
    penalty counts run in window space, emitted ids stay global.
    ``eos_id`` must lie inside the window (or be unreachable).
    ``min_new_tokens`` bans EOS until that many tokens are out.
    ``quantized_kv`` stores the cache as per-(token, head) int8.
    ``generator`` draws the samples (unused when ``sp.temperature <= 0``).
    """
    dev = resolve_device(device)
    if params["embed"]["embedding"].device != dev:
        raise ValueError(f"params live on {params['embed']['embedding'].device}, "
                         f"not on {dev}")
    tokens = torch.as_tensor(prompt_tokens, device=dev).to(torch.int32)
    # a copy: the loop advances lengths in place
    lengths = torch.as_tensor(prompt_lengths, device=dev).to(torch.int32, copy=True)
    b, s = tokens.shape
    cache_len = cache_len or (s + max_new_tokens)
    if cache_len < s + max_new_tokens:
        raise ValueError("cache_len too small for prompt + max_new_tokens")

    t0 = time.perf_counter()
    lo = vocab_window[0] if vocab_window else 0
    n_vocab = vocab_window[1] if vocab_window else cfg.vocab_size
    head = llama.slice_logits_head(params, cfg, *vocab_window) if vocab_window else None
    cache = llama.init_kv_cache(cfg, b, cache_len, quantized=quantized_kv, device=dev)
    logits, cache = llama.prefill(params, cfg, tokens, lengths, cache, logits_head=head)
    prompt_mask = torch.arange(s, device=dev)[None, :] < lengths[:, None]
    if vocab_window:
        token_counts = sampling.counts_from_tokens_windowed(tokens, prompt_mask,
                                                            vocab_window)
    else:
        token_counts = sampling.counts_from_tokens(tokens, prompt_mask, cfg.vocab_size)
    gen_counts = torch.zeros_like(token_counts)
    _sync(dev)
    t1 = time.perf_counter()

    eos_w = eos_id - lo  # window-space EOS column (may be out of range)
    block_eos = min_new_tokens > 0 and 0 <= eos_w < n_vocab
    rows = torch.arange(b, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    out = torch.full((b, max_new_tokens), pad_id, dtype=torch.int32, device=dev)
    n_gen = torch.zeros(b, dtype=torch.int32, device=dev)
    steps = 0
    while steps < max_new_tokens:
        if block_eos:
            logits[:, eos_w] = torch.where(
                n_gen < min_new_tokens, float("-inf"), logits[:, eos_w]
            )
        tok_w = sampling.sample_token(generator, logits, sp, token_counts, gen_counts)
        tok = torch.where(done, pad_id, tok_w + lo).to(torch.int32)
        newly_done = tok == eos_id
        out[:, steps] = tok
        inc = (~done).to(torch.int32)
        n_gen += inc
        idx = torch.where(done, 0, tok_w)  # in range; inc is 0 when done
        token_counts.index_put_((rows, idx), inc, accumulate=True)
        gen_counts.index_put_((rows, idx), inc, accumulate=True)
        logits, cache = llama.decode_step(params, cfg, cache, tok, lengths,
                                          logits_head=head)
        lengths += inc
        done |= newly_done
        steps += 1
        if bool(done.all()):
            break
    _sync(dev)
    return GenerateResult(tokens=out, num_generated=n_gen, steps=steps,
                          prefill_time=t1 - t0, decode_time=time.perf_counter() - t1)


def make_generate_fn(cfg, sp, max_new_tokens, eos_id, pad_id=0, cache_len=None,
                     quantized_kv=False, vocab_window=None, min_new_tokens=0,
                     device="cuda"):
    """``fn(params, prompt_tokens, prompt_lengths, generator)`` with every
    other argument of ``generate`` fixed."""

    def fn(params, prompt_tokens, prompt_lengths, generator):
        return generate(
            params, cfg, prompt_tokens, prompt_lengths, generator, sp=sp,
            max_new_tokens=max_new_tokens, eos_id=eos_id, pad_id=pad_id,
            cache_len=cache_len, quantized_kv=quantized_kv,
            vocab_window=vocab_window, min_new_tokens=min_new_tokens, device=device,
        )

    return fn
