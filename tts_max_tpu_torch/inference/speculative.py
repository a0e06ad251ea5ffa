"""Speculative decoding (counterpart of
``tts_max_tpu/inference/speculative.py``): a small draft SpeechLM proposes
``gamma`` tokens one step at a time (``llama.decode_step``, kernel B), the
target scores the whole window in one ``llama.decode_window`` forward
(plain torch ``window_attention``, as XLA computes it in the JAX package),
and rejection sampling (Leviathan et al., arXiv 2211.17192) keeps the output
distribution exactly the target's sampling distribution:

- candidate d_j is accepted with probability min(1, p_j(d_j) / q_j(d_j));
- the first rejection resamples from normalize(max(p_j - q_j, 0));
- when all ``gamma`` are accepted, a bonus token comes from the target's
  distribution at the next position.

p and q are the distributions after penalties, temperature, top-k and top-p
(``ops.sampling.sampling_distribution``), with the count state replayed
alike on both sides. With temperature 0 it is exact prefix matching, and the
ids equal greedy ``generate`` on the target.

Each round is one iteration of a Python loop, which reads ``all(done)`` from
the card once. The draft first re-processes the previous round's last
accepted token (its K/V row may be missing after an all-accept round;
rewriting a row is idempotent). Rows past a sequence's committed length hold
garbage that later rounds overwrite (attention masks by position). A
finished row's state is frozen, and its writes go to the first rows of its
own cache, which nothing reads again.
"""

from __future__ import annotations

import time

import torch

from tts_max_tpu_torch.device import resolve_device
from tts_max_tpu_torch.inference.generate import GenerateResult, _sync
from tts_max_tpu_torch.models import llama
from tts_max_tpu_torch.ops import sampling
from tts_max_tpu_torch.ops.sampling import SamplingParams


def _count(counts: torch.Tensor, rows: torch.Tensor, toks: torch.Tensor, inc) -> None:
    counts.index_put_((rows, toks.long()), inc, accumulate=True)


@torch.inference_mode()
def speculative_generate(
    target_params,
    target_cfg: llama.LlamaConfig,
    draft_params,
    draft_cfg: llama.LlamaConfig,
    prompt_tokens,
    prompt_lengths,
    generator: torch.Generator | None,
    *,
    sp: SamplingParams,
    max_new_tokens: int,
    eos_id: int,
    gamma: int = 4,
    pad_id: int = 0,
    cache_len: int | None = None,
    quantized_kv: bool = False,
    vocab_window: tuple[int, int] | None = None,
    device="cuda",
) -> GenerateResult:
    """prompt_tokens: right-padded [B, S]; prompt_lengths: [B]. Returns the
    generated tokens, distributed as plain ``generate`` on the target;
    ``steps`` is the number of verify rounds (tokens per round is the
    speed-up). ``generator`` draws every sample on ``device`` (unused when
    ``sp.temperature <= 0``).

    ``vocab_window=(lo, size)`` constrains both models' sampling to the
    window: the p and q tensors and both heads shrink to its size, token
    variables live in window space, and ``+ lo`` converts them at the model
    inputs and the output. ``quantized_kv`` stores both caches as int8. Both
    models' params must live on ``device``; quantized params (the
    ``models/quantization.py`` format) run as in ``generate``."""
    if target_cfg.vocab_size != draft_cfg.vocab_size:
        raise ValueError("draft and target must share the vocabulary")
    dev = resolve_device(device)
    for name, p in (("target", target_params), ("draft", draft_params)):
        if llama.params_device(p) != dev:
            raise ValueError(f"{name} params live on {llama.params_device(p)}, not on {dev}")
    tokens = torch.as_tensor(prompt_tokens, device=dev).to(torch.int32)
    lengths = torch.as_tensor(prompt_lengths, device=dev).to(torch.int32, copy=True)
    b, s = tokens.shape
    lo, v = vocab_window if vocab_window else (0, target_cfg.vocab_size)
    eos_w = eos_id - lo  # never matches a window id when EOS lies outside
    t_head = llama.slice_logits_head(target_params, target_cfg, lo, v) if vocab_window else None
    d_head = llama.slice_logits_head(draft_params, draft_cfg, lo, v) if vocab_window else None
    cache_len = cache_len or (s + max_new_tokens + gamma + 1)
    if cache_len < s + max_new_tokens + gamma + 1:
        raise ValueError("cache_len too small for prompt + budget + gamma")

    t0 = time.perf_counter()
    tgt_cache = llama.init_kv_cache(target_cfg, b, cache_len, quantized=quantized_kv,
                                    device=dev)
    drf_cache = llama.init_kv_cache(draft_cfg, b, cache_len, quantized=quantized_kv,
                                    device=dev)
    t_logits, tgt_cache = llama.prefill(target_params, target_cfg, tokens, lengths,
                                        tgt_cache, logits_head=t_head)
    _, drf_cache = llama.prefill(draft_params, draft_cfg, tokens, lengths, drf_cache,
                                 logits_head=d_head)
    prompt_mask = torch.arange(s, device=dev)[None, :] < lengths[:, None]
    if vocab_window:
        token_counts = sampling.counts_from_tokens_windowed(tokens, prompt_mask, vocab_window)
    else:
        token_counts = sampling.counts_from_tokens(tokens, prompt_mask, v)
    gen_counts = torch.zeros_like(token_counts)
    _sync(dev)
    t1 = time.perf_counter()

    greedy = sp.temperature <= 0.0
    bi = torch.arange(b, device=dev)
    ones = torch.ones(b, dtype=torch.int32, device=dev)
    tok = sampling.sample_token(generator, t_logits, sp, token_counts, gen_counts).int()
    _count(token_counts, bi, tok, ones)
    _count(gen_counts, bi, tok, ones)
    # one column past the budget takes the writes of invalid positions
    out = torch.full((b, max_new_tokens + 1), pad_id, dtype=torch.int32, device=dev)
    out[:, 0] = tok + lo
    n_gen = torch.ones(b, dtype=torch.int32, device=dev)
    done = (tok == eos_w) | (max_new_tokens <= 1)
    tail0 = tokens[bi, lengths.long() - 1]
    j_idx = torch.arange(gamma + 1, device=dev)[None, :]
    rows_w = bi.repeat_interleave(gamma + 1)

    rounds = 0
    while rounds < max_new_tokens and not bool(done.all()):  # the round's one read
        # a finished row writes rows 0..gamma + 1 of its own cache, never
        # past its end; its outputs are dropped below
        base = torch.where(done, 1, lengths)

        # --- draft: re-process tail0 (an idempotent rewrite), then gamma steps
        llama.decode_step(draft_params, draft_cfg, drf_cache, tail0, base - 1,
                          logits_head=d_head)
        cnt_t, cnt_g = token_counts.clone(), gen_counts.clone()
        cur, cands, qs = tok, [], []
        for j in range(gamma):
            lg, _ = llama.decode_step(draft_params, draft_cfg, drf_cache, cur + lo, base + j,
                                      logits_head=d_head)
            al = sampling.adjusted_logits(lg, sp, cnt_t, cnt_g)
            if greedy:
                d = torch.argmax(al, dim=-1)
                q = torch.nn.functional.one_hot(d, v).float()
            else:
                q = torch.softmax(al, dim=-1)
                d = torch.multinomial(q, 1, generator=generator)[:, 0]
            d = d.int()
            _count(cnt_t, bi, d, ones)
            _count(cnt_g, bi, d, ones)
            cands.append(d)
            qs.append(q)
            cur = d
        cand = torch.stack(cands, dim=1)  # [B, gamma]
        q_arr = torch.stack(qs, dim=1)  # [B, gamma, V]

        # --- verify: one target forward over [tok, d_1 .. d_gamma]
        window = torch.cat([tok[:, None], cand], dim=1)
        t_logits, _ = llama.decode_window(target_params, target_cfg, tgt_cache, window + lo,
                                          base, logits_head=t_head)
        cnt_t, cnt_g = token_counts.clone(), gen_counts.clone()
        ps = []
        for j in range(gamma + 1):
            ps.append(sampling.sampling_distribution(t_logits[:, j], sp, cnt_t, cnt_g))
            if j < gamma:
                _count(cnt_t, bi, cand[:, j], ones)
                _count(cnt_g, bi, cand[:, j], ones)
        p_arr = torch.stack(ps, dim=1)  # [B, gamma + 1, V]

        # --- accept / reject; strict: P(u < p/q) = min(1, p/q) for u in
        # [0, 1), where '<=' would accept a p = 0 candidate at u = 0
        idx = cand.long()[..., None]
        p_at_d = torch.gather(p_arr[:, :gamma], -1, idx)[..., 0]
        q_at_d = torch.gather(q_arr, -1, idx)[..., 0]
        u = torch.rand((b, gamma), generator=generator, device=dev)
        accept = u * q_at_d.clamp_min(1e-30) < p_at_d
        n_acc = torch.cumprod(accept.int(), dim=1).sum(dim=1)  # [B] in [0, gamma]

        # --- the residual resample at the first rejection, else the bonus
        p_sel = p_arr[bi, n_acc]
        q_sel = q_arr[bi, n_acc.clamp(max=gamma - 1)]
        q_sel = torch.where((n_acc < gamma)[:, None], q_sel, 0.0)
        resid = (p_sel - q_sel).clamp_min(0.0)
        z = resid.sum(dim=-1, keepdim=True)
        resid = torch.where(z > 0, resid / z.clamp_min(1e-30), p_sel)
        if greedy:  # both sides one-hot: the residual is the target's argmax
            t_star = torch.argmax(resid, dim=-1).int()
        else:
            t_star = torch.multinomial(resid, 1, generator=generator)[:, 0].int()

        # --- emit [d_1 .. d_n_acc, t_star], cut at EOS, the budget, done rows
        cand_pad = torch.cat([cand, cand[:, -1:]], dim=1)
        vals = torch.where(j_idx < n_acc[:, None], cand_pad,
                           torch.where(j_idx == n_acc[:, None], t_star[:, None], pad_id))
        is_eos = vals == eos_w
        eos_before = torch.cumsum(is_eos.int(), dim=1) - is_eos.int() > 0
        valid = ((j_idx <= n_acc[:, None]) & ~eos_before & ~done[:, None]
                 & (n_gen[:, None] + j_idx < max_new_tokens))
        positions = torch.where(valid, n_gen[:, None] + j_idx, max_new_tokens)
        out[bi[:, None].expand_as(positions), positions] = torch.where(
            valid, vals + lo, pad_id).int()
        inc = valid.reshape(-1).int()
        safe = torch.where(valid, vals, 0).reshape(-1)  # in range; inc is 0 when invalid
        _count(token_counts, rows_w, safe, inc)
        _count(gen_counts, rows_w, safe, inc)
        n_gen = n_gen + valid.sum(dim=1).int()
        newly_done = (valid & is_eos).any(dim=1) | (n_gen >= max_new_tokens)

        # --- advance the committed state (frozen for finished rows)
        adv = ~done
        lengths = torch.where(adv, lengths + 1 + n_acc.int(), lengths)
        last_cand = cand_pad[bi, (n_acc - 1).clamp_min(0)]
        tail0 = torch.where(adv, torch.where(n_acc == 0, tok, last_cand) + lo, tail0)
        tok = torch.where(adv, t_star, tok)
        done = done | newly_done
        rounds += 1
    _sync(dev)
    return GenerateResult(tokens=out[:, :max_new_tokens], num_generated=n_gen, steps=rounds,
                          prefill_time=t1 - t0, decode_time=time.perf_counter() - t1)


def make_speculative_generate_fn(target_cfg, draft_cfg, sp, max_new_tokens, eos_id, gamma=4,
                                 pad_id=0, cache_len=None, quantized_kv=False,
                                 vocab_window=None, device="cuda"):
    """``fn(target_params, draft_params, prompt_tokens, prompt_lengths,
    generator)`` with every other argument of ``speculative_generate``
    fixed."""

    def fn(target_params, draft_params, prompt_tokens, prompt_lengths, generator):
        return speculative_generate(
            target_params, target_cfg, draft_params, draft_cfg, prompt_tokens,
            prompt_lengths, generator, sp=sp, max_new_tokens=max_new_tokens,
            eos_id=eos_id, gamma=gamma, pad_id=pad_id, cache_len=cache_len,
            quantized_kv=quantized_kv, vocab_window=vocab_window, device=device)

    return fn
