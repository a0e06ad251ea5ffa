"""Serving cells: the port's contiguous ``InferenceEngine`` as
``tools/serve_batch.build_engine`` builds it, under a closed loop of clients.

Set-up: weights from the seed, the engine, its kernels and one group
prefill per prompt bucket the mix can make (``engine.warmup``), then every
client's first request admitted and its first token read, so the pool is
full when the window opens. In the window every client sends its next
request as soon as the last one completes, and the loop polls the engine
(``poll``: admission, group prefill, one K-step dispatch queued, the last
one's tokens read). After the window: the peak memory, the program's state
freed, then the checks that decide ``correct``:

- every served token of every finished request lies in the speech window,
  and every request ended on its budget (EOS is unsampleable before it:
  ``min_tokens`` is the budget, since random weights know no end of
  speech);
- every finished greedy request (one in 8 of the mix; a sample of
  ``sample_requests`` drawn from the seed, the longest among them, where
  more finished), in whichever slots of the pool they ran, goes through
  the reference: each served token's gap below
  the reference's best logit at its position, in units of that position's
  spread (EOS, which the request could not take, left out), against the
  cell's limit. It covers the group prefill (kernel A,
  the first token), decode through the contiguous cache (kernel C, the
  rest), the window head and the speech-window constraint.
"""

from __future__ import annotations

import gc
import time
from argparse import Namespace

import numpy as np
import torch

from benchmark import harness, traffic
from benchmark.reference import compare
from benchmark.reference import llama as ref

CODES_PER_S = 50


def greedy_params():
    from tts_max_tpu_torch.ops.sampling import SamplingParams

    return SamplingParams(temperature=0.0, repetition_penalty=1.0, frequency_penalty=0.0)


def build_engine(ctx, cfg, params):
    from tts_max_tpu_torch.core.tokenization import build_byte_tokenizer, speech_vocab
    from tts_max_tpu_torch.tools import serve_batch

    e = ctx.workload["engine"]
    args = Namespace(engine="contiguous", max_batch=e["max_batch"], max_len=e["max_len"],
                     block_size=64, quantized_kv=False, no_constrain=False,
                     steps_per_dispatch=e.get("steps_per_dispatch", 0),
                     admission_policy=e.get("admission_policy", "fifo"), prefill_ahead=False,
                     park_rows=0, park_len=0, park_groups_per_poll=0, no_warmup=True,
                     device=str(ctx.device))
    return serve_batch.build_engine(args, params, cfg, speech_vocab(build_byte_tokenizer()),
                                    prefix_cache=False)


class _Snapshots:
    """End-of-dispatch ``lengths`` and ``active`` of the pool, copied behind
    each dispatch without a host sync (traced runs only)."""

    def __init__(self, engine):
        self.engine = engine
        self.items = []

    def take(self, tag: str) -> None:
        e = self.engine
        if e.device.type == "cuda":
            ln = torch.empty(e.lengths.shape, dtype=e.lengths.dtype, pin_memory=True)
            ac = torch.empty(e.active.shape, dtype=e.active.dtype, pin_memory=True)
            ln.copy_(e.lengths, non_blocking=True)
            ac.copy_(e.active, non_blocking=True)
        else:
            ln, ac = e.lengths.clone(), e.active.clone()
        self.items.append((tag, ln, ac))

    def dispatch_rows(self, k: int) -> list[tuple[str, list[np.ndarray]]]:
        """Per dispatch after the first snapshot: its tag and, for each of
        its K steps, the K/V rows each slot's decode attention read."""
        out = []
        for (_, l0, a0), (tag, l1, a1) in zip(self.items, self.items[1:]):
            out.append((tag, step_rows(l0.numpy(), a0.numpy(), l1.numpy(), a1.numpy(), k)))
        return out


def step_rows(l0, a0, l1, a1, k: int) -> list[np.ndarray]:
    """Rows read by each slot in each of a dispatch's K steps, from the
    lengths and active flags before (l0, a0) and after (l1, a1) it. A slot
    active at the end ran all K steps from l1 - K; one that finished inside
    emitted l1 - l0 tokens and read one row (its own dead row) from the step
    that ended it on; an idle slot reads one row a step."""
    steps = np.arange(k)
    rows = np.ones((k, len(l1)), dtype=np.int64)
    for i in range(len(l1)):
        if a1[i]:
            rows[:, i] = l1[i] - k + steps + 1
        elif a0[i]:
            n = int(l1[i] - l0[i])
            rows[:n - 1, i] = l0[i] + steps[:max(n - 1, 0)] + 1
    return list(rows)


def run(ctx) -> dict:
    dev = ctx.device
    t_start = t = time.perf_counter()
    cfg = harness.model_config(ctx.conf)
    params = harness.make_weights(cfg, ctx.seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_weights = time.perf_counter() - t
    t = time.perf_counter()
    engine = build_engine(ctx, cfg, params)
    t_engine = time.perf_counter() - t
    gen = traffic.ServeTraffic(ctx.mix, ctx.seed)
    vocab = gen.vocab
    if tuple(engine.vocab_window) != vocab.window:
        raise RuntimeError(f"the engine's speech window {engine.vocab_window} is not the "
                           f"mix's {vocab.window}")
    t = time.perf_counter()
    engine.warmup(prompt_buckets=traffic.prompt_buckets(*gen.prompt_range()))
    t_warm = time.perf_counter() - t
    k = engine.steps_per_dispatch
    greedy = greedy_params()
    for patch in ctx.patches:
        patch(engine)

    submitted: dict[int, tuple[traffic.ServeRequest, float]] = {}
    done: dict[int, tuple] = {}  # rid -> (completion, host time it was read)
    counter = {"next": 0, "open": True}

    def submit(now):
        r = gen.request(counter["next"])
        counter["next"] += 1
        # random weights know no end of speech: EOS stays unsampleable until
        # the budget, so every seed serves the mix's output lengths
        rid = engine.submit(r.prompt, max_new_tokens=r.budget, eos_id=vocab.eos,
                            sampling_seed=r.sampling_seed, sampling=greedy if r.greedy else None,
                            min_tokens=r.budget)
        submitted[rid] = (r, now)

    occupancy: list[int] = []
    snaps = _Snapshots(engine) if ctx.trace else None

    def poll(tag="window"):
        before = sum(engine.stats()["dispatches_per_stage"].values())
        comps = engine.poll()
        now = time.perf_counter()
        st = engine.stats()
        if snaps is not None and sum(st["dispatches_per_stage"].values()) > before:
            snaps.take(tag)
        occupancy.append(st["active_slots"])
        for c in comps:
            done[c.request_id] = (c, now)
            if counter["open"]:
                submit(now)
        return now

    t = time.perf_counter()
    now = time.perf_counter()
    for _ in range(ctx.mix["clients"]):
        submit(now)
    first = list(submitted)
    while not all(r in engine.first_token_times or r in done for r in first):
        poll("fill")
    t_fill = time.perf_counter() - t
    harness.log(f"set-up: imports and CUDA until {t_start - ctx.t0:.2f} s, weights "
                f"{t_weights:.2f} s, engine {t_engine:.2f} s, warmup {t_warm:.2f} s "
                f"({len(traffic.prompt_buckets(*gen.prompt_range()))} prompt buckets), "
                f"fill {t_fill:.2f} s")

    occupancy.clear()
    st0 = engine.stats()
    t_open = time.perf_counter()
    harness.log(f"window opens {t_open - ctx.t0:.2f} s after process start")
    host = harness.HostClock()
    deadline = t_open + ctx.seconds
    while now < deadline:
        now = poll()
    t_close = now
    harness.log(f"host in the window: {host.stop()}")
    st1 = engine.stats()
    in_flight_first = dict(engine.first_token_times)
    window_polls = len(occupancy)
    traces = None
    if ctx.trace:
        # after the window, in the same steady state: one slice with the
        # card's activity alone (busy time, kernel times), then one with the
        # host's ops too, only to name the idle gaps (host tracing slows a
        # host-bound step, so its times are not used)
        from benchmark.trace import Slice

        tr = ctx.workload.get("trace", {})
        with Slice(dev, host=False) as card:
            for _ in range(tr.get("polls", 3)):
                poll("slice")
        with Slice(dev, host=True) as both:
            for _ in range(tr.get("polls", 3)):
                poll("host_slice")
        traces = (card, both)
    counter["open"] = False

    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    window_s = t_close - t_open
    tokens = st1["generated_tokens"] - st0["generated_tokens"]
    dispatches = (sum(st1["dispatches_per_stage"].values())
                  - sum(st0["dispatches_per_stage"].values()))

    # --- end-to-end metrics -------------------------------------------------
    first_times = {rid: c.first_token_time for rid, (c, _) in done.items()}
    first_times.update(in_flight_first)
    ttft = [ft - submitted[rid][1] for rid, ft in first_times.items()
            if ft is not None and t_open <= ft <= t_close]
    rtf = []
    for rid, (c, fin) in done.items():
        n = len(c.tokens) - (c.finish_reason == "eos")
        if t_open <= fin <= t_close and n > 0:
            rtf.append((fin - c.first_token_time) / (n / CODES_PER_S))
    e2e = {"audio_s_per_s": tokens / CODES_PER_S / window_s,
           "ttft_p95_ms": 1e3 * harness.percentile(ttft, 95) if ttft else None,
           "stream_rtf_p95": harness.percentile(rtf, 95) if rtf else None}
    harness.log(f"window {window_s:.3f} s: {tokens} tokens, {dispatches} dispatches of {k}, "
                f"{len(rtf)} completed, {len(ttft)} first tokens; TTFT p50 "
                f"{1e3 * harness.percentile(ttft, 50) if ttft else float('nan'):.1f} ms p95 "
                f"{e2e['ttft_p95_ms'] or float('nan'):.1f} ms (n={len(ttft)}); RTF p50 "
                f"{harness.percentile(rtf, 50) if rtf else float('nan'):.4f} p95 "
                f"{e2e['stream_rtf_p95'] or float('nan'):.4f} (n={len(rtf)}); occupancy "
                f"{np.mean(occupancy[:window_polls]) if occupancy else 0:.2f} of "
                f"{engine.max_batch}")

    obs = {"kind": "serve", "cfg": cfg, "window": vocab.window, "window_s": window_s,
           "dispatches": dispatches, "steps_per_dispatch": k,
           "occupancy": occupancy[:window_polls], "max_batch": engine.max_batch,
           "ttft_s": ttft, "stream_rtf": rtf}
    if ctx.trace:
        obs["dispatch_rows"] = snaps.dispatch_rows(k)
        summary = traces[0].reduce()
        summary["idle_gaps"] = traces[1].reduce()["idle_gaps"]
        obs["trace"] = summary

    # --- free the program's state, then check ----------------------------------
    del engine, params, snaps
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, failed, compared = check(ctx, cfg, vocab, submitted, done)
    return {"t_open": t_open, "e2e": e2e, "obs": obs, "checks": checks,
            "attempted": len(submitted), "failed": failed, "memory_peak_bytes": memory_peak,
            "compared": compared}


def check(ctx, cfg, vocab, submitted, done):
    lo, size = vocab.window
    outside, wrong_len, bad = 0, 0, set()
    for rid, (c, _) in done.items():
        r = submitted[rid][0]
        toks = np.asarray(c.tokens)
        n_out = int(((toks < lo) | (toks >= lo + size)).sum())
        ended = (c.finish_reason == "length" and len(toks) == r.budget) or (
            c.finish_reason == "eos" and toks[-1] == vocab.eos and len(toks) <= r.budget)
        outside += n_out
        wrong_len += not ended
        if n_out or not ended:
            bad.add(rid)

    greedy = sorted(rid for rid, (c, _) in done.items() if submitted[rid][0].greedy)
    rng = np.random.default_rng([ctx.seed, 4])
    n_sample = ctx.workload["correct"]["sample_requests"]
    sample = []
    if greedy:
        longest = max(greedy, key=lambda rid: len(done[rid][0].tokens))
        rest = [rid for rid in greedy if rid != longest]
        sample = [longest] + [rest[i] for i in rng.permutation(len(rest))[:n_sample - 1]]
    weights = harness.make_weights(cfg, ctx.seed, ctx.device)
    gaps, compared = [], []
    for rid in sample:
        prompt = submitted[rid][0].prompt
        served = np.asarray(done[rid][0].tokens)
        seq = torch.as_tensor(np.concatenate([prompt, served[:-1]]), device=ctx.device)
        positions = np.arange(len(prompt) - 1, len(prompt) - 1 + len(served))
        logits = ref.next_token_logits(weights, ctx.conf, seq, positions, vocab.window)
        g = compare.token_gaps(logits, torch.as_tensor(served - lo, device=ctx.device),
                               exclude=vocab.eos - lo)
        gaps.append(float(g.max()))
        compared.append((prompt, served))
    del weights
    limit = ctx.workload["correct"]
    checks = [
        {"name": "served_token_gap", "value": max(gaps) if gaps else float("inf"),
         "limit": limit["served_token_gap"], "op": "<="},
        {"name": "compared_tokens", "value": sum(len(s) for _, s in compared),
         "limit": limit["compared_tokens"], "op": ">="},
        {"name": "tokens_outside_window", "value": outside, "limit": 0, "op": "<="},
        {"name": "requests_ended_wrong", "value": wrong_len, "limit": 0, "op": "<="},
    ]
    harness.log(f"compared {len(sample)} of {len(greedy)} finished greedy requests, "
                f"{sum(len(s) for _, s in compared)} "
                f"tokens; gaps {[round(g, 6) for g in gaps]}")
    return checks, len(bad), compared


def control_reading(ctx, compared) -> dict:
    """The control's reading on the same prompts and served tokens: at each
    position, the gap (under the float32 reference) of the token that the
    reference computed in float8 puts first."""
    cfg = harness.model_config(ctx.conf)
    window = tuple(ctx.mix["vocab"]["window"])
    weights = harness.make_weights(cfg, ctx.seed, ctx.device)
    worst = 0.0
    for prompt, served in compared:
        seq = torch.as_tensor(np.concatenate([prompt, served[:-1]]), device=ctx.device)
        positions = np.arange(len(prompt) - 1, len(prompt) - 1 + len(served))
        exact = ref.next_token_logits(weights, ctx.conf, seq, positions, window)
        low = ref.next_token_logits(weights, ctx.conf, seq, positions, window, fp8=True)
        eos = ctx.mix["vocab"]["speech_end"] - window[0]
        low[:, eos] = float("-inf")
        worst = max(worst, float(compare.token_gaps(exact, low.argmax(-1), exclude=eos).max()))
    return {"served_token_gap": worst}


def _token_altered(engine):
    """Each served token altered (one id up, two where one would make it the
    request's EOS, which the engine would take as an early end and stop on)
    in the dispatch's result."""
    inner = engine._decode_multi

    def broken(ksteps):
        blob = inner(ksteps)
        emitted = blob[ksteps:2 * ksteps]  # 1 where a slot emitted its token
        blob[:ksteps] += emitted
        blob[:ksteps] += emitted * (blob[:ksteps] == engine.eos_ids[None, :]).int()
        return blob
    engine._decode_multi = broken


def _state_unchanged(engine):
    """A decode step that returns the state it was given: the logits stay
    those of the step before."""
    engine._decode_step = lambda toks, lengths, table: engine.last_logits


def _half_batch(engine):
    """Half of the pool left out of each decode step: its rows keep their
    old logits."""
    inner = engine._decode_step

    def broken(toks, lengths, table):
        logits = inner(toks, lengths, table)
        half = logits.shape[0] // 2
        return torch.cat([logits[:half], engine.last_logits[half:]])
    engine._decode_step = broken


FAULTS = {"token_altered": _token_altered, "state_unchanged": _state_unchanged,
          "half_batch": _half_batch}
