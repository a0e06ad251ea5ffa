"""Training cells: the port's one-device SFT step (``training/train_step.
train_step``) as ``training/main.py`` builds it in one process, fed by the
port's ``collate``.

Set-up builds the one training object (bf16 weights from the seed, AdamW's
state) and drives it through its first steps with the window's own call and
feed: one batch of each bucket the mix holds, longest first, the first three
of them the steps the reference follows. The state after them goes on into
the window, which runs steps back to back until its seconds have passed.
After the window: the peak memory, the program's state freed, then the
reference (``benchmark/reference/llama.py``) runs the same first three
batches in float32 from the same seeded weights, padded by the benchmark
itself to their longest sample (not by ``collate``), and ``correct``
compares:

- each of the three steps' loss (relative gap);
- the norm of each leaf's first gradient as AdamW got it (clipped), worked
  out from its first moment after step 1 (mu = (1 - b1) g);
- the norm of each leaf's change over the three steps, over the leaves
  whose reference gradient is at least a thousandth of the median leaf's;
- that no step of the window was skipped as non-finite.

Leaves are each layer's slice of a stacked weight, the embedding, the final
norm and an untied head. The comparison covers the forward under full remat
(kernel A), the chunked loss, the backward (kernel A'), the clip and the
AdamW update.
"""

from __future__ import annotations

import functools
import gc
import time

import torch

from benchmark import harness, traffic
from benchmark.reference import compare
from benchmark.reference import llama as ref

CHECKED_STEPS = 3


def leaf_norms(tree: dict, spec: ref.Spec, scale: float = 1.0) -> dict[str, float]:
    """Each leaf's norm of a parameter-shaped tree of the program (params or
    a moment), times ``scale``."""
    return {k: float(v.float().norm()) * scale for k, v in ref.leaves_of(tree, spec).items()}


def change_norms(new: dict, old: dict, spec: ref.Spec) -> dict[str, float]:
    a, b = ref.leaves_of(new, spec), ref.leaves_of(old, spec)
    return {k: float((a[k].float() - b[k].float()).norm()) for k in a}


def build(ctx):
    from tts_max_tpu_torch.data.collate import collate
    from tts_max_tpu_torch.training import optim
    from tts_max_tpu_torch.training import train_step as ts

    t = ctx.workload["train"]
    cfg = harness.model_config(ctx.conf, remat=True, remat_policy=None,
                               max_seq_len=ctx.mix["buckets"][-1])
    tx = optim.create_optimizer(optim.constant_schedule(t["learning_rate"]), tuple(t["betas"]),
                                t["weight_decay"], mu_dtype=t["adam_mu_dtype"])
    step = functools.partial(ts.train_step, cfg=cfg, tx=tx,
                             gradient_clip_value=t["gradient_clip_value"],
                             loss_chunk_size=t["loss_chunk_size"])
    feed = traffic.SftTraffic(ctx.mix, ctx.seed, functools.partial(
        collate, pad_token_id=ctx.mix["vocab"]["pad"], max_seq_len=ctx.mix["buckets"][-1]))
    return cfg, tx, step, feed


def macro(batch: traffic.SftBatch) -> dict:
    """One micro-step's batch in ``train_step``'s [A, B, L] layout, as
    ``training/loop.py`` hands it."""
    return {"input_ids": batch.input_ids[None], "labels": batch.labels[None]}


def run(ctx) -> dict:
    dev = ctx.device
    t_start = time.perf_counter()
    cfg, tx, step, feed = build(ctx)
    for patch in ctx.patches:
        step = patch(step)
    spec = ref.Spec(ctx.conf)
    b1 = ctx.workload["train"]["betas"][0]
    params = harness.make_weights(cfg, ctx.seed, dev)
    opt_state = tx.init(params)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_weights = time.perf_counter() - t_start

    # set-up: the first steps, through the window's own call and feed
    start, losses, grad_norm, change, nonfinite = params, [], None, None, 0
    n_setup = max(CHECKED_STEPS, feed.warm_batches())
    t = time.perf_counter()
    for i in range(n_setup):
        params, opt_state, m = step(params, opt_state, macro(feed.batch(i)))
        nonfinite += m.nonfinite > 0
        if i < CHECKED_STEPS:
            losses.append(m.loss)
        if i == 0:
            grad_norm = leaf_norms(opt_state["mu"], spec, 1.0 / (1.0 - b1))
        if i == CHECKED_STEPS - 1:
            change = change_norms(params, start, spec)
            start = None
    t_setup_steps = time.perf_counter() - t
    harness.log(f"set-up: imports and CUDA until {t_start - ctx.t0:.2f} s, weights "
                f"{t_weights:.2f} s, {n_setup} steps {t_setup_steps:.2f} s")

    # the window
    i = n_setup
    tokens, padded, lengths, steps = 0, 0, [], 0
    t_open = time.perf_counter()
    harness.log(f"window opens {t_open - ctx.t0:.2f} s after process start")
    host = harness.HostClock()
    now = t_open
    while now < t_open + ctx.seconds:
        b = feed.batch(i)
        params, opt_state, m = step(params, opt_state, macro(b))
        now = time.perf_counter()  # the step ends reading its loss from the card
        nonfinite += m.nonfinite > 0
        tokens += b.tokens
        padded += b.input_ids.size
        lengths += b.lengths
        steps += 1
        i += 1
    window_s = now - t_open
    harness.log(f"host in the window: {host.stop()}")
    e2e = {"train_tokens_per_s": tokens / window_s}
    harness.log(f"window {window_s:.3f} s: {steps} steps, {tokens} tokens of {padded} padded, "
                f"{1e3 * window_s / max(steps, 1):.1f} ms a step")

    obs = {"kind": "train", "cfg": cfg, "window_s": window_s, "tokens": tokens,
           "padded": padded, "lengths": lengths}
    if ctx.trace:
        from benchmark.trace import Slice

        n = ctx.workload.get("trace", {}).get("steps", 1)
        buckets = []
        with Slice(dev, host=False) as card:
            for _ in range(n):
                b = feed.batch(i)
                params, opt_state, m = step(params, opt_state, macro(b))
                buckets.append(b.input_ids.shape)
                i += 1
        with Slice(dev, host=True) as both:
            params, opt_state, m = step(params, opt_state, macro(feed.batch(i)))
        summary = card.reduce()
        summary["idle_gaps"] = both.reduce()["idle_gaps"]
        obs.update(trace=summary, traced_batches=buckets)

    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del params, opt_state, m
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    program = {"losses": losses, "grad_norm": grad_norm, "change_norm": change}
    reference = follow(ctx, cfg, feed)
    checks = compare_steps(ctx, program, reference, nonfinite)
    return {"t_open": t_open, "e2e": e2e, "obs": obs, "checks": checks,
            "attempted": steps, "failed": int(nonfinite), "memory_peak_bytes": memory_peak,
            "compared": program}


def follow(ctx, cfg, feed, fp8: bool = False) -> dict:
    """The reference through the first three batches, from the seed's
    weights drawn again."""
    t = ctx.workload["train"]
    weights = harness.make_weights(cfg, ctx.seed, ctx.device)
    batches = [tuple(torch.as_tensor(a, device=ctx.device) for a in feed.plain_batch(i))
               for i in range(CHECKED_STEPS)]
    out = ref.train(weights, ctx.conf, batches, lr=t["learning_rate"], betas=tuple(t["betas"]),
                    weight_decay=t["weight_decay"], clip=t["gradient_clip_value"], fp8=fp8)
    del weights
    return out


def readings(program: dict, reference: dict) -> dict:
    moved = compare.moved_leaves(reference["grad_norm"])
    grad_gap, grad_leaf = compare.leaf_gap(program["grad_norm"], reference["grad_norm"])
    change_gap, change_leaf = compare.leaf_gap(program["change_norm"], reference["change_norm"],
                                               moved)
    harness.log(f"losses {program['losses']} reference {reference['losses']}; worst leaves: "
                f"grad {grad_leaf}, change {change_leaf}; {len(moved)} of "
                f"{len(reference['grad_norm'])} leaves compared for the change")
    return {"loss_gap": compare.loss_gap(program["losses"], reference["losses"]),
            "grad_norm_gap": grad_gap, "change_norm_gap": change_gap}


def compare_steps(ctx, program, reference, nonfinite) -> list[dict]:
    r = readings(program, reference)
    limit = ctx.workload["correct"]
    return [{"name": k, "value": v, "limit": limit[k], "op": "<="} for k, v in r.items()] + [
        {"name": "nonfinite_steps", "value": int(nonfinite), "limit": 0, "op": "<="}]


def control_reading(ctx, program) -> dict:
    """The control: the reference computed in float8 put in the program's
    place, read against the float32 reference."""
    cfg, _, _, feed = build(ctx)
    exact = follow(ctx, cfg, feed)
    return readings(follow(ctx, cfg, feed, fp8=True), exact)


def _half_batch(step):
    """Half of the batch left out: the step sees only its first rows, and
    its loss is the mean over them."""
    def broken(params, opt_state, batch):
        return step(params, opt_state, {k: v[:, :v.shape[1] // 2] for k, v in batch.items()})
    return broken


def _token_altered(step):
    """Every input token altered (one id up) on its way into the step."""
    def broken(params, opt_state, batch):
        return step(params, opt_state, dict(batch, input_ids=batch["input_ids"] + 1))
    return broken


def _state_unchanged(step):
    """A step that computes its loss and returns the state it was given."""
    def broken(params, opt_state, batch):
        _, _, metrics = step(params, opt_state, batch)
        return params, opt_state, metrics
    return broken


FAULTS = {"half_batch": _half_batch, "token_altered": _token_altered,
          "state_unchanged": _state_unchanged}
