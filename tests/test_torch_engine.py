"""The port's serving engines against the JAX package's, on the CPU.

Same converted fp32 weights and prompts; the JAX engines run with
``delta_kv=False`` (the port writes K/V rows in place, as that path does).
Greedy token ids and finish reasons must be identical, with K = 1 and
K = 4 steps per dispatch, through mid-flight admission, EOS, ``min_tokens``,
a vocab window and cancels; the paged engine's prefix cache must hit and
miss as JAX's does. Sampled ids are never compared with JAX (the random
streams differ); instead the port's own invariants are held: K-step and
pipelined dispatch equal single-step dispatch, and a request gives the same
tokens alone and in a full pool.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_max_tpu.inference import engine as je
from tts_max_tpu.models import llama as jl
from tts_max_tpu.ops import sampling as js
from tts_max_tpu_torch import convert
from tts_max_tpu_torch.inference import engine as te
from tts_max_tpu_torch.models import llama as tl
from tts_max_tpu_torch.ops import sampling as ts

VOCAB = 128
WINDOW = (8, 100)
GREEDY = dict(temperature=0.0, repetition_penalty=1.3, frequency_penalty=0.2)
SAMPLED = dict(temperature=0.9, top_k=12, repetition_penalty=1.1,
               frequency_penalty=0.3)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jl.tiny_config(vocab_size=VOCAB, max_seq_len=256),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.tiny_config(vocab_size=VOCAB, max_seq_len=256),
                               dtype=torch.float32)
    jp = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.llama_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                  device="cpu")
    return jcfg, jp, tcfg, tp


def _engines(models, paged, sp, **kw):
    jcfg, jp, tcfg, tp = models
    jcls = je.PagedInferenceEngine if paged else je.InferenceEngine
    tcls = te.PagedInferenceEngine if paged else te.InferenceEngine
    return (jcls(jp, jcfg, sp=js.SamplingParams(**sp), delta_kv=False, **kw),
            tcls(tp, tcfg, sp=ts.SamplingParams(**sp), device="cpu", **kw))


def _drive(eng, reqs, cancel_after_first=()):
    """Submit ``reqs`` (dicts of submit kwargs), poll once, cancel the
    requests at the given indices, run to the end. Returns
    {index: (tokens, finish_reason)} and the cancel results."""
    sp_cls = js.SamplingParams if isinstance(eng, je.InferenceEngine) else ts.SamplingParams
    ids = []
    for r in reqs:
        r = dict(r)
        if "sampling" in r:
            r["sampling"] = sp_cls(**r["sampling"])
        ids.append(eng.submit(**r))
    done = list(eng.poll())
    cancelled = [eng.cancel(ids[i]) for i in cancel_after_first]
    done += eng.run()
    by_id = {c.request_id: c for c in done}
    return {i: (list(by_id[rid].tokens), by_id[rid].finish_reason)
            for i, rid in enumerate(ids) if rid in by_id}, cancelled


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, n).astype(np.int32) for n in lengths]


@pytest.fixture(scope="module")
def mixed(models):
    """Five requests for a 2-slot pool (queueing, mid-flight admission),
    with an EOS that fires for request 1 and, for request 2, one that
    min_tokens holds back; EOS ids come from a free run of JAX's engine."""
    prompts = _prompts(0, (5, 70, 12, 33, 20))
    free, _ = _drive(_engines(models, False, GREEDY, max_batch=2, max_len=128,
                              vocab_window=WINDOW)[0],
                     [dict(prompt_tokens=p, max_new_tokens=10, eos_id=-1)
                      for p in prompts])
    reqs = [dict(prompt_tokens=p, max_new_tokens=10, eos_id=-1, sampling_seed=i)
            for i, p in enumerate(prompts)]
    reqs[1]["eos_id"] = int(free[1][0][3])
    reqs[2].update(eos_id=int(free[2][0][1]), min_tokens=5)
    reqs[3]["max_new_tokens"] = 7
    return reqs


@pytest.mark.parametrize("ksteps", [1, 4])
@pytest.mark.parametrize("paged", [False, True])
def test_greedy_ids_match_jax_with_eos_min_tokens_window_and_cancel(
        models, mixed, paged, ksteps):
    kw = dict(max_batch=2, max_len=128, steps_per_dispatch=ksteps, vocab_window=WINDOW)
    if paged:
        kw["block_size"] = 32
    jeng, teng = _engines(models, paged, GREEDY, **kw)
    # request 0 is cancelled mid-flight, request 4 while queued
    ref, ref_cancel = _drive(jeng, mixed, cancel_after_first=(0, 4))
    ours, cancel = _drive(teng, mixed, cancel_after_first=(0, 4))
    assert cancel == ref_cancel == [True, True]
    assert ours == ref
    assert sorted(ours) == [1, 2, 3]
    assert ours[1][1] == "eos" and ours[1][0][-1] == mixed[1]["eos_id"]
    assert mixed[2]["eos_id"] not in ours[2][0][:5] and len(ours[2][0]) >= 5
    assert all(WINDOW[0] <= t < sum(WINDOW) for toks, _ in ours.values() for t in toks)
    assert not teng.has_work() and teng.first_token_times == {}


def test_greedy_ids_match_jax_int8_kv_and_shortest_first(models):
    """int8 KV (paged, K = 4) and shortest-first admission (contiguous)."""
    reqs = [dict(prompt_tokens=p, max_new_tokens=n, eos_id=-1)
            for p, n in zip(_prompts(1, (40, 6, 18, 9)), (12, 5, 9, 6))]
    for paged, kw in ((True, dict(quantized_kv=True, steps_per_dispatch=4, block_size=16)),
                      (False, dict(admission_policy="shortest"))):
        jeng, teng = _engines(models, paged, GREEDY, max_batch=2, max_len=128, **kw)
        assert _drive(teng, reqs) == _drive(jeng, reqs)


def _check_pool(eng):
    assert 0 not in {blk for row in eng._slot_blocks for blk in row}
    assert 0 not in eng._free_blocks and 0 not in eng._evictable
    assert 0 not in eng._hash_of and eng._refs[0] == 0


def test_paged_prefix_cache_matches_jax(models):
    """Shared-prefix requests in a small pool: the same hits and misses and
    the same greedy ids as JAX, blocks recycled and evicted, the sink block
    never handed out, and request 0 finishing exactly on a block boundary,
    so that its slot's next lockstep write lands one block past its
    reservation (table entry 0, the sink) while request 1 decodes on."""
    prefix = _prompts(2, (48,))[0]
    tails = ([7, 9], [11, 13, 5], [3], [21, 22, 23, 24])
    prompts = [np.concatenate([prefix, t]).astype(np.int32) for t in tails]
    prompts.insert(1, _prompts(3, (20,))[0])
    budgets = (64 - len(prompts[0]), 40, 10, 8, 12)
    reqs = [dict(prompt_tokens=p, max_new_tokens=n, eos_id=-1)
            for p, n in zip(prompts, budgets)]
    reqs.append(dict(prompt_tokens=_prompts(4, (70,))[0], max_new_tokens=40, eos_id=-1))
    kw = dict(max_batch=2, max_len=128, block_size=16, num_blocks=14,
              enable_prefix_cache=True, steps_per_dispatch=4)
    jeng, teng = _engines(models, True, GREEDY, **kw)
    ref = _drive(jeng, reqs)
    ids = [teng.submit(**r) for r in reqs]
    done = {}
    while teng.has_work():
        done.update({c.request_id: c for c in teng.poll()})
        _check_pool(teng)
    ours = {i: (list(done[rid].tokens), done[rid].finish_reason)
            for i, rid in enumerate(ids)}
    assert (ours, []) == ref
    stats = teng.stats()
    assert (teng.prefix_cache_hits, teng.prefix_cache_misses) == (
        jeng.prefix_cache_hits, jeng.prefix_cache_misses)
    assert teng.prefix_cache_hits >= 9  # three sharers x three prefix blocks
    assert teng._suffix_admissions == 3
    assert (teng._refs == 0).all() and teng._deferred_free == []
    assert stats["free_blocks"] + stats["cached_blocks"] == teng.num_blocks - 1
    assert len(ours[0][0]) == budgets[0]


@pytest.mark.parametrize("paged", [False, True])
def test_multi_step_and_pipelined_dispatch_equal_single_step(models, paged):
    """Sampled, with queueing: K = 1, K = 4 stepped without pipelining, and
    K = 4 pipelined through run() give identical tokens."""
    _, _, tcfg, tp = models
    cls = te.PagedInferenceEngine if paged else te.InferenceEngine
    kw = dict(block_size=32, enable_prefix_cache=True) if paged else {}
    prompts = _prompts(5, (9, 40, 3, 17, 66))

    def run(ksteps, pipelined):
        eng = cls(tp, tcfg, max_batch=2, max_len=128, sp=ts.SamplingParams(**SAMPLED),
                  steps_per_dispatch=ksteps, device="cpu", **kw)
        ids = [eng.submit(p, 11, eos_id=-1, sampling_seed=10 + i)
               for i, p in enumerate(prompts)]
        done = eng.run() if pipelined else [c for _ in iter(eng.has_work, False)
                                            for c in eng.step()]
        by_id = {c.request_id: list(c.tokens) for c in done}
        return [by_id[i] for i in ids]

    want = run(1, False)
    assert run(4, False) == want
    assert run(4, True) == want


@pytest.mark.parametrize("paged", [False, True])
def test_sampled_request_alone_equals_in_full_pool(models, paged):
    """Slot isolation: a sampled request's tokens depend on its seed and its
    own history, not on which requests share the pool or which slot it
    takes."""
    _, _, tcfg, tp = models
    cls = te.PagedInferenceEngine if paged else te.InferenceEngine
    kw = dict(block_size=32) if paged else {}
    target = _prompts(6, (14,))[0]
    others = _prompts(7, (14, 14, 14))

    def make():
        return cls(tp, tcfg, max_batch=4, max_len=128, sp=ts.SamplingParams(**SAMPLED),
                   steps_per_dispatch=4, device="cpu", **kw)

    alone = make()
    rid = alone.submit(target, 16, eos_id=-1, sampling_seed=99)
    [solo] = alone.run()
    full = make()
    for i, p in enumerate(others):
        full.submit(p, 20 - 3 * i, eos_id=-1, sampling_seed=i)
    rid = full.submit(target, 16, eos_id=-1, sampling_seed=99)
    pooled = {c.request_id: c for c in full.run()}[rid]
    assert list(pooled.tokens) == list(solo.tokens)


def test_first_token_times_drain_and_warmup_preserves_state(models):
    _, _, tcfg, tp = models
    prompts = _prompts(8, (3, 30, 8))

    def make():
        return te.PagedInferenceEngine(tp, tcfg, max_batch=2, max_len=128, block_size=32,
                                       sp=ts.SamplingParams(**GREEDY),
                                       enable_prefix_cache=True, steps_per_dispatch=4,
                                       device="cpu")

    cold = make()
    want = cold.generate_all(prompts, max_new_tokens=6, eos_id=-1)
    assert cold.first_token_times == {}
    assert all(c.first_token_time is not None for c in want)
    warm = make()
    warm.warmup(prompt_buckets=(64,))
    assert sorted(warm._free_blocks) == list(range(1, warm.num_blocks))
    assert warm.stats()["dispatches_per_stage"] == {}
    got = warm.generate_all(prompts, max_new_tokens=6, eos_id=-1)
    assert [list(c.tokens) for c in got] == [list(c.tokens) for c in want]
    with pytest.raises(ValueError, match="exceeds max_len"):
        warm.generate_all([prompts[1]], max_new_tokens=100, eos_id=-1)


def test_engines_default_to_the_card(models):
    _, _, tcfg, tp = models
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="cuda"):
        te.InferenceEngine(tp, tcfg)
    with pytest.raises(RuntimeError, match="cuda"):
        te.PagedInferenceEngine(tp, tcfg)


@pytest.mark.parametrize("quantized_kv", [False, True])
def test_contiguous_engine_decodes_with_kernel_c_and_int8_with_b(models, monkeypatch,
                                                                 quantized_kv):
    """The contiguous engine's decode attention is kernel C (here its plain
    version) over a bf16/fp32 pool and kernel B over int8 KV, one call per
    layer and lockstep step; its greedy ids stay JAX's."""
    calls = {"ragged": 0, "flash": 0}

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tl, "ragged_decode_attention",
                        counted("ragged", tl.ragged_decode_attention))
    monkeypatch.setattr(tl, "flash_decode_attention",
                        counted("flash", tl.flash_decode_attention))
    reqs = [dict(prompt_tokens=p, max_new_tokens=n, eos_id=-1)
            for p, n in zip(_prompts(9, (21, 4, 50)), (9, 6, 7))]
    jeng, teng = _engines(models, False, GREEDY, max_batch=2, max_len=128,
                          steps_per_dispatch=4, quantized_kv=quantized_kv)
    assert _drive(teng, reqs) == _drive(jeng, reqs)
    steps = sum(teng.stats()["dispatches_per_stage"].values()) * 4
    used, unused = ("flash", "ragged") if quantized_kv else ("ragged", "flash")
    assert calls[used] == models[2].n_layers * steps and calls[unused] == 0


def test_decode_step_ragged_refuses_an_int8_cache(models):
    _, _, tcfg, tp = models
    cache = tl.init_kv_cache(tcfg, 1, 16, quantized=True, device="cpu")
    with pytest.raises(ValueError, match="int8"):
        tl.decode_step(tp, tcfg, cache, torch.zeros(1, dtype=torch.int32),
                       torch.zeros(1, dtype=torch.int32), ragged=True)
