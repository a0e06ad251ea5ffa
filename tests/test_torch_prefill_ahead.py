"""Prefill-ahead (park and attach) in the port's engines, on the CPU.

While the pool is full, queued requests prefill into the park buffer and
emit their first token at once; a freed slot takes the parked K/V rows with
a copy. Greedy ids must equal the JAX engines' with ``prefill_ahead=True``
(same converted fp32 weights, ``delta_kv=False``) and the port's own engine
without it. Sampled streams are held to the port's own unparked engine: the
counter-based keys (seed, tokens generated) make parked and unparked draws
the same. Also: completion at park time (budget 1, an EOS preview), cancel
of a parked request and of a pending park group, warmup, stats, and the
one-hot logits row an attach writes through the rowwise sampler.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import one_torch_thread  # noqa: F401
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
SAMPLED = dict(temperature=0.9, top_k=12, repetition_penalty=1.1, frequency_penalty=0.3)
NUCLEUS = dict(temperature=1.0, top_k=0, top_p=0.8, repetition_penalty=1.0,
               frequency_penalty=0.0)


@pytest.fixture(autouse=True, scope="module")
def _jax_table_upload_copies():
    """The JAX paged engine uploads its block table with ``jnp.asarray`` of
    the host array it later edits in place; on the CPU that upload may
    alias the host buffer, so a program still queued under async dispatch
    can read a newer table, and the reference's ids vary from run to run
    (about 1 in 12 under load). Here the upload copies, as the engine
    means it to; the comparison is unchanged."""
    def table_device(self, stage=None):
        if self._table_dirty:
            self._table_dev = jnp.asarray(np.array(self._table))
            self._table_dirty = False
        return self._table_dev

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(je.PagedInferenceEngine, "_table_device", table_device)
        yield


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


def _load(seed, n, budget_one_at=()):
    """``n`` requests for a 2-slot pool: prompts of 4, 9 or 33 tokens (one
    of 70, longer than a 64-token park buffer), budgets 5-24."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, VOCAB, rng.choice([4, 9, 33])).astype(np.int32)
               for _ in range(n)]
    prompts[n // 2] = rng.integers(1, VOCAB, 70).astype(np.int32)
    budgets = [int(rng.integers(5, 25)) for _ in range(n)]
    for i in budget_one_at:
        budgets[i] = 1
    return prompts, budgets


def _engine(models, jax_side, paged=False, sp=GREEDY, **kw):
    jcfg, jp, tcfg, tp = models
    if jax_side:
        cls = je.PagedInferenceEngine if paged else je.InferenceEngine
        return cls(jp, jcfg, sp=js.SamplingParams(**sp), delta_kv=False, **kw)
    cls = te.PagedInferenceEngine if paged else te.InferenceEngine
    return cls(tp, tcfg, sp=ts.SamplingParams(**sp), device="cpu", **kw)


def _run(eng, prompts, budgets, eos=-1):
    ids = [eng.submit(p, b, eos_id=eos, sampling_seed=100 + i)
           for i, (p, b) in enumerate(zip(prompts, budgets))]
    by_id = {c.request_id: c for c in eng.run()}
    return ids, by_id


def _tokens(ids, by_id):
    return [list(by_id[i].tokens) for i in ids]


@pytest.mark.parametrize("window", [None, WINDOW], ids=["vocab", "window"])
@pytest.mark.parametrize("quantized_kv", [False, True], ids=["fp32", "int8"])
def test_contiguous_greedy_matches_jax_and_unparked(models, window, quantized_kv):
    prompts, budgets = _load(5, 12, budget_one_at=(7,))
    kw = dict(max_batch=2, max_len=128, steps_per_dispatch=4, vocab_window=window,
              quantized_kv=quantized_kv)
    jids, jout = _run(_engine(models, True, prefill_ahead=True, park_rows=4,
                              park_len=64, **kw), prompts, budgets)
    eng = _engine(models, False, prefill_ahead=True, park_rows=4, park_len=64, **kw)
    ids, out = _run(eng, prompts, budgets)
    ref_ids, ref = _run(_engine(models, False, **kw), prompts, budgets)
    assert _tokens(ids, out) == _tokens(jids, jout) == _tokens(ref_ids, ref)
    st = eng.stats()
    assert st["parked_total"] > 0 and st["parked_requests"] == 0
    assert st["free_park_rows"] == st["park_rows"] == 4
    assert eng.park_len == 64 and not eng.has_work()
    # every completion carries its first-token time, and the dict drained
    assert all(c.first_token_time is not None for c in out.values())
    assert eng.first_token_times == {}
    assert st["generated_tokens"] == sum(len(c.tokens) for c in out.values())
    assert st["completed_requests"] == len(prompts)


@pytest.mark.parametrize("sp", [SAMPLED, NUCLEUS], ids=["top_k", "top_p"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_sampled_streams_equal_unparked(models, sp, paged):
    """The preview is drawn with the key (seed, 0) the decode's first step
    uses, and the attach forces the decode to re-emit it: every sampled
    stream equals the unparked engine's."""
    prompts, budgets = _load(6, 10)
    kw = dict(max_batch=2, max_len=128, steps_per_dispatch=4, sp=sp)
    if paged:
        kw["block_size"] = 32
    eng = _engine(models, False, paged, prefill_ahead=True, park_rows=4, **kw)
    ids, out = _run(eng, prompts, budgets)
    ref_ids, ref = _run(_engine(models, False, paged, **kw), prompts, budgets)
    assert _tokens(ids, out) == _tokens(ref_ids, ref)
    assert eng.stats()["parked_total"] > 0


@pytest.mark.parametrize("park_groups_per_poll", [0, 1])
def test_paged_prefix_cache_greedy_matches_jax(models, park_groups_per_poll):
    """Paged engine with the prefix cache: suffix candidates (two more takes
    on the shared 40-token prefix of request 0, admitted at once) take the
    queued path, attaches write fresh blocks and register them; ids equal
    JAX's, blocks balance."""
    prompts, budgets = _load(11, 10)
    shared = np.random.default_rng(12).integers(1, VOCAB, 40).astype(np.int32)
    for i in (0, 6, 7):
        prompts[i] = np.concatenate([shared, prompts[i]])
    kw = dict(max_batch=2, max_len=128, block_size=32, steps_per_dispatch=4,
              enable_prefix_cache=True, prefill_ahead=True, park_rows=4,
              park_groups_per_poll=park_groups_per_poll)
    jids, jout = _run(_engine(models, True, True, **kw), prompts, budgets)
    eng = _engine(models, False, True, **kw)
    ids, out = _run(eng, prompts, budgets)
    ref_ids, ref = _run(_engine(models, False, True, **{**kw, "prefill_ahead": False}),
                        prompts, budgets)
    assert _tokens(ids, out) == _tokens(jids, jout) == _tokens(ref_ids, ref)
    st = eng.stats()
    assert st["parked_total"] > 0 and st["free_park_rows"] == 4
    assert eng._suffix_admissions > 0 and eng.prefix_cache_hits > 0
    assert len(eng._free_blocks) + len(eng._evictable) == eng.num_blocks - 1
    assert st["used_blocks"] == 0


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_requests_complete_at_park(models, paged):
    """A budget of 1, and a preview that is the request's EOS, complete at
    park time: one token, no slot, the park row back on the free list."""
    prompts, budgets = _load(7, 6, budget_one_at=(3,))
    kw = dict(max_batch=1, max_len=128, steps_per_dispatch=4, prefill_ahead=True,
              park_rows=3)
    if paged:
        kw["block_size"] = 32
    # the first token request 4 gets, from a free run, becomes its EOS
    free_ids, free = _run(_engine(models, False, paged, **kw), prompts, budgets)
    eos = int(free[free_ids[4]].tokens[0])
    eng = _engine(models, False, paged, **kw)
    ids = [eng.submit(p, b, eos_id=eos if i == 4 else -1, sampling_seed=100 + i)
           for i, (p, b) in enumerate(zip(prompts, budgets))]
    admitted = eng.poll()  # request 0 takes the slot, 1-3 park
    done = {c.request_id: c for c in admitted + eng.run()}
    assert list(done[ids[3]].tokens) == list(free[free_ids[3]].tokens)
    assert done[ids[3]].finish_reason == "length" and len(done[ids[3]].tokens) == 1
    assert list(done[ids[4]].tokens) == [eos] and done[ids[4]].finish_reason == "eos"
    for i in (0, 1, 2, 5):
        assert list(done[ids[i]].tokens) == list(free[free_ids[i]].tokens)
    assert eng.stats()["free_park_rows"] == 3 and eng.first_token_times == {}


def _saturated(models, park_rows=2):
    eng = _engine(models, False, max_batch=1, max_len=128, steps_per_dispatch=4,
                  prefill_ahead=True, park_rows=park_rows)
    occupant = eng.submit(np.arange(3, 20, dtype=np.int32), 30, eos_id=-1)
    return eng, occupant


def test_cancel_parked_request(models):
    eng, occupant = _saturated(models)
    victim = eng.submit(np.array([5, 6, 7], np.int32), 20, eos_id=-1)
    other = eng.submit(np.array([9, 10, 11], np.int32), 12, eos_id=-1)
    done = list(eng.poll())  # occupant admitted, victim and other parked
    assert eng.stats()["parked_requests"] == 2
    assert victim in eng.first_token_times
    assert eng.cancel(victim) and not eng.cancel(victim)
    assert victim not in eng.first_token_times
    done += eng.run()
    by_id = {c.request_id: c for c in done}
    assert set(by_id) == {occupant, other}
    ref = _engine(models, False, max_batch=1, max_len=128, steps_per_dispatch=4)
    [want] = ref.generate_all([np.array([9, 10, 11], np.int32)], 12, -1, seed=0)
    assert list(by_id[other].tokens) == list(want.tokens)
    assert eng.stats()["free_park_rows"] == 2 and not eng.has_work()


def test_cancel_pending_park_group(models):
    """Cancel while the park group's previews are unread: the member drops
    out, its row recycles, the others are unaffected."""
    eng, occupant = _saturated(models, park_rows=4)
    victim = eng.submit(np.array([5, 6, 7], np.int32), 20, eos_id=-1)
    other = eng.submit(np.array([9, 10, 11], np.int32), 12, eos_id=-1)
    eng._admit()  # admits the occupant, queues the park groups of victim and other
    assert [len(g) for g in eng._pending_parks] == [1, 1] and eng.has_work()
    assert eng.cancel(victim)
    assert [len(g) for g in eng._pending_parks] == [0, 1]
    assert eng.stats()["free_park_rows"] == 3
    by_id = {c.request_id: c for c in eng.run()}
    assert set(by_id) == {occupant, other}
    assert eng.stats()["parked_total"] == 1 and eng.stats()["free_park_rows"] == 4


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_warmup_runs_park_and_attach_and_changes_nothing(models, paged):
    prompts, budgets = _load(8, 8)
    kw = dict(max_batch=2, max_len=128, steps_per_dispatch=4, sp=SAMPLED,
              prefill_ahead=True, park_rows=4)
    if paged:
        kw["block_size"] = 32
    eng = _engine(models, False, paged, **kw)
    eng.warmup(prompt_buckets=(64,))
    assert not bool(eng.active.any()) and not eng.has_work()
    st = eng.stats()
    assert (st["parked_total"], st["completed_requests"], st["generated_tokens"],
            st["free_park_rows"], eng._park_groups, eng._prefill_groups) == (0, 0, 0, 4, 0, 0)
    ids, out = _run(eng, prompts, budgets)
    ref_ids, ref = _run(_engine(models, False, paged, **kw), prompts, budgets)
    assert _tokens(ids, out) == _tokens(ref_ids, ref)
    with pytest.raises(RuntimeError, match="idle"):
        eng.submit(prompts[0], 4, -1)
        eng.warmup()


def test_stats_keys(models):
    kw = dict(max_batch=2, max_len=128)
    plain = _engine(models, False, **kw).stats()
    parked = _engine(models, False, prefill_ahead=True, **kw)
    st = parked.stats()
    assert set(st) - set(plain) == {"parked_requests", "free_park_rows", "park_rows",
                                    "parked_total"}
    assert (st["park_rows"], st["free_park_rows"], parked.park_len) == (2, 2, 128)
    paged = _engine(models, False, True, block_size=32, prefill_ahead=True, park_len=100,
                    park_rows=3, **kw)
    assert paged.park_len == 64 and paged.stats()["park_rows"] == 3
    assert tuple(paged.park_cache["k"].shape) == (2, 3, 64, 2, 16)
    assert tuple(paged.park_counts.shape) == (3, VOCAB)


def test_preview_mismatch_raises(models):
    """The host holds the decode's re-derivation to the preview, with an
    error that ``python -O`` keeps: here the attached slot's logits row is
    moved off the preview after the attach."""
    eng, _ = _saturated(models)
    eng.submit(np.array([5, 6, 7], np.int32), 20, eos_id=-1)
    attach = eng._attach_program

    def skewed(group):
        attach(group)
        for slot, entry, _ in group:
            eng.last_logits[slot] = float("-inf")
            eng.last_logits[slot, (entry.first_token + 1) % VOCAB] = 0.0

    eng._attach_program = skewed
    with pytest.raises(RuntimeError, match="park preview"):
        eng.run()


@pytest.mark.parametrize("row", [
    dict(temperature=0.0, top_k=0, top_p=1.0, repetition_penalty=1.0, frequency_penalty=0.0),
    dict(temperature=0.0, top_k=5, top_p=1.0, repetition_penalty=1.5, frequency_penalty=2.0),
    dict(temperature=0.7, top_k=1, top_p=1.0, repetition_penalty=1.3, frequency_penalty=0.5),
    dict(temperature=1e-4, top_k=50, top_p=0.3, repetition_penalty=0.8, frequency_penalty=-3.0),
    dict(temperature=5.0, top_k=0, top_p=0.999, repetition_penalty=2.0, frequency_penalty=9.0),
], ids=["greedy", "greedy_penalties", "top_k_1", "top_p_small_t", "top_p_hot"])
def test_one_hot_row_survives_the_rowwise_sampler(row):
    """An attach's logits row (0 at the preview, -inf elsewhere) through
    ``adjusted_logits_batched`` and ``sample_token_batched``: the one entry
    stays finite, nothing turns NaN, and every key draws the preview."""
    b, v, tok = 64, 300, 137
    logits = torch.full((b, v), float("-inf"))
    logits[:, tok] = 0.0
    counts = torch.randint(0, 3, (b, v), generator=torch.Generator().manual_seed(0),
                           dtype=torch.int32)
    bsp = ts.BatchedSamplingParams.broadcast(ts.SamplingParams(**row), b, max_top_k=64,
                                             device="cpu")
    al = ts.adjusted_logits_batched(logits, bsp, counts, counts)
    assert not torch.isnan(al).any()
    assert torch.isfinite(al[:, tok]).all() and bool((al.isfinite().sum(-1) == 1).all())
    keys = torch.stack([torch.arange(b) * 7919, torch.arange(b) % 5], dim=1)
    assert (ts.sample_token_batched(keys, logits, bsp, counts, counts) == tok).all()
