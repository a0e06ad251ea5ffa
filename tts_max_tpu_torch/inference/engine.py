"""Continuous-batching inference engine (counterpart of
``tts_max_tpu/inference/engine.py``).

- A fixed pool of ``max_batch`` slots shares one KV cache: contiguous
  ``[L, max_batch, max_len, Hkv, D]`` in ``InferenceEngine`` (decode through
  kernel C, the ragged kernel, or kernel B with int8 KV), a block pool in
  ``PagedInferenceEngine`` (decode through the paged kernel).
- Queued requests are admitted between decode dispatches in groups: a FIFO
  run of requests prefills as one ``[k, bucket]`` batch (kernel A), and every
  per-slot state row (KV, first logits, lengths, counters, request metadata,
  sampling rows) is written on the device right behind it.
- A dispatch runs ``steps_per_dispatch`` (K) lockstep decode steps over all
  slots (idle ones masked). EOS and budget finish on the device, and the host
  reads back one ``[2K+1, B]`` int32 blob per dispatch (K token rows, K
  emitted rows, the final active row), copied to pinned memory behind an
  event: that event is the dispatch's only host sync.
- ``poll()`` and ``run()`` pipeline dispatches: dispatch N+1 is queued before
  dispatch N's blob is read. A slot freed in dispatch N is masked in N+1 on
  the device, and re-admitted one dispatch later.
- ``prefill_ahead``: while the pool is full, queued requests prefill into a
  separate park buffer and their first token (the preview) reaches the host
  at once; when a slot frees, the parked K/V rows attach to it with a copy.

All per-slot state lives on the device and is updated in place, in stream
order, so the functional state chain of the JAX engine needs no copies
here. Sampling is per row (``ops.sampling.sample_token_batched``): each
slot draws its noise from a counter-based generator keyed by its request's
seed and the number of tokens it has generated, so a request's tokens do not
depend on which other requests share the pool, nor on K or pipelining.

``mesh``: tensor-parallel serving (the JAX engines' ``mesh=``). With a mesh
that splits ``tensor`` the engine takes this rank's blocks of the params
(``parallel.sharding.ShardLayout(full, mesh).shard(full)``; so does
``update_params``), runs the layers tensor-parallel (``parallel/tensor.py``)
and allocates every KV cache (the pool, int8 ``q`` and ``scale``, the
prefill and park caches) with the rank's ``n_kv_heads/t`` heads, or all of
them where the heads do not divide (JAX's engine then replicates the KV).
The decode kernels (C, B, and the paged kernel D, where JAX falls back to
XLA's gather attention under a mesh) run per rank on the local heads.
Per-slot state, sampling and every host decision are the same on every rank
of the group: each rank ends a step with the same logits. Every rank runs
the same calls (submit, poll, cancel) in the same order.

Left out of this port, with the constructor arguments that exist only for
them (they are not accepted):
- ``delta_kv`` and the paged ``persistent_read_cache``: they keep XLA from
  copying a loop-carried cache; here the decode step writes its K/V rows in
  place;
- ``staged_cache`` and ``min_stage``: the decode kernels' trip counts follow
  each slot's length, so reads follow occupancy without staging.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import itertools
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from tts_max_tpu_torch.device import resolve_device
from tts_max_tpu_torch.models import llama
from tts_max_tpu_torch.ops import cuda_build, sampling
from tts_max_tpu_torch.ops.sampling import SamplingParams
from tts_max_tpu_torch.parallel.tensor import TensorParallel


@dataclass
class Request:
    request_id: int
    prompt_tokens: np.ndarray  # [S] int32
    max_new_tokens: int
    eos_id: int
    sampling_seed: int = 0
    # per-request override of the engine's SamplingParams; None = default
    sampling: SamplingParams | None = None
    # EOS is unsampleable until this many tokens are generated
    min_tokens: int = 0


@dataclass
class Completion:
    request_id: int
    tokens: np.ndarray  # generated ids (eos included if emitted)
    finish_reason: str  # "eos" | "length"
    # host clock (time.perf_counter) when the first token reached the host
    first_token_time: float | None = None


@dataclass
class _Slot:
    request: Request | None = None
    generated: list[int] = field(default_factory=list)
    # attached from the park buffer: the first token was emitted at park
    # time, and the next blob row of this slot re-derives it; the host checks
    # and consumes that row without appending
    skip_preview: bool = False


@dataclass
class _Parked:
    """A request prefilled ahead of slot availability: its K/V rows live in
    park row ``row`` and its first token is already emitted."""

    row: int
    request: Request
    first_token: int


def _bucket(n: int, step: int = 64) -> int:
    return max(step, ((n + step - 1) // step) * step)


class _Blob:
    """A small int32 result on its way to the host (a dispatch's [2K+1, B]
    blob, or the park previews): on a card, copied into pinned memory behind
    an event (no sync until ``get``)."""

    def __init__(self, blob: torch.Tensor):
        if blob.device.type == "cpu":
            self._host, self._event = blob, None
            return
        self._host = torch.empty(blob.shape, dtype=blob.dtype, pin_memory=True)
        self._host.copy_(blob, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record()

    def get(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class InferenceEngine:
    def __init__(
        self,
        params: Any,
        cfg: llama.LlamaConfig,
        *,
        max_batch: int = 8,
        max_len: int = 2048,
        sp: SamplingParams = SamplingParams(),
        pad_id: int = 0,
        quantized_kv: bool = False,
        vocab_window: tuple[int, int] | None = None,
        max_top_k: int = 64,
        steps_per_dispatch: int = 1,
        prefill_group_sizes: tuple[int, ...] = (8, 4, 2, 1),
        admission_policy: str = "fifo",
        prefill_ahead: bool = False,
        park_rows: int | None = None,
        park_len: int | None = None,
        park_groups_per_poll: int = 0,
        device="cuda",
        mesh=None,
    ):
        """``vocab_window=(lo, size)`` constrains sampling to ids [lo,
        lo+size) (``SpeechVocab.generation_window()`` for TTS): logits and
        penalty counts are window-sized, emitted ids stay global.
        ``prefill_group_sizes``: queued requests prefill together in groups
        of these sizes (largest fitting first; 1 is always added).
        ``admission_policy``: ``"fifo"`` (arrival order) or ``"shortest"``
        (shortest prompt + budget first; long requests can starve under
        sustained overload). ``max_top_k`` bounds every row's top-k.
        ``device``: the card unless the caller asks for ``"cpu"``, where the
        kernels' plain versions run.

        ``prefill_ahead``: while the pool is full, prefill queued requests
        into a park buffer (a contiguous cache of ``park_rows`` rows, default
        ``max_batch``, of ``park_len`` tokens, default ``min(512, max_len)``
        floored to the prompt bucket step) and emit their first token at
        once. It is sampled with exactly the inputs the decode's first step
        will see (the key (seed, 0), the prompt counts, no generated
        counts); the attach sets the slot's logits row to a one-hot over that
        token, so the decode re-emits it whatever the noise and penalties,
        and the host consumes the duplicate. Requests with ``min_tokens``,
        prompts longer than ``park_len`` and prefix-cache hits take the
        queued path. ``park_groups_per_poll`` caps the park groups a poll
        runs (0: as many as the free park rows take)."""
        self.device = resolve_device(device)
        if llama.params_device(params) != self.device:
            raise ValueError(f"params live on {llama.params_device(params)}, "
                             f"not on {self.device}")
        if admission_policy not in ("fifo", "shortest"):
            raise ValueError(f"unknown admission_policy {admission_policy!r}")
        if steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        self.params = params
        self.cfg = cfg
        self.tp = TensorParallel.create(cfg, mesh, params)
        self.max_batch = max_batch
        self.max_len = max_len
        self.sp = sp
        self.pad_id = pad_id
        self.quantized_kv = quantized_kv
        self.steps_per_dispatch = steps_per_dispatch
        self.admission_policy = admission_policy
        self.prefill_group_sizes = tuple(
            sorted({g for g in prefill_group_sizes if g <= max_batch} | {1},
                   reverse=True)
        )
        self.vocab_window = vocab_window
        self._lo = vocab_window[0] if vocab_window else 0
        self._head = (llama.slice_logits_head(params, cfg, *vocab_window, tp=self.tp)
                      if vocab_window else None)
        width = vocab_window[1] if vocab_window else cfg.vocab_size

        dev = self.device
        self.cache = self._make_cache()
        self.lengths = torch.zeros(max_batch, dtype=torch.int32, device=dev)
        self.last_logits = torch.zeros(max_batch, width, device=dev)
        self.active = torch.zeros(max_batch, dtype=torch.bool, device=dev)
        self.token_counts = torch.zeros(max_batch, width, dtype=torch.int32, device=dev)
        self.gen_counts = torch.zeros_like(self.token_counts)
        self.seeds = torch.zeros(max_batch, dtype=torch.int64, device=dev)
        self.eos_ids = torch.full((max_batch,), -1, dtype=torch.int32, device=dev)
        self.budgets = torch.zeros(max_batch, dtype=torch.int32, device=dev)
        self.min_tokens = torch.zeros(max_batch, dtype=torch.int32, device=dev)
        self.prompt_lens = torch.zeros(max_batch, dtype=torch.int32, device=dev)
        self.bsp = sampling.BatchedSamplingParams.broadcast(
            sp, max_batch, max_top_k=max(max_top_k, sp.top_k, 1), device=dev)
        self._rows = torch.arange(max_batch, device=dev)
        # first-token host times of requests in flight; an entry moves into
        # its Completion (or is dropped on cancel), so the dict stays bounded
        self.first_token_times: dict[int, float] = {}

        self._slots = [_Slot() for _ in range(max_batch)]
        self._queue: collections.deque[Request] = collections.deque()
        self._finished: list[Completion] = []
        self._total_tokens = 0
        self._total_completions = 0
        self._stage_counts: collections.Counter = collections.Counter()
        self._pending_dispatch = None  # (blob, slot snapshot) under poll()
        self._ids = itertools.count()
        # group prefills and park groups (kernel A) and suffix admissions (no
        # kernel) run
        self._prefill_groups = 0
        self._park_groups = 0
        self._suffix_admissions = 0

        self.prefill_ahead = prefill_ahead
        self._parked_entries: collections.deque[_Parked] = collections.deque()
        # park groups whose previews the host has not read: lists of (park
        # row, request), all covered by one copy of the preview row
        self._pending_parks: list[list[tuple[int, Request]]] = []
        self._park_blob: _Blob | None = None
        self._parked_total = 0  # requests prefilled ahead, lifetime
        if prefill_ahead:
            self.park_groups_per_poll = park_groups_per_poll
            self.park_rows = park_rows or max_batch
            step = self._bucket_step()
            self.park_len = max(step, (min(park_len or min(512, max_len), max_len)
                                       // step) * step)
            self.park_cache = llama.init_kv_cache(cfg, self.park_rows, self.park_len,
                                                  quantized=quantized_kv, device=dev,
                                                  tp=self.tp)
            self.park_counts = torch.zeros(self.park_rows, width, dtype=torch.int32,
                                           device=dev)
            self.park_preview = torch.zeros(self.park_rows, dtype=torch.int32, device=dev)
            self._free_park_rows = list(range(self.park_rows))

    # --- public API ---------------------------------------------------------

    def submit(
        self,
        prompt_tokens,
        max_new_tokens: int,
        eos_id: int,
        sampling_seed: int = 0,
        sampling: SamplingParams | None = None,
        min_tokens: int = 0,
    ) -> int:
        prompt = np.asarray(prompt_tokens, dtype=np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError(f"prompt must be a non-empty 1-D id list, got {prompt.shape}")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        rid = next(self._ids)
        self._queue.append(Request(rid, prompt, max_new_tokens, eos_id,
                                   sampling_seed, sampling, min_tokens))
        return rid

    def update_params(self, params: Any) -> None:
        """Serve ``params`` from now on (new weights of the same shapes, on
        the engine's device): the parameter tree and the vocab window's
        slice of the head, which the engine keeps from construction. The
        caches and slots are left as they are; call it between runs."""
        if llama.params_device(params) != self.device:
            raise ValueError(f"params live on {llama.params_device(params)}, "
                             f"not on {self.device}")
        self.params = params
        if self.vocab_window:
            self._head = llama.slice_logits_head(params, self.cfg, *self.vocab_window,
                                                 tp=self.tp)

    def has_work(self) -> bool:
        return (bool(self._queue) or bool(self._parked_entries)
                or bool(self._pending_parks) or any(s.request for s in self._slots)
                or self._pending_dispatch is not None)

    def cancel(self, request_id: int) -> bool:
        """Abort a request: drop it from the queue or the park buffer, or
        free its slot mid-flight (partial output is discarded). False if the
        id is unknown or already finished."""
        for i, req in enumerate(self._queue):
            if req.request_id == request_id:
                del self._queue[i]
                return True
        for i, entry in enumerate(self._parked_entries):
            if entry.request.request_id == request_id:
                del self._parked_entries[i]
                self._free_park_rows.append(entry.row)
                self.first_token_times.pop(request_id, None)
                return True
        for group in self._pending_parks:
            for j, (row, req) in enumerate(group):
                if req.request_id == request_id:
                    # its park program is queued: the preview is read by row,
                    # so dropping the member is enough, and the row's writes
                    # become dead rows that the next park of the row rewrites
                    del group[j]
                    self._free_park_rows.append(row)
                    return True
        for i, slot in enumerate(self._slots):
            if slot.request is not None and slot.request.request_id == request_id:
                slot.request = None
                slot.generated = []
                slot.skip_preview = False
                self.first_token_times.pop(request_id, None)
                self.active[i].fill_(False)  # a scalar fill: no host sync
                if self._pending_dispatch is not None:
                    # the dispatch in flight still writes this slot's KV
                    # through its old table row: keep the blocks until its
                    # blob is read
                    self._defer_release(i)
                else:
                    self._release_slot(i)
                return True
        return False

    def step(self) -> list[Completion]:
        """Admit queued requests into free slots, run one dispatch (K
        lockstep steps) and read its blob at once; collect completions."""
        self._admit()
        self._process_pending_park()
        if any(s.request for s in self._slots):
            self._process_decode_blob(*self._dispatch_decode())
        out, self._finished = self._finished, []
        return out

    def poll(self) -> list[Completion]:
        """One pipelined serving iteration: admit, queue the next dispatch,
        then read the previous dispatch's blob (the host waits only for
        that one while the new one runs). The dispatch in flight lives on
        the engine (``has_work()`` counts it), so callers may ``submit`` and
        ``cancel`` between polls."""
        if self.steps_per_dispatch <= 1:
            return self.step()
        self._admit()
        dispatched = None
        if any(s.request for s in self._slots):
            dispatched = self._dispatch_decode()
        pending, self._pending_dispatch = self._pending_dispatch, dispatched
        if pending is not None:
            self._process_decode_blob(*pending)
            self._flush_deferred_releases()  # blocks held by cancel() are free now
        # this poll's park previews were copied behind the park programs,
        # which the stream ran before the dispatch just queued: reading them
        # now waits for no decode work
        self._process_pending_park()
        out, self._finished = self._finished, []
        return out

    def run_iter(self):
        """Drive to completion, yielding each poll's completions (may be
        empty)."""
        while self.has_work():
            yield self.poll()

    def run(self) -> list[Completion]:
        """Drive to completion (pipelined when steps_per_dispatch > 1)."""
        done: list[Completion] = []
        for batch in self.run_iter():
            done.extend(batch)
        return done

    def stats(self) -> dict:
        """Slot and queue occupancy and lifetime counters."""
        out = {
            "active_slots": sum(1 for s in self._slots if s.request is not None),
            "max_batch": self.max_batch,
            "queued_requests": len(self._queue),
            "tokens_in_flight": sum(len(s.generated) for s in self._slots if s.request),
            "completed_requests": self._total_completions,
            "generated_tokens": self._total_tokens,
            # one stage, the full max_len: there is no staged cache here
            "dispatches_per_stage": dict(self._stage_counts),
        }
        if self.prefill_ahead:
            out.update(parked_requests=len(self._parked_entries),
                       free_park_rows=len(self._free_park_rows),
                       park_rows=self.park_rows, parked_total=self._parked_total)
        return out

    def generate_all(self, prompts, max_new_tokens: int, eos_id: int,
                     seed: int = 0) -> list[Completion]:
        ids = [self.submit(p, max_new_tokens, eos_id, sampling_seed=seed + i)
               for i, p in enumerate(prompts)]
        by_id = {c.request_id: c for c in self.run()}
        return [by_id[i] for i in ids]

    @torch.no_grad()
    def warmup(self, prompt_buckets: tuple[int, ...] = (64, 256)) -> None:
        """Build the kernels, run one dummy group prefill per prompt bucket
        (into a throwaway cache) and one decode dispatch over the idle pool.
        Nothing a later admission reads changes: idle slots' K/V writes land
        in their own dead rows (contiguous) or the sink block (paged), their
        counters do not move, and nothing is counted in ``stats()``. Call it
        on an idle engine."""
        if self.has_work():
            raise RuntimeError("warmup() needs an idle engine")
        if self.device.type == "cuda":
            cuda_build.build_all()
        g = max(self.prefill_group_sizes)
        for bucket in sorted({_bucket(b, self._bucket_step()) for b in prompt_buckets}):
            small = llama.init_kv_cache(self.cfg, g, bucket, quantized=self.quantized_kv,
                                        device=self.device, tp=self.tp)
            tokens = torch.zeros(g, bucket, dtype=torch.int32, device=self.device)
            ones = torch.ones(g, dtype=torch.int32, device=self.device)
            llama.prefill(self.params, self.cfg, tokens, ones, small, self._head, tp=self.tp)
        if self.prefill_ahead:
            # one park group into the first park rows (a park writes every
            # row that an attach of it reads) and one attach of row 0 into
            # slot 0, deactivated at once: the next admission into the slot
            # writes every state row again, and the decode below writes only
            # the slot's dead row (the sink block when paged: no blocks)
            dummies = [Request(-1, np.ones(1, np.int32), 2, -1)
                       for _ in range(min(g, self.park_rows))]
            self._park_program(list(enumerate(dummies)))
            self._attach_program([(0, _Parked(0, dummies[0], self._lo), {"blocks": []})])
            self.active.index_fill_(0, self._rows[:1], False)
        self._decode_multi(1)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --- internals ----------------------------------------------------------

    def _make_cache(self):
        return llama.init_kv_cache(self.cfg, self.max_batch, self.max_len,
                                   quantized=self.quantized_kv, device=self.device, tp=self.tp)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host array to the engine's device without a host sync: through
        pinned memory, copied in stream order (the caching host allocator
        keeps the pinned buffer until the copy is done)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _bucket_step(self) -> int:
        return 64

    def _can_admit(self, req: Request) -> bool:
        return True

    def _release_slot(self, slot_idx: int) -> None:
        pass

    def _defer_release(self, slot_idx: int) -> None:
        self._release_slot(slot_idx)  # contiguous: a slot's rows are its own

    def _flush_deferred_releases(self) -> None:
        pass

    def _table_device(self):
        """Block table for the paged engine; None selects contiguous decode."""
        return None

    def _prepare_slot(self, slot_idx: int, req: Request) -> dict:
        """Reserve host-side resources for an admission (paged: KV blocks)
        before the device prefill, so later _can_admit calls see the truth."""
        return {}

    def _wants_suffix(self, req: Request) -> bool:
        """True when this request takes the prefix-cache suffix path."""
        return False

    def _register_prefix(self, slot_idx: int, req: Request, ctx: dict) -> None:
        pass

    def _admit_suffix(self, slot_idx: int, req: Request) -> None:
        raise NotImplementedError  # paged only

    def _prompt_counts(self, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.vocab_window is not None:
            return sampling.counts_from_tokens_windowed(tokens, mask, self.vocab_window)
        return sampling.counts_from_tokens(tokens, mask, self.cfg.vocab_size)

    def _meta(self, slots, reqs) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-row admission metadata, uploaded as one int64 matrix (slot,
        prompt length, eos, budget, min_tokens, top_k, seed) and one fp32
        matrix (temperature, top_p, repetition and frequency penalties)."""
        ints, floats = [], []
        for slot, r in zip(slots, reqs):
            sp = r.sampling or self.sp
            ints.append([slot, len(r.prompt_tokens), r.eos_id, r.max_new_tokens,
                         r.min_tokens, sp.top_k, r.sampling_seed & 0xFFFFFFFF])
            floats.append([sp.temperature, sp.top_p, sp.repetition_penalty,
                           sp.frequency_penalty])
        return (self._upload(np.asarray(ints, dtype=np.int64)),
                self._upload(np.asarray(floats, dtype=np.float32)))

    def _write_slot_state(self, meta_i, meta_f, logits, counts) -> None:
        """Admission: every per-slot state row of the slots in ``meta_i``."""
        slots, ns = meta_i[:, 0], meta_i[:, 1].int()
        self.token_counts[slots] = counts
        # scalar fills through index_fill_: `x[idx] = 0` would copy the scalar
        # to the card and wait for it
        self.gen_counts.index_fill_(0, slots, 0)
        self.last_logits[slots] = logits
        self.lengths[slots] = ns
        self.prompt_lens[slots] = ns
        self.active.index_fill_(0, slots, True)
        self.eos_ids[slots] = meta_i[:, 2].int()
        self.budgets[slots] = meta_i[:, 3].int()
        self.min_tokens[slots] = meta_i[:, 4].int()
        self.bsp.top_k[slots] = meta_i[:, 5].int()
        self.seeds[slots] = meta_i[:, 6]
        self.bsp.temperature[slots] = meta_f[:, 0]
        self.bsp.top_p[slots] = meta_f[:, 1]
        self.bsp.repetition_penalty[slots] = meta_f[:, 2]
        self.bsp.frequency_penalty[slots] = meta_f[:, 3]

    def _enable_top_p(self, req: Request) -> None:
        """Turn the nucleus filter's [B, V] sort on for a request that uses
        it (it stays on)."""
        sp = req.sampling or self.sp
        if sp.top_p < 1.0 and not self.bsp.use_top_p:
            self.bsp = dataclasses.replace(self.bsp, use_top_p=True)

    def _activate_host(self, slot_idx: int, req: Request) -> None:
        self._enable_top_p(req)
        slot = self._slots[slot_idx]
        slot.request = req
        slot.generated = []
        slot.skip_preview = False

    def _scatter_prefill(self, small, slots: torch.Tensor, bucket: int, items) -> None:
        """Write a group's prefill rows into its slots (contiguous layout)."""
        def leaf(big, little):
            big[:, slots, :bucket] = little.to(big.dtype)

        llama._map(leaf, self.cache, small)

    def _prefill_rows(self, rows: list[int], reqs: list[Request], bucket: int):
        """One batched prefill (kernel A) of ``reqs``' prompts, right-padded
        to ``bucket``. Returns the admission metadata of ``rows`` (slots or
        park rows), the last prompt position's logits, the [k, bucket]
        cache and the prompt counts."""
        padded = np.zeros((len(reqs), bucket), dtype=np.int32)
        for i, req in enumerate(reqs):
            padded[i, :len(req.prompt_tokens)] = req.prompt_tokens
        meta_i, meta_f = self._meta(rows, reqs)
        tokens = self._upload(padded)
        ns = meta_i[:, 1].int()
        small = llama.init_kv_cache(self.cfg, len(reqs), bucket, quantized=self.quantized_kv,
                                    device=self.device, tp=self.tp)
        logits, small = llama.prefill(self.params, self.cfg, tokens, ns, small,
                                      logits_head=self._head, tp=self.tp)
        mask = torch.arange(bucket, device=self.device)[None, :] < ns[:, None]
        return meta_i, meta_f, logits, small, self._prompt_counts(tokens, mask)

    @torch.no_grad()
    def _prefill_group(self, items: list[tuple[int, Request, dict]]) -> None:
        """One batched prefill (kernel A) for ``items`` (all plain
        admissions), then the slots' state rows."""
        bucket = max(_bucket(len(r.prompt_tokens), self._bucket_step())
                     for _, r, _ in items)
        for slot_idx, req, _ in items:
            self._activate_host(slot_idx, req)  # may set bsp.use_top_p
        meta_i, meta_f, logits, small, counts = self._prefill_rows(
            [s for s, _, _ in items], [r for _, r, _ in items], bucket)
        self._scatter_prefill(small, meta_i[:, 0], bucket, items)
        self._write_slot_state(meta_i, meta_f, logits, counts)
        self._prefill_groups += 1
        for slot_idx, req, ctx in items:
            self._register_prefix(slot_idx, req, ctx)

    def _admit(self) -> None:
        if self.admission_policy == "shortest" and len(self._queue) > 1:
            # stable: arrival order within a size class
            self._queue = collections.deque(sorted(
                self._queue, key=lambda r: len(r.prompt_tokens) + r.max_new_tokens))
        # parked requests left the queue earlier, so they stand ahead of it:
        # they attach into free slots first, and while one waits (no slot, or
        # no blocks when paged) the queue does not jump ahead of it
        self._attach_parked()
        if not self._parked_entries:
            self._admit_queue()
        self._park_ahead()  # the pool is still full: prefill ahead

    def _admit_queue(self) -> None:
        while self._queue:
            free = [i for i, s in enumerate(self._slots) if s.request is None]
            if not free:
                return
            head = self._queue[0]
            n = len(head.prompt_tokens)
            if n + head.max_new_tokens > self.max_len:
                self._queue.popleft()
                raise ValueError(
                    f"request {head.request_id}: prompt {n} + budget "
                    f"{head.max_new_tokens} exceeds max_len {self.max_len}")
            if not self._can_admit(head):
                return  # FIFO: wait for resources rather than skip ahead
            if self._wants_suffix(head):
                self._queue.popleft()
                self._admit_suffix(free[0], head)
                continue
            # a FIFO run of plain admissible requests; resources are reserved
            # per request, so _can_admit stays truthful within the run
            group: list[tuple[int, Request, dict]] = []
            cap = min(len(free), max(self.prefill_group_sizes))
            while self._queue and len(group) < cap:
                req = self._queue[0]
                if len(req.prompt_tokens) + req.max_new_tokens > self.max_len:
                    break  # raised on the next outer iteration
                if self._wants_suffix(req) or not self._can_admit(req):
                    break
                self._queue.popleft()
                slot_idx = free[len(group)]
                group.append((slot_idx, req, self._prepare_slot(slot_idx, req)))
            i = 0
            while i < len(group):
                g = next(s for s in self.prefill_group_sizes if s <= len(group) - i)
                self._prefill_group(group[i:i + g])
                i += g

    # --- prefill-ahead: park and attach --------------------------------------
    # The stream runs the engine's device work in the order the host queues
    # it, and every state row is written in place, so two rules hold by
    # stream order alone:
    # - an attach targets only a slot the host freed from a blob it has read,
    #   as an admission does: the dispatch queued after that blob already
    #   ran the slot masked, and the attach's writes follow it;
    # - a park row returns to the free list once its attach is queued, and a
    #   later park program that rewrites the row is queued after that
    #   attach's copy, so the copy reads the rows it was given.

    def _park_eligible(self, req: Request) -> bool:
        return (len(req.prompt_tokens) <= self.park_len and req.min_tokens == 0
                and len(req.prompt_tokens) + req.max_new_tokens <= self.max_len
                and not self._wants_suffix(req))

    def _park_ahead(self) -> None:
        """While the pool is full, prefill the eligible head of the queue
        into free park rows, a group at a time (at most
        ``park_groups_per_poll`` groups when it is set), and queue one copy of
        the preview row behind them for the host."""
        if not self.prefill_ahead:
            return
        n = 0
        while self._queue and self._free_park_rows:
            if not self._park_eligible(self._queue[0]):
                break
            if self.park_groups_per_poll and n >= self.park_groups_per_poll:
                break
            group: list[tuple[int, Request]] = []
            cap = min(len(self._free_park_rows), max(self.prefill_group_sizes))
            while self._queue and len(group) < cap and self._park_eligible(self._queue[0]):
                group.append((self._free_park_rows.pop(), self._queue.popleft()))
            self._park_program(group)
            self._pending_parks.append(group)
            self._park_groups += 1
            n += 1
        if n:
            # one read serves every pending group (the rows of a group
            # cancelled while pending are not read)
            self._park_blob = _Blob(self.park_preview)

    @torch.no_grad()
    def _park_program(self, group: list[tuple[int, Request]]) -> None:
        """One batched prefill (kernel A) of ``group``'s prompts into their
        park rows, their prompt counts, and the preview token of each row,
        sampled as the decode's first step samples it."""
        reqs = [r for _, r in group]
        for req in reqs:
            self._enable_top_p(req)  # before the preview: park and decode sample alike
        bucket = min(self.park_len,
                     max(_bucket(len(r.prompt_tokens), self._bucket_step()) for r in reqs))
        meta_i, meta_f, logits, small, counts = self._prefill_rows(
            [row for row, _ in group], reqs, bucket)
        rows = meta_i[:, 0]

        def leaf(big, little):
            big[:, rows, :bucket] = little.to(big.dtype)

        llama._map(leaf, self.park_cache, small)
        self.park_counts[rows] = counts
        bsp = sampling.BatchedSamplingParams(
            temperature=meta_f[:, 0], top_k=meta_i[:, 5].int(), top_p=meta_f[:, 1],
            repetition_penalty=meta_f[:, 2], frequency_penalty=meta_f[:, 3],
            max_top_k=self.bsp.max_top_k, use_top_p=self.bsp.use_top_p)
        # the decode's first step: key (seed, 0), no generated counts, and no
        # EOS block (min_tokens is 0 by eligibility)
        keys = torch.stack([meta_i[:, 6], torch.zeros_like(meta_i[:, 6])], dim=1)
        toks_w = sampling.sample_token_batched(keys, logits, bsp, counts,
                                               torch.zeros_like(counts))
        self.park_preview[rows] = (toks_w + self._lo).int()

    def _process_pending_park(self) -> None:
        """Read the previews of every pending park group (one read): a
        preview that is EOS, or a budget of 1, completes its request here
        and frees its park row; the rest become parked entries."""
        if not self._pending_parks:
            return
        pending, self._pending_parks = self._pending_parks, []
        preview, self._park_blob = self._park_blob.get(), None
        now = time.perf_counter()
        for group in pending:
            self._parked_total += len(group)
            for row, req in group:
                tok = int(preview[row])
                self._total_tokens += 1
                if tok == req.eos_id or req.max_new_tokens <= 1:
                    self._total_completions += 1
                    self._finished.append(Completion(
                        req.request_id, np.asarray([tok], dtype=np.int32),
                        "eos" if tok == req.eos_id else "length", now))
                    self._free_park_rows.append(row)
                else:
                    self.first_token_times[req.request_id] = now
                    self._parked_entries.append(_Parked(row, req, tok))

    def _can_attach(self, req: Request) -> bool:
        return True  # contiguous: a free slot is the only resource

    def _prepare_attach(self, slot_idx: int, req: Request) -> dict:
        return {}

    def _register_attach(self, slot_idx: int, req: Request, ctx: dict) -> None:
        pass

    def _attach_parked(self) -> None:
        while self._parked_entries:
            free = [i for i, s in enumerate(self._slots) if s.request is None]
            group: list[tuple[int, _Parked, dict]] = []
            while (self._parked_entries and len(group) < len(free)
                   and len(group) < max(self.prefill_group_sizes)
                   and self._can_attach(self._parked_entries[0].request)):
                entry = self._parked_entries.popleft()
                slot_idx = free[len(group)]
                group.append((slot_idx, entry, self._prepare_attach(slot_idx, entry.request)))
            if not group:
                return
            for slot_idx, entry, _ in group:
                self._activate_host(slot_idx, entry.request)  # may set bsp.use_top_p
                slot = self._slots[slot_idx]
                slot.generated = [entry.first_token]
                slot.skip_preview = True
            self._attach_program(group)
            for slot_idx, entry, ctx in group:
                self._free_park_rows.append(entry.row)
                self._register_attach(slot_idx, entry.request, ctx)

    def _attach_scatter(self, rows: torch.Tensor, slots: torch.Tensor, group) -> None:
        """Copy park rows' K/V into the slots' rows (contiguous layout)."""
        def leaf(big, parked):
            big[:, slots, :self.park_len] = parked[:, rows].to(big.dtype)

        llama._map(leaf, self.cache, self.park_cache)

    @torch.no_grad()
    def _attach_program(self, group: list[tuple[int, _Parked, dict]]) -> None:
        """Park rows into slots: a copy of their K/V rows (no recompute) and
        every per-slot state row, as an admission writes them, with the
        logits row a one-hot over the preview token (0 there, -inf
        elsewhere). Penalties, temperature, top-k/top-p and the noise all
        keep a single finite entry finite and the rest -inf, so the decode's
        first step re-emits the preview and forwards it."""
        entries = [e for _, e, _ in group]
        meta_i, meta_f = self._meta([s for s, _, _ in group], [e.request for e in entries])
        extra = self._upload(np.asarray([[e.row, e.first_token - self._lo] for e in entries],
                                        dtype=np.int64))
        rows = extra[:, 0]
        self._attach_scatter(rows, meta_i[:, 0], group)
        onehot = torch.full((len(group), self.last_logits.shape[1]), float("-inf"),
                            device=self.device)
        onehot.scatter_(1, extra[:, 1:], 0.0)
        self._write_slot_state(meta_i, meta_f, onehot, self.park_counts[rows])

    def _guard_lengths(self, lengths, active, table):
        """Write positions of the lockstep step. An inactive slot (idle,
        finished, cancelled) still writes a row, here row 0 of its own dead
        region. Active slots are within range by admission."""
        return torch.where(active, lengths, 0)

    def _decode_step(self, toks, lengths_w, table):
        # kernel C over a bf16/fp32 pool; kernel B over int8 KV (C has no
        # int8 form, in JAX as here)
        logits, _ = llama.decode_step(self.params, self.cfg, self.cache, toks,
                                      lengths_w, logits_head=self._head,
                                      ragged=not self.quantized_kv, tp=self.tp)
        return logits

    @torch.no_grad()
    def _decode_multi(self, ksteps: int) -> torch.Tensor:
        """``ksteps`` lockstep decode steps over the whole pool, all on the
        device with no host sync: sample (EOS masked on the raw logits while
        a slot is below its min_tokens), count, finish on EOS or budget,
        decode. Returns the [2K+1, B] int32 blob (K token rows, K emitted
        rows, the final active row)."""
        table = self._table_device()
        lo, width = self._lo, self.last_logits.shape[1]
        eos_w = self.eos_ids - lo
        eos_in_window = (eos_w >= 0) & (eos_w < width)
        eos_cols = eos_w.clamp(0, width - 1).long()
        rows = self._rows
        last_logits, lengths, active = self.last_logits, self.lengths, self.active
        toks_k, emitted_k = [], []
        for _ in range(ksteps):
            n_gen = lengths - self.prompt_lens
            blocked = eos_in_window & (n_gen < self.min_tokens)
            eos_logit = torch.where(blocked, float("-inf"), last_logits[rows, eos_cols])
            ll = last_logits.index_put((rows, eos_cols), eos_logit)
            keys = torch.stack([self.seeds, n_gen.long()], dim=1)
            toks_w = sampling.sample_token_batched(keys, ll, self.bsp, self.token_counts,
                                                   self.gen_counts)
            toks = torch.where(active, toks_w + lo, self.pad_id).int()
            inc = active.int()
            cidx = torch.where(active, toks_w, 0)  # in range; inc is 0 when idle
            self.token_counts.index_put_((rows, cidx), inc, accumulate=True)
            self.gen_counts.index_put_((rows, cidx), inc, accumulate=True)
            emitted = active
            active = active & ~((toks == self.eos_ids) | (n_gen + inc >= self.budgets))
            last_logits = self._decode_step(toks, self._guard_lengths(lengths, active, table),
                                            table)
            lengths = lengths + inc
            toks_k.append(toks)
            emitted_k.append(emitted)
        self.last_logits, self.lengths, self.active = last_logits, lengths, active
        return torch.cat([torch.stack(toks_k), torch.stack(emitted_k).int(),
                          active.int()[None]])

    def _dispatch_decode(self):
        """Queue one K-step dispatch. Returns (blob on its way to the host,
        the request id in each slot at dispatch time): under pipelining a
        blob is read after later admissions, so its rows are attributed to
        the occupants it was dispatched for."""
        self._stage_counts[self.max_len] += 1
        snapshot = [s.request.request_id if s.request is not None else None
                    for s in self._slots]
        return _Blob(self._decode_multi(self.steps_per_dispatch)), snapshot

    def _finish_token(self, slot_idx: int, tok: int) -> bool:
        """Append ``tok`` to the slot; complete the request if it ends it.
        Returns True when the slot was freed."""
        slot = self._slots[slot_idx]
        req = slot.request
        slot.generated.append(tok)
        if len(slot.generated) == 1:
            self.first_token_times[req.request_id] = time.perf_counter()
        self._total_tokens += 1
        if tok == req.eos_id or len(slot.generated) >= req.max_new_tokens:
            self._total_completions += 1
            self._finished.append(Completion(
                req.request_id, np.asarray(slot.generated, dtype=np.int32),
                "eos" if tok == req.eos_id else "length",
                self.first_token_times.pop(req.request_id, None)))
            slot.request = None
            slot.generated = []
            self._release_slot(slot_idx)
            return True
        return False

    def _process_decode_blob(self, blob: _Blob, snapshot) -> None:
        data = blob.get()  # the dispatch's one host sync
        k = (data.shape[0] - 1) // 2
        toks, emitted, active = data[:k], data[k:2 * k].astype(bool), data[2 * k] != 0
        freed = []
        for i, slot in enumerate(self._slots):
            if slot.request is None or slot.request.request_id != snapshot[i]:
                continue  # re-admitted (or cancelled) since this dispatch
            for j in range(k):
                if not emitted[j, i]:
                    continue
                if slot.skip_preview:
                    # the decode's first step of an attached slot re-emits the
                    # park preview (its logits row was a one-hot), which
                    # already ended no request: check it and consume it
                    slot.skip_preview = False
                    if int(toks[j, i]) != slot.generated[0]:
                        raise RuntimeError(
                            f"park preview {slot.generated[0]} != decode re-derivation "
                            f"{int(toks[j, i])} for request {slot.request.request_id} "
                            f"(slot {i})")
                    continue
                if self._finish_token(i, int(toks[j, i])):
                    freed.append(i)
                    break
        # the device finished slots on its own; both sides must agree, or
        # run() would spin (device-only finish) or drop output (host-only)
        stuck = [i for i, s in enumerate(self._slots)
                 if s.request is not None and s.request.request_id == snapshot[i]
                 and not active[i]]
        if any(active[i] for i in freed) or stuck:
            raise RuntimeError(f"device/host finish disagreement: host freed {freed}, "
                               f"device deactivated {stuck}")


class PagedInferenceEngine(InferenceEngine):
    """Continuous batching over a block-pool KV cache (vLLM paging).

    KV lives in ``num_blocks`` blocks of ``block_size`` tokens; a request
    reserves ``ceil(max(prompt + budget, prompt bucket) / block_size)``
    blocks at admission (so it never runs out mid-flight) and frees them
    when it finishes. Decode attention reads KV through the block table
    (``ops/paged_attention.py``). Block 0 is a reserved write sink, never
    allocated or cached: the lockstep step writes a K/V row for every slot,
    and idle, released and finished slots' rows land there.

    ``enable_prefix_cache=True`` adds automatic prefix caching: full prompt
    blocks are content-addressed by a chained blake2b hash (byte for byte
    the JAX engine's, so both hit the same blocks); an admitted request
    reuses every cached leading block (refcounted, shared by concurrent
    slots) and forwards only the uncovered suffix (``llama.decode_window``:
    plain torch, no kernel). Freed blocks stay cached (zero-ref, LRU
    evicted) until the pool needs them.
    """

    def __init__(
        self,
        params: Any,
        cfg: llama.LlamaConfig,
        *,
        num_blocks: int | None = None,
        block_size: int = 64,
        max_batch: int = 8,
        max_len: int = 2048,
        sp: SamplingParams = SamplingParams(),
        pad_id: int = 0,
        quantized_kv: bool = False,
        vocab_window: tuple[int, int] | None = None,
        enable_prefix_cache: bool = False,
        max_top_k: int = 64,
        steps_per_dispatch: int = 1,
        admission_policy: str = "fifo",
        prefill_ahead: bool = False,
        park_rows: int | None = None,
        park_len: int | None = None,
        park_groups_per_poll: int = 0,
        device="cuda",
        mesh=None,
    ):
        if max_len % block_size:
            raise ValueError("max_len must be a multiple of block_size")
        self.block_size = block_size
        # +1: block 0 is the sink, so the default still fits max_batch
        # full-length requests
        self.num_blocks = num_blocks or (max_batch * max_len) // block_size + 1
        self.table_width = max_len // block_size
        self._free_blocks = list(range(1, self.num_blocks))
        self._deferred_free: list[int] = []
        self._slot_blocks: list[list[int]] = [[] for _ in range(max_batch)]
        # unallocated entries stay 0, the sink (attention masks by length)
        self._table = np.zeros((max_batch, self.table_width), dtype=np.int32)
        self._table_dirty = True
        self._table_dev = None
        self.enable_prefix_cache = enable_prefix_cache
        self._refs = np.zeros((self.num_blocks,), dtype=np.int64)
        self._hash_of: dict[int, bytes] = {}  # block id -> chain hash
        self._block_of: dict[bytes, int] = {}  # chain hash -> block id
        # zero-ref blocks still holding cached KV, in LRU order
        self._evictable: collections.OrderedDict[int, bytes] = collections.OrderedDict()
        self.prefix_cache_hits = 0  # full blocks reused
        self.prefix_cache_misses = 0
        super().__init__(
            params, cfg, max_batch=max_batch, max_len=max_len, sp=sp, pad_id=pad_id,
            quantized_kv=quantized_kv, vocab_window=vocab_window, max_top_k=max_top_k,
            steps_per_dispatch=steps_per_dispatch, admission_policy=admission_policy,
            prefill_ahead=prefill_ahead, park_rows=park_rows, park_len=park_len,
            park_groups_per_poll=park_groups_per_poll, device=device, mesh=mesh,
        )

    def stats(self) -> dict:
        out = super().stats()
        out.update(
            free_blocks=len(self._free_blocks),
            cached_blocks=len(self._evictable),
            used_blocks=int((self._refs > 0).sum()),
            num_blocks=self.num_blocks,
            prefix_cache_hits=self.prefix_cache_hits,
            prefix_cache_misses=self.prefix_cache_misses,
        )
        return out

    def _make_cache(self):
        return llama.init_paged_kv_cache(self.cfg, self.num_blocks, self.block_size,
                                         quantized=self.quantized_kv, device=self.device,
                                         tp=self.tp)

    def _bucket_step(self) -> int:
        # prompt buckets tile exactly into blocks for the prefill scatter
        step = 64
        while step % self.block_size:
            step += 64
        return step

    def _blocks_needed(self, req: Request) -> int:
        total = len(req.prompt_tokens) + req.max_new_tokens
        bucket = _bucket(len(req.prompt_tokens), self._bucket_step())
        return (max(total, bucket) + self.block_size - 1) // self.block_size

    # --- prefix-cache bookkeeping -------------------------------------------

    def _block_hashes(self, toks: np.ndarray) -> list[bytes]:
        """Chained content hash per full block of the prompt."""
        bs = self.block_size
        out: list[bytes] = []
        h = b""
        for i in range(len(toks) // bs):
            h = hashlib.blake2b(
                h + np.ascontiguousarray(toks[i * bs:(i + 1) * bs]).tobytes(),
                digest_size=16,
            ).digest()
            out.append(h)
        return out

    def _prefix_hits(self, req: Request) -> tuple[list[bytes], int]:
        """(all full-block hashes, number of leading cached blocks), capped
        so that at least one prompt token is forwarded (the engine needs the
        last position's logits)."""
        if not self.enable_prefix_cache:
            return [], 0
        hashes = self._block_hashes(req.prompt_tokens)
        m = 0
        for h in hashes:
            if h not in self._block_of:
                break
            m += 1
        return hashes, min(m, (len(req.prompt_tokens) - 1) // self.block_size)

    def _alloc_block(self) -> int:
        if self._free_blocks:
            return self._free_blocks.pop()
        blk, h = self._evictable.popitem(last=False)  # LRU eviction
        del self._block_of[h]
        del self._hash_of[blk]
        return blk

    def _can_admit(self, req: Request) -> bool:
        hashes, m = self._prefix_hits(req)
        reused_evictable = sum(1 for h in hashes[:m] if self._refs[self._block_of[h]] == 0)
        available = len(self._free_blocks) + len(self._evictable) - reused_evictable
        return self._blocks_needed(req) - m <= available

    def _release_slot(self, slot_idx: int) -> None:
        blocks = self._slot_blocks[slot_idx]
        self._slot_blocks[slot_idx] = []
        self._table[slot_idx] = 0
        self._table_dirty = True
        self._free_block_list(blocks)

    def _free_block_list(self, blocks) -> None:
        for blk in blocks:
            self._refs[blk] -= 1
            if self._refs[blk] == 0:
                if blk in self._hash_of:
                    self._evictable[blk] = self._hash_of[blk]
                else:
                    self._free_blocks.append(blk)

    def _defer_release(self, slot_idx: int) -> None:
        """Cancel under a dispatch in flight: zero the table row (the next
        dispatch sends this slot's writes to the sink) but hold the block
        refs until that dispatch's blob is read, since it still writes
        through the old row."""
        self._deferred_free.extend(self._slot_blocks[slot_idx])
        self._slot_blocks[slot_idx] = []
        self._table[slot_idx] = 0
        self._table_dirty = True

    def _flush_deferred_releases(self) -> None:
        blocks, self._deferred_free = self._deferred_free, []
        self._free_block_list(blocks)

    def _table_device(self):
        """The device block table, rewritten in place (in stream order, so a
        dispatch already queued reads the old rows) only when it changed."""
        if self._table_dev is None:
            self._table_dev = torch.zeros(self._table.shape, dtype=torch.int32,
                                          device=self.device)
        if self._table_dirty:
            self._table_dev.copy_(self._upload(self._table.copy()), non_blocking=True)
            self._table_dirty = False
        return self._table_dev

    def _guard_lengths(self, lengths, active, table):
        """An inactive slot writes at its stagnant length clamped to the
        table's span: its own block, or entry 0 (the sink) past its
        reservation or after release."""
        return lengths.clamp(max=table.shape[1] * self.block_size - 1)

    def _decode_step(self, toks, lengths_w, table):
        logits, _ = llama.decode_step_paged(self.params, self.cfg, self.cache, toks,
                                            lengths_w, table, logits_head=self._head,
                                            tp=self.tp)
        return logits

    def _scatter_prefill(self, small, slots: torch.Tensor, bucket: int, items) -> None:
        """Write a group's prefill rows through per-row block tables
        [k, bucket // bs]; a row whose request owns fewer blocks sends the
        surplus bucket padding to the sink block 0."""
        nb = bucket // self.block_size
        tables = np.zeros((len(items), nb), dtype=np.int64)
        for row, (_, _, ctx) in enumerate(items):
            blocks = ctx["blocks"][:nb]
            tables[row, :len(blocks)] = blocks
        tables = self._upload(tables)

        def leaf(big, little):
            lit = little.reshape(little.shape[0], little.shape[1], nb, self.block_size,
                                 *little.shape[3:])
            big[:, tables] = lit.to(big.dtype)

        llama._map(leaf, self.cache, small)

    def _prepare_slot(self, slot_idx: int, req: Request) -> dict:
        """Allocate the request's blocks and point its table row at them
        (host state; the device prefill that follows writes the KV)."""
        hashes, m = self._prefix_hits(req)
        reused = [self._block_of[h] for h in hashes[:m]]
        for blk in reused:
            if self._refs[blk] == 0:
                self._evictable.pop(blk, None)
            self._refs[blk] += 1
        fresh = [self._alloc_block() for _ in range(self._blocks_needed(req) - m)]
        for blk in fresh:
            self._refs[blk] += 1
        blocks = reused + fresh
        self._slot_blocks[slot_idx] = blocks
        self._table[slot_idx] = 0
        self._table[slot_idx, :len(blocks)] = blocks
        self._table_dirty = True
        return {"hashes": hashes, "m": m, "blocks": blocks}

    def _wants_suffix(self, req: Request) -> bool:
        return self._prefix_hits(req)[1] > 0

    def _register_prefix(self, slot_idx: int, req: Request, ctx: dict) -> None:
        if not self.enable_prefix_cache:
            return
        m, hashes, blocks = ctx["m"], ctx["hashes"], ctx["blocks"]
        self.prefix_cache_hits += m
        covered = len(req.prompt_tokens) // self.block_size  # full blocks
        self.prefix_cache_misses += covered - m
        for i in range(m, covered):
            if hashes[i] not in self._block_of:
                self._block_of[hashes[i]] = blocks[i]
                self._hash_of[blocks[i]] = hashes[i]

    # --- prefill-ahead, paged ------------------------------------------------
    # A prefix-cache hit never parks (_park_eligible): a park prefills the
    # whole prompt, and an attach writes only fresh blocks, never shared
    # cached ones that other requests read.

    def _can_attach(self, req: Request) -> bool:
        return self._blocks_needed(req) <= len(self._free_blocks) + len(self._evictable)

    def _prepare_attach(self, slot_idx: int, req: Request) -> dict:
        """Fresh blocks for an attach, and the slot's table row."""
        hashes = self._block_hashes(req.prompt_tokens) if self.enable_prefix_cache else []
        blocks = [self._alloc_block() for _ in range(self._blocks_needed(req))]
        for blk in blocks:
            self._refs[blk] += 1
        self._slot_blocks[slot_idx] = blocks
        self._table[slot_idx] = 0
        self._table[slot_idx, :len(blocks)] = blocks
        self._table_dirty = True
        return {"hashes": hashes, "m": 0, "blocks": blocks}

    def _attach_scatter(self, rows: torch.Tensor, slots: torch.Tensor, group) -> None:
        """Copy park rows' K/V through per-row block tables [g, park_len //
        bs]: the columns past a short allocation go to the sink block 0."""
        nb = self.park_len // self.block_size
        tables = np.zeros((len(group), nb), dtype=np.int64)
        for row, (_, _, ctx) in enumerate(group):
            blocks = ctx["blocks"][:nb]
            tables[row, :len(blocks)] = blocks
        tables = self._upload(tables)

        def leaf(big, parked):
            lit = parked[:, rows]  # [L, g, park_len, ...]
            big[:, tables] = lit.reshape(lit.shape[0], lit.shape[1], nb, self.block_size,
                                         *lit.shape[3:]).to(big.dtype)

        llama._map(leaf, self.cache, self.park_cache)

    def _register_attach(self, slot_idx: int, req: Request, ctx: dict) -> None:
        # the attached blocks hold the prompt's exact K/V: they enter the
        # prefix cache as a group prefill's do
        self._register_prefix(slot_idx, req, ctx)

    @torch.no_grad()
    def _admit_suffix(self, slot_idx: int, req: Request) -> None:
        """Prefix-cache hit: gather the shared prefix blocks into a
        contiguous batch-1 cache, forward only the suffix through
        ``decode_window``, write its new blocks back and the slot's state
        rows."""
        ctx = self._prepare_slot(slot_idx, req)
        m, bs = ctx["m"], self.block_size
        n = len(req.prompt_tokens)
        bucket = _bucket(n, self._bucket_step())
        prefix_len = m * bs
        padded = np.zeros((1, bucket), dtype=np.int32)
        padded[0, :n] = req.prompt_tokens
        self._activate_host(slot_idx, req)  # may set bsp.use_top_p
        meta_i, meta_f = self._meta([slot_idx], [req])
        tokens = self._upload(padded)
        blocks = self._upload(np.asarray(ctx["blocks"][:bucket // bs], dtype=np.int64))
        small = llama.grow_cache(llama.gather_blocks_to_cache(self.cache, blocks[:m]),
                                 bucket)
        start = torch.full((1,), prefix_len, dtype=torch.int32, device=self.device)
        logits, small = llama.decode_window(self.params, self.cfg, small,
                                            tokens[:, prefix_len:], start,
                                            logits_head=self._head, tp=self.tp)
        llama.scatter_suffix_to_blocks(self.cache, small, blocks[m:], prefix_len)
        mask = torch.arange(bucket, device=self.device)[None, :] < n
        self._write_slot_state(meta_i, meta_f, logits[:, n - prefix_len - 1],
                               self._prompt_counts(tokens, mask))
        self._suffix_admissions += 1
        self._register_prefix(slot_idx, req, ctx)
