"""GRPO trainer (counterpart of ``tts_max_tpu/training/rlhf/grpo.py``).

Without a topology one device time-multiplexes sampling and training: rollouts through
``inference/generate.generate`` (kernel A in the prefill, B in the decode)
or through the contiguous serving engine (``rollout_via_engine``, kernel C),
rewards on the host and the reward backends' devices, then one GRPO update
(kernel A forward, A' backward). The weight "sync" is handing the updated
parameter tree to the sampler: ``generate`` takes it as an argument, and
the engine is given it with ``InferenceEngine.update_params`` after every
update. (The JAX module's engine keeps its first weights for the whole run
when no trainer/sampler topology is set; the port does not.)

With ``topology`` (``topology.TrainerSamplerTopology``) the world's ranks
split: the sampler ranks make the rollouts on their tensor-parallel mesh
(``generate`` or the engine with ``mesh=``, on the pushed weights), and the
first of them broadcasts the completions to every rank; the trainer ranks
compute the rewards (the same on each) and run the update on the trainer
mesh (``ShardedGRPOStep``: each batch rank its rows, FSDP-sharded params
and Adam moments, the loss over JAX's whole-batch denominator). Before
every round after the first the trainer pushes its weights to the sampler
(JAX's order). ``train_step`` returns the same stats on every rank (the
seconds are each rank's own clock).

Objective (group-relative advantages, TRL's num_iterations=1 semantics):
  adv_i = (r_i - mean_group) [/ (std_group + 1e-4) if scale_rewards]
  L = -E_tokens[ exp(logp - sg(logp)) · adv ] + β · KL_k3(policy ‖ ref)
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from tts_max_tpu_torch.core.config import RLHFConfig
from tts_max_tpu_torch.inference.generate import make_generate_fn
from tts_max_tpu_torch.models import llama
from tts_max_tpu_torch.ops.sampling import SamplingParams
from tts_max_tpu_torch.parallel import collectives
from tts_max_tpu_torch.parallel.mesh import BATCH
from tts_max_tpu_torch.training.optim import AdamW, apply_updates, global_norm, tree_map
from tts_max_tpu_torch.training.train_step import ShardedTrainStep, token_nll
from tts_max_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


# --- logprobs / loss --------------------------------------------------------


def _chunk_lp(hc, tc, params, cfg, tp=None):
    return -token_nll(hc, tc, params, cfg, tp)


def sequence_logprobs(params, cfg: llama.LlamaConfig, tokens: torch.Tensor,
                      chunk_size: int = 256, gather_layer=None, tp=None) -> torch.Tensor:
    """Per-token logprobs of tokens[t] given tokens[<t]: [B, L-1] (fp32).

    ``chunk_size > 0`` computes the head blockwise: the naive form holds
    [B, L, V] fp32 logprobs (19 GB at 8 x 3072 tokens and the 193856-token
    head). Each chunk's logits reduce at once to ``target - logsumexp``,
    under ``torch.utils.checkpoint`` so the backward recomputes them.
    ``gather_layer`` and ``tp`` as in ``llama.forward_hidden`` (a mesh's
    shards; vocab-parallel logprobs where ``tp`` splits the head)."""
    tokens = tokens.long()
    if chunk_size <= 0 and gather_layer is None and tp is None:
        logits = llama.forward(params, cfg, tokens)[:, :-1]
        logprobs = torch.log_softmax(logits.float(), dim=-1)
        return torch.gather(logprobs, -1, tokens[:, 1:, None])[..., 0]
    hidden = llama.forward_hidden(params, cfg, tokens, gather_layer, tp)
    h = hidden[:, :-1]
    t = tokens[:, 1:]
    n_t = h.shape[1]
    c = min(chunk_size, n_t) if chunk_size > 0 else n_t
    return torch.cat([checkpoint(_chunk_lp, h[:, c0:c0 + c], t[:, c0:c0 + c], params, cfg,
                                 tp, use_reentrant=False)
                      for c0 in range(0, n_t, c)], dim=1)


def grpo_loss(
    params,
    tokens: torch.Tensor,  # [B, L] prompt+completion, right padded
    completion_mask: torch.Tensor,  # [B, L] True on completion tokens
    advantages: torch.Tensor,  # [B]
    ref_logps: torch.Tensor | None,  # [B, L-1] or None
    *,
    cfg: llama.LlamaConfig,
    beta: float = 0.0,
    denom: torch.Tensor | None = None,
    gather_layer=None,
    tp=None,
):
    """(loss, mean completion logprob); the loss carries the gradient.
    ``denom``: the whole batch's clamped completion-token count, when these
    rows are one rank's part of it (default: these rows' own)."""
    logps = sequence_logprobs(params, cfg, tokens, gather_layer=gather_layer, tp=tp)
    mask = completion_mask[:, 1:].float()
    # ratio form: value 1, gradient d(logp) (TRL's num_iterations=1)
    ratio = torch.exp(logps - logps.detach())
    per_token = -ratio * advantages[:, None]
    if beta > 0.0 and ref_logps is not None:
        # k3 KL estimator (Schulman): exp(ref-logp) - (ref-logp) - 1
        delta = ref_logps - logps
        per_token = per_token + beta * (torch.exp(delta) - delta - 1.0)
    denom = torch.clamp_min(mask.sum(), 1.0) if denom is None else denom
    loss = (per_token * mask).sum() / denom
    mean_logp = (logps.detach() * mask).sum() / denom
    return loss, mean_logp


def compute_advantages(rewards: np.ndarray, num_generations: int,
                       scale_rewards: bool = True) -> np.ndarray:
    """Group-relative advantages: [B] rewards with groups of G consecutive
    completions per prompt (float64, population std + 1e-4, cast to fp32)."""
    r = np.asarray(rewards, dtype=np.float64).reshape(-1, num_generations)
    adv = r - r.mean(axis=1, keepdims=True)
    if scale_rewards:
        adv = adv / (r.std(axis=1, keepdims=True) + 1e-4)
    return adv.reshape(-1).astype(np.float32)


class GRPOMetrics(NamedTuple):
    loss: float
    mean_logp: float
    grad_norm: float


def make_grpo_step(cfg: llama.LlamaConfig, tx: AdamW, beta: float, grad_clip: float = 1.0):
    """``step(params, opt_state, tokens, completion_mask, advantages,
    ref_logps) -> (params, opt_state, GRPOMetrics)``: the loss and its
    gradient, the global norm (fp32), the clip scale ``grad_clip / gnorm``
    when gnorm is finite and above ``grad_clip`` (else 1), and one AdamW
    update. ``params`` is not modified."""

    def step(params, opt_state, tokens, completion_mask, advantages, ref_logps):
        leaves = []

        def track(p):
            q = p.detach().requires_grad_(True)
            leaves.append(q)
            return q

        live = tree_map(track, params)
        with torch.enable_grad():
            loss, mean_logp = grpo_loss(live, tokens, completion_mask, advantages, ref_logps,
                                        cfg=cfg, beta=beta)
            grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        with torch.no_grad():
            params, opt_state, g = _clip_and_apply(params, opt_state, grads,
                                                   global_norm(grads), tx, grad_clip)
        return params, opt_state, GRPOMetrics(float(loss.detach()), float(mean_logp), g)

    return step


def _clip_and_apply(params, opt_state, grads, gnorm, tx, grad_clip):
    """The clip scale ``grad_clip / gnorm`` when gnorm is finite and above
    ``grad_clip`` (else 1), then one AdamW update: (params, opt_state,
    gnorm as a float)."""
    g = float(gnorm)
    if np.isfinite(g) and g > grad_clip:
        scale = grad_clip / gnorm
        grads = tree_map(lambda x: x * scale, grads)
    updates, opt_state = tx.update(grads, opt_state, params)
    return apply_updates(params, updates), opt_state, g


class ShardedGRPOStep:
    """``make_grpo_step`` over a ``(data, fsdp, tensor)`` mesh, from the whole
    params' layout: each batch rank of the mesh takes its rows of the
    batch (``np.array_split`` order) and backpropagates their part of the
    loss over the whole batch's denominator (JAX's ``mask.sum()``); the
    grads, the loss and the mean logprob are summed over the batch ranks
    (``ShardedTrainStep.reduced_grads``), then the global norm, the clip
    (``grad_clip / gnorm`` when finite and above it) and AdamW on this
    rank's shards."""

    def __init__(self, mesh, cfg: llama.LlamaConfig, tx: AdamW, params, beta: float,
                 grad_clip: float = 1.0):
        self.core = ShardedTrainStep(mesh, cfg, tx, params, grad_clip)
        self.mesh, self.cfg, self.tx, self.beta, self.clip = mesh, cfg, tx, beta, grad_clip
        self.layout = self.core.layout

    def rows(self, n: int) -> np.ndarray:
        """This rank's rows of an ``n``-row batch."""
        if n < self.mesh.size(BATCH):
            raise ValueError(f"{n} rows for {self.mesh.size(BATCH)} batch ranks")
        return np.array_split(np.arange(n), self.mesh.size(BATCH))[self.mesh.index(BATCH)]

    @torch.no_grad()
    def logprobs(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """``sequence_logprobs`` of these rows on a rank's shards."""
        return sequence_logprobs(self.core._with_full(params), self.cfg, tokens,
                                 gather_layer=self.core._gather_layer, tp=self.core.tp)

    def __call__(self, params, opt_state, tokens, completion_mask, advantages, ref_logps):
        """``tokens``, ``completion_mask``, ``advantages``: the whole batch;
        ``ref_logps``: this rank's rows' (or None)."""
        denom = torch.clamp_min(completion_mask[:, 1:].float().sum(), 1.0)
        r = torch.as_tensor(self.rows(tokens.shape[0]), device=tokens.device)

        def fn(live):
            return grpo_loss(live, tokens[r], completion_mask[r], advantages[r], ref_logps,
                             cfg=self.cfg, beta=self.beta, denom=denom,
                             gather_layer=self.core._gather_layer, tp=self.core.tp)

        grads, outs = self.core.reduced_grads(params, [fn])
        loss, mean_logp = collectives.all_reduce_sum(torch.stack(outs[0]),
                                                     self.core.batch_group).tolist()
        with torch.no_grad():
            params, opt_state, g = _clip_and_apply(params, opt_state, grads,
                                                   self.core.global_norm(grads), self.tx,
                                                   self.clip)
        return params, opt_state, GRPOMetrics(loss, mean_logp, g)


# --- trainer ----------------------------------------------------------------


@dataclass
class GRPOBatch:
    tokens: np.ndarray
    completion_mask: np.ndarray
    rewards: np.ndarray
    advantages: np.ndarray


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class GRPOTrainer:
    """Rollout → reward → update loop on the device of ``params``.

    Each ``train_step`` returns the JAX trainer's stats (reward mean and
    std, mean completion length, each reward function's mean, loss, mean
    logprob, grad norm, step) and, besides, the seconds of the rollout, of
    each reward function and of the update (host clock, device
    synchronized) and the rollout's decode steps."""

    def __init__(
        self,
        params: Any,
        model_cfg: llama.LlamaConfig,
        tokenizer,
        speech_vocab,
        reward_funcs: Sequence[Callable],
        rlhf_cfg: RLHFConfig,
        learning_rate: float = 1e-6,
        reward_weights: Sequence[float] | None = None,
        scale_rewards: bool = True,
        seed: int = 0,
        topology: Any | None = None,
        rollout_via_engine: bool = False,
        engine_max_batch: int = 8,
    ):
        self.device = llama.params_device(params)
        self.topology = topology
        self._rollout_via_engine = rollout_via_engine
        self._engine_max_batch = engine_max_batch
        self._engine = None
        self._sampler_params = None
        full = params
        if topology is not None:
            # the trainer's shards (None on a sampler rank)
            params = topology.shard_for_trainer(full)
        self.params = params
        self.cfg = model_cfg
        self.tokenizer = tokenizer
        self.sv = speech_vocab
        self.reward_funcs = list(reward_funcs)
        self.rlhf = rlhf_cfg
        weights = list(reward_weights or rlhf_cfg.reward_weights)
        if len(weights) != len(self.reward_funcs):
            weights = [1.0] * len(self.reward_funcs)
        self.reward_weights = np.asarray(weights, dtype=np.float64)
        self.scale_rewards = scale_rewards
        # a bf16 first moment: the single-device 1B recipe
        self.tx = AdamW(learning_rate, betas=(0.9, 0.95), weight_decay=0.1, mu_dtype="bf16")
        self.beta = rlhf_cfg.kl_beta
        trains = topology is None or topology.is_trainer
        self.opt_state = self.tx.init(params) if trains else None
        self.ref_params = (tree_map(lambda t: t.detach().clone(), params)
                           if self.beta > 0 and trains else None)
        self._step_fn = make_grpo_step(model_cfg, self.tx, self.beta)
        self._sharded = (ShardedGRPOStep(topology.trainer_mesh, model_cfg, self.tx, full,
                                         self.beta)
                         if topology is not None and topology.is_trainer else None)
        del full
        self._sp = SamplingParams(
            temperature=rlhf_cfg.temperature,
            top_k=rlhf_cfg.top_k,
            repetition_penalty=rlhf_cfg.repetition_penalty,
            frequency_penalty=0.0,
        )
        self._gen_cache: dict[int, Callable] = {}
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self.step = 0
        # the parameter tree the last rollout sampled from
        self.rollout_params = None
        if topology is not None:  # the first push, before the first rollout
            self._sampler_params = topology.push_to_sampler(self.params)

    @property
    def layout(self):
        """The ``ShardLayout`` of a trainer rank's params under a topology
        (else None)."""
        return self._sharded.layout if self._sharded is not None else None

    def _samples(self) -> bool:
        return self.topology is None or not self.topology.is_trainer

    def _rollout_weights(self):
        return self.params if self.topology is None else self._sampler_params

    def _sampler_mesh(self):
        return self.topology.sampler_mesh if self.topology is not None else None

    def _vocab_window(self):
        return (self.sv.generation_window()
                if getattr(self.rlhf, "constrain_to_speech", False) else None)

    def _generate_fn(self, bucket: int):
        if bucket not in self._gen_cache:
            self._gen_cache[bucket] = make_generate_fn(
                self.cfg, self._sp,
                max_new_tokens=self.rlhf.max_completion_length,
                eos_id=self.sv.speech_end_id,
                cache_len=bucket + self.rlhf.max_completion_length,
                vocab_window=self._vocab_window(),
                device=self.device,
                mesh=self._sampler_mesh(),
            )
        return self._gen_cache[bucket]

    def _ensure_engine(self):
        """The sampler-side serving engine, built on first use."""
        if self._engine is None:
            from tts_max_tpu_torch.inference.engine import InferenceEngine

            max_len = self.rlhf.max_prompt_length + self.rlhf.max_completion_length
            max_len = ((max_len + 63) // 64) * 64
            self._engine = InferenceEngine(
                self._rollout_weights(), self.cfg,
                max_batch=self._engine_max_batch,
                max_len=max_len,
                sp=self._sp,
                steps_per_dispatch=4,
                vocab_window=self._vocab_window(),
                device=self.device,
                mesh=self._sampler_mesh(),
            )
        return self._engine

    def _engine_rollout(self, enc: list[np.ndarray], G: int):
        """G completions per prompt through the continuous-batching engine,
        with the trainer's current weights (greedy-identical to
        ``generate``; sampled rollouts draw from per-request seeds taken
        from the trainer's generator). Returns (completions [B,
        max_completion_length], n_gen [B], decode steps)."""
        eng = self._ensure_engine()
        B = len(enc) * G
        seeds = torch.randint(0, np.iinfo(np.int32).max, (B,), generator=self._generator,
                              device=self.device).tolist()
        ids = []
        for e in enc:
            for _ in range(G):
                ids.append(eng.submit(
                    e, self.rlhf.max_completion_length,
                    eos_id=self.sv.speech_end_id,
                    sampling_seed=int(seeds[len(ids)]),
                ))
        def decode_steps():
            return sum(eng.stats()["dispatches_per_stage"].values()) * eng.steps_per_dispatch

        steps0 = decode_steps()
        by_id = {c.request_id: c for c in eng.run()}
        comps = [by_id[r].tokens for r in ids]
        n_gen = np.asarray([len(c) for c in comps], dtype=np.int32)
        completions = np.zeros((B, self.rlhf.max_completion_length), dtype=np.int32)
        for b, c in enumerate(comps):
            completions[b, : len(c)] = c
        return completions, n_gen, decode_steps() - steps0

    def rollout(self, prompts: list[dict]) -> tuple[GRPOBatch, dict]:
        """Generate G completions per prompt, score, build the train batch."""
        G = self.rlhf.num_generations
        enc = [
            np.asarray(
                self.tokenizer.encode(p["prompt"], add_special_tokens=True),
                dtype=np.int32,
            )[: self.rlhf.max_prompt_length]
            for p in prompts
        ]
        max_len = max(len(e) for e in enc)
        bucket = ((max_len + 63) // 64) * 64
        B = len(prompts) * G
        prompt_tokens = np.zeros((B, bucket), dtype=np.int32)
        prompt_lengths = np.zeros((B,), dtype=np.int32)
        for i, e in enumerate(enc):
            for g in range(G):
                prompt_tokens[i * G + g, : len(e)] = e
                prompt_lengths[i * G + g] = len(e)

        t0 = time.perf_counter()
        self.rollout_params = self._rollout_weights()
        completions = np.zeros((B, self.rlhf.max_completion_length), dtype=np.int32)
        n_gen, steps = np.zeros((B,), dtype=np.int32), 0
        if self._samples() and self._rollout_via_engine:
            completions, n_gen, steps = self._engine_rollout(enc, G)
        elif self._samples():
            res = self._generate_fn(bucket)(
                self.rollout_params, torch.from_numpy(prompt_tokens),
                torch.from_numpy(prompt_lengths), self._generator,
            )
            completions = res.tokens.cpu().numpy()
            n_gen = res.num_generated.cpu().numpy()
            steps = res.steps
        if self.topology is not None:
            completions, n_gen, steps = self._share_rollout(completions, n_gen, steps)
        rollout_s = time.perf_counter() - t0

        # rewards (host-side, and the backends' devices)
        kwargs = {
            "prompt_speech_ids": [prompts[i // G]["prompt_speech_ids"] for i in range(B)],
            "completion_truth": [prompts[i // G]["completion_truth"] for i in range(B)],
            "language": [prompts[i // G].get("language", "en") for i in range(B)],
            "prompt_wav_path": [prompts[i // G].get("prompt_wav_path", "") for i in range(B)],
        }
        completion_list = [completions[i, : n_gen[i]] for i in range(B)]
        total_rewards = np.zeros((B,), dtype=np.float64)
        per_func, seconds = {}, {}
        for func, w in zip(self.reward_funcs, self.reward_weights):
            if self.topology is not None and not self.topology.is_trainer:
                per_func[func.__name__] = 0.0  # a sampler rank: the trainer's, broadcast
                continue
            t1 = time.perf_counter()
            r = np.asarray(func(completion_list, **kwargs), dtype=np.float64)
            seconds[f"{func.__name__}_seconds"] = time.perf_counter() - t1
            per_func[func.__name__] = float(r.mean())
            total_rewards += w * r
        advantages = compute_advantages(total_rewards, G, self.scale_rewards)

        # the train batch: prompt + completion, right padded to a fixed length
        # (one shape for every step, whatever the prompt bucket)
        L = max(self.rlhf.max_prompt_length, bucket) + self.rlhf.max_completion_length
        tokens = np.zeros((B, L), dtype=np.int32)
        mask = np.zeros((B, L), dtype=bool)
        for i in range(B):
            pl = prompt_lengths[i]
            tokens[i, :pl] = prompt_tokens[i, :pl]
            ng = int(n_gen[i])
            tokens[i, pl : pl + ng] = completions[i, :ng]
            mask[i, pl : pl + ng] = True
        batch = GRPOBatch(tokens, mask, total_rewards, advantages)
        stats = {
            "reward_mean": float(total_rewards.mean()),
            "reward_std": float(total_rewards.std()),
            "completion_len": float(n_gen.mean()),
            **per_func,
            "rollout_seconds": rollout_s,
            "decode_steps": int(steps),
            **seconds,
        }
        return batch, stats

    def _share_rollout(self, completions, n_gen, steps):
        """The first sampler rank's completions, lengths and decode steps on
        every rank (one broadcast)."""
        flat = torch.from_numpy(np.concatenate(
            [completions.reshape(-1), n_gen, [steps]]).astype(np.int64)).to(self.device)
        flat = collectives.broadcast(flat, self.topology.sampler_ranks[0]).cpu().numpy()
        B = n_gen.shape[0]
        return (flat[:completions.size].reshape(completions.shape).astype(np.int32),
                flat[completions.size:completions.size + B].astype(np.int32), int(flat[-1]))

    def _share_stats(self, stats: dict) -> dict:
        """The first trainer rank's rewards and update metrics on every rank
        (one broadcast)."""
        keys = ["reward_mean", "reward_std", "completion_len",
                *(f.__name__ for f in self.reward_funcs), "loss", "mean_logp", "grad_norm"]
        v = torch.tensor([float(stats[k]) for k in keys], dtype=torch.float64,
                         device=self.device)
        v = collectives.broadcast(v, self.topology.trainer_ranks[0]).tolist()
        return {**stats, **dict(zip(keys, v))}

    def train_step(self, prompts: list[dict]) -> dict:
        if self.topology is not None and self.step > 0:
            # the weight push between rounds (JAX's order: before the rollout)
            self._sampler_params = self.topology.push_to_sampler(self.params)
            if self._engine is not None:
                self._engine.update_params(self._sampler_params)
        batch, stats = self.rollout(prompts)
        dev = self.device
        t0 = time.perf_counter()
        tokens = torch.from_numpy(batch.tokens).to(dev, torch.int64)
        mask = torch.from_numpy(batch.completion_mask).to(dev)
        adv = torch.from_numpy(batch.advantages).to(dev)
        m = GRPOMetrics(0.0, 0.0, 0.0)
        if self._sharded is not None:
            ref_logps = None
            if self.beta > 0:
                rows = torch.as_tensor(self._sharded.rows(tokens.shape[0]), device=dev)
                ref_logps = self._sharded.logprobs(self.ref_params, tokens[rows])
            self.params, self.opt_state, m = self._sharded(
                self.params, self.opt_state, tokens, mask, adv, ref_logps)
        elif self.topology is None:
            ref_logps = None
            if self.beta > 0:
                with torch.no_grad():
                    ref_logps = sequence_logprobs(self.ref_params, self.cfg, tokens)
            self.params, self.opt_state, m = self._step_fn(
                self.params, self.opt_state, tokens, mask, adv, ref_logps)
        _sync(dev)
        if self._engine is not None and self.topology is None:
            self._engine.update_params(self.params)  # the new weights from now on
        self.step += 1
        stats.update(
            loss=m.loss, mean_logp=m.mean_logp, grad_norm=m.grad_norm, step=self.step,
            update_seconds=time.perf_counter() - t0,
        )
        if self.topology is not None:
            stats = self._share_stats(stats)
        self.last_batch = batch
        return stats
