"""GRPO trainer on one device (counterpart of
``tts_max_tpu/training/rlhf/grpo.py``).

One device time-multiplexes sampling and training: rollouts through
``inference/generate.generate`` (kernel A in the prefill, B in the decode)
or through the contiguous serving engine (``rollout_via_engine``, kernel C),
rewards on the host and the reward backends' devices, then one GRPO update
(kernel A forward, A' backward). The weight "sync" is handing the updated
parameter tree to the sampler: ``generate`` takes it as an argument, and
the engine is given it with ``InferenceEngine.update_params`` after every
update. (The JAX module's engine keeps its first weights for the whole run
when no trainer/sampler topology is set; the port does not.)
The JAX module's ``topology`` (a trainer sub-mesh and a sampler sub-mesh)
waits for RLHF's trainer/sampler topology (ROADMAP.md queue 1 item 4b).

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
from tts_max_tpu_torch.training.optim import AdamW, apply_updates, global_norm, tree_map
from tts_max_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


# --- logprobs / loss --------------------------------------------------------


def _chunk_lp(hc, tc, params, cfg):
    logits = llama._logits(hc, params, cfg)  # fp32 [B, C, V]
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, tc[..., None])[..., 0]
    return tgt - lse


def sequence_logprobs(params, cfg: llama.LlamaConfig, tokens: torch.Tensor,
                      chunk_size: int = 256) -> torch.Tensor:
    """Per-token logprobs of tokens[t] given tokens[<t]: [B, L-1] (fp32).

    ``chunk_size > 0`` computes the head blockwise: the naive form holds
    [B, L, V] fp32 logprobs (19 GB at 8 x 3072 tokens and the 193856-token
    head). Each chunk's logits reduce at once to ``target - logsumexp``,
    under ``torch.utils.checkpoint`` so the backward recomputes them."""
    tokens = tokens.long()
    if chunk_size <= 0:
        logits = llama.forward(params, cfg, tokens)[:, :-1]
        logprobs = torch.log_softmax(logits.float(), dim=-1)
        return torch.gather(logprobs, -1, tokens[:, 1:, None])[..., 0]
    hidden = llama.forward_hidden(params, cfg, tokens)
    h = hidden[:, :-1]
    t = tokens[:, 1:]
    n_t = h.shape[1]
    c = min(chunk_size, n_t)
    return torch.cat([checkpoint(_chunk_lp, h[:, c0:c0 + c], t[:, c0:c0 + c], params, cfg,
                                 use_reentrant=False)
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
):
    """(loss, mean completion logprob); the loss carries the gradient."""
    logps = sequence_logprobs(params, cfg, tokens)
    mask = completion_mask[:, 1:].float()
    # ratio form: value 1, gradient d(logp) (TRL's num_iterations=1)
    ratio = torch.exp(logps - logps.detach())
    per_token = -ratio * advantages[:, None]
    if beta > 0.0 and ref_logps is not None:
        # k3 KL estimator (Schulman): exp(ref-logp) - (ref-logp) - 1
        delta = ref_logps - logps
        per_token = per_token + beta * (torch.exp(delta) - delta - 1.0)
    denom = torch.clamp_min(mask.sum(), 1.0)
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
            gnorm = global_norm(grads)
            g = float(gnorm)
            if np.isfinite(g) and g > grad_clip:
                scale = grad_clip / gnorm
                grads = tree_map(lambda x: x * scale, grads)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        return params, opt_state, GRPOMetrics(float(loss.detach()), float(mean_logp), g)

    return step


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
        rollout_via_engine: bool = False,
        engine_max_batch: int = 8,
    ):
        self.device = llama.params_device(params)
        self._rollout_via_engine = rollout_via_engine
        self._engine_max_batch = engine_max_batch
        self._engine = None
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
        self.opt_state = self.tx.init(params)
        self.beta = rlhf_cfg.kl_beta
        self.ref_params = (tree_map(lambda t: t.detach().clone(), params)
                           if self.beta > 0 else None)
        self._step_fn = make_grpo_step(model_cfg, self.tx, self.beta)
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
            )
        return self._gen_cache[bucket]

    def _ensure_engine(self):
        """The sampler-side serving engine, built on first use."""
        if self._engine is None:
            from tts_max_tpu_torch.inference.engine import InferenceEngine

            max_len = self.rlhf.max_prompt_length + self.rlhf.max_completion_length
            max_len = ((max_len + 63) // 64) * 64
            self._engine = InferenceEngine(
                self.params, self.cfg,
                max_batch=self._engine_max_batch,
                max_len=max_len,
                sp=self._sp,
                steps_per_dispatch=4,
                vocab_window=self._vocab_window(),
                device=self.device,
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
        self.rollout_params = self.params
        if self._rollout_via_engine:
            completions, n_gen, steps = self._engine_rollout(enc, G)
        else:
            res = self._generate_fn(bucket)(
                self.params, torch.from_numpy(prompt_tokens), torch.from_numpy(prompt_lengths),
                self._generator,
            )
            completions = res.tokens.cpu().numpy()
            n_gen = res.num_generated.cpu().numpy()
            steps = res.steps
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

    def train_step(self, prompts: list[dict]) -> dict:
        batch, stats = self.rollout(prompts)
        dev = self.device
        t0 = time.perf_counter()
        tokens = torch.from_numpy(batch.tokens).to(dev, torch.int64)
        ref_logps = None
        if self.beta > 0:
            with torch.no_grad():
                ref_logps = sequence_logprobs(self.ref_params, self.cfg, tokens)
        self.params, self.opt_state, m = self._step_fn(
            self.params, self.opt_state, tokens,
            torch.from_numpy(batch.completion_mask).to(dev),
            torch.from_numpy(batch.advantages).to(dev),
            ref_logps,
        )
        _sync(dev)
        if self._engine is not None:  # the sampler serves the new weights from now on
            self._engine.update_params(self.params)
        self.step += 1
        stats.update(
            loss=m.loss, mean_logp=m.mean_logp, grad_norm=m.grad_norm, step=self.step,
            update_seconds=time.perf_counter() - t0,
        )
        self.last_batch = batch
        return stats
