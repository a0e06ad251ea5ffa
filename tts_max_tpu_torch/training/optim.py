"""Optimizer and LR schedules (counterpart of ``tts_max_tpu/training/optim.py``).

The cosine-with-warmup schedule: linear warmup 0 -> peak, cosine decay
peak -> peak/10, constant peak/10 afterwards, computed in fp32 as the JAX
package computes it. ``AdamW`` reproduces ``optax.adamw`` on dicts of
tensors: the same moment updates, bias correction, decoupled decay on every
leaf and learning-rate scaling, operation by operation, with the same
dtypes. Clipping belongs to the train step (with its non-finite guard).

Dtypes follow optax: the first moment is stored in ``mu_dtype`` ("bf16",
"fp32", or None for the parameter's dtype), the second in the parameter's
dtype; each update computes in the promoted dtype of the gradient and the
moment. With bf16 parameters there is no fp32 master copy, as in JAX.
The schedule is read at the step count *before* it is incremented, so under
warmup the first update uses lr = schedule(0) = 0, as optax does.
"""

from __future__ import annotations

import math

import torch

_MU_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32, None: None}


def cosine_warmup_schedule(learning_rate: float, warmup_steps: int, lr_decay_steps: int):
    if lr_decay_steps <= warmup_steps:
        raise ValueError("|lr_decay_steps| must be greater than |warmup_steps|.")
    f32 = torch.float32
    peak = torch.tensor(learning_rate, dtype=f32)
    start = torch.tensor(learning_rate / 10.0, dtype=f32)

    def schedule(step) -> float:
        step = torch.tensor(float(step), dtype=f32)
        warm = peak * step / max(1, warmup_steps)
        ratio = torch.clamp((step - warmup_steps) / (lr_decay_steps - warmup_steps), 0.0, 1.0)
        coeff = 0.5 * (1.0 + torch.cos(torch.tensor(math.pi, dtype=f32) * ratio))
        decay = start + coeff * (peak - start)
        return float(warm if bool(step < warmup_steps) else decay)

    return schedule


def constant_schedule(learning_rate: float):
    lr = float(torch.tensor(learning_rate, dtype=torch.float32))
    return lambda step: lr


def tree_items(tree, prefix=""):
    """("a/b/c" path, tensor) pairs of nested dicts (in sorted key order) and
    lists (in order, the index as the key)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def tree_leaves(tree) -> list[torch.Tensor]:
    return [t for _, t in tree_items(tree)]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def global_norm(grads, group=None, sharded=frozenset(), tensor_group=None,
                tensor_sharded=frozenset()) -> torch.Tensor:
    """sqrt of the sum of every element's square, in fp32 (0-d tensor).

    With ``group``, the leaves whose paths are in ``sharded`` hold this
    rank's shard of a leaf split over the group (fsdp); with
    ``tensor_group``, those in ``tensor_sharded`` its block of a leaf split
    over that group (a leaf may be split over both). Their squares are
    summed here, then over the groups (one all-reduce a group), before the
    leaves split over neither (the same on every rank, counted once) are
    added and the root taken."""
    items = list(tree_items(grads))
    sharded = sharded if group is not None else frozenset()
    tensor_sharded = tensor_sharded if tensor_group is not None else frozenset()
    zero = torch.zeros((), dtype=torch.float32, device=items[0][1].device)

    def part(f, t):
        return sum((g.float().square().sum() for p, g in items
                    if (p in sharded) == f and (p in tensor_sharded) == t), zero)

    whole = part(False, False)
    if not sharded and not tensor_sharded:
        return torch.sqrt(whole)
    from tts_max_tpu_torch.parallel.collectives import all_reduce_sum

    f_only, both, t_only = part(True, False), part(True, True), part(False, True)
    if sharded:
        f_only, both = all_reduce_sum(torch.stack([f_only, both]), group).unbind(0)
    if tensor_sharded:
        t_only = all_reduce_sum(t_only + both, tensor_group)
    else:
        t_only = t_only + both
    return torch.sqrt(whole + f_only + t_only)


class AdamW:
    """``optax.adamw(schedule, b1, b2, eps=1e-8, weight_decay, mu_dtype)``.

    State: ``{"count": int, "mu": tree, "nu": tree}``; ``update`` returns
    the updates (to be added to the parameters) and a new state, as optax
    does."""

    eps = 1e-8

    def __init__(self, learning_rate, betas=(0.9, 0.95), weight_decay: float = 0.1,
                 mu_dtype: str | None = None):
        self.schedule = (learning_rate if callable(learning_rate)
                         else constant_schedule(learning_rate))
        self.b1, self.b2 = betas
        self.weight_decay = weight_decay
        self.mu_dtype = _MU_DTYPES[mu_dtype]

    def init(self, params) -> dict:
        return {
            "count": 0,
            "mu": tree_map(lambda p: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype), params),
            "nu": tree_map(torch.zeros_like, params),
        }

    def update(self, grads, state, params):
        """One optax update: returns (updates, new_state)."""
        b1, b2, eps, wd = self.b1, self.b2, self.eps, self.weight_decay
        count = state["count"] + 1
        f32 = torch.float32
        # fp32 scalars on the host, made again on each leaf's device by a fill
        # (a copy from pageable host memory would stall the host on the card)
        scalars = {"bc1": float(1 - torch.tensor(b1, dtype=f32) ** count),
                   "bc2": float(1 - torch.tensor(b2, dtype=f32) ** count),
                   "lr": float(-torch.tensor(self.schedule(state["count"]), dtype=f32))}
        made = {}

        def scalar(name, like):
            key = (name, like.device, like.dtype)
            if key not in made:
                made[key] = torch.full((), scalars[name], dtype=like.dtype, device=like.device)
            return made[key]

        def leaf(g, mu, nu, p):
            mu = (1 - b1) * g + b1 * mu
            nu = (1 - b2) * (g ** 2) + b2 * nu
            mu_hat = mu / scalar("bc1", mu)
            nu_hat = nu / scalar("bc2", nu)
            u = mu_hat / (torch.sqrt(nu_hat) + eps)
            u = u + wd * p
            u = scalar("lr", u) * u
            if self.mu_dtype is not None:
                mu = mu.to(self.mu_dtype)
            return u, mu, nu

        out = tree_map(leaf, grads, state["mu"], state["nu"], params)
        updates = tree_map(lambda t: t[0], out)
        new_state = {"count": count,
                     "mu": tree_map(lambda t: t[1], out),
                     "nu": tree_map(lambda t: t[2], out)}
        return updates, new_state


def create_optimizer(
    learning_rate,
    betas: tuple[float, float] = (0.9, 0.95),
    weight_decay: float = 0.1,
    mu_dtype: str | None = None,
) -> AdamW:
    """AdamW with decay on every parameter. ``learning_rate`` may be a
    schedule. ``mu_dtype="bf16"`` stores the first moment in bf16; "fp32"
    pins fp32 moments even for bf16 params; None inherits the param dtype
    (optax's default). The JAX function's optional ``gradient_clip_value``
    is not taken: the train step clips."""
    return AdamW(learning_rate, betas, weight_decay, mu_dtype)


def apply_updates(params, updates):
    """``optax.apply_updates``: p + u, in p's dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
