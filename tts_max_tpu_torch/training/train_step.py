"""The SpeechLM training step (counterpart of ``tts_max_tpu/training/train_step.py``).

One call runs every gradient-accumulation micro-step, global-norm clipping
with a non-finite guard, and the AdamW update. ``train_step`` runs on one
device; ``make_train_step(mesh, ...)`` builds the same step over a
``(data, fsdp, tensor)`` mesh of ``torch.distributed`` ranks, each holding
its rows of the global batch, which its tensor peers share
(``ShardedTrainStep``).

The non-finite guard is JAX's: a non-finite global grad norm zeroes the
grads and the updates, so the parameters stay exactly unchanged while the
moments decay one step, and the step reports ``nonfinite=1`` for the loop
to checkpoint and stop.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tts_max_tpu_torch.core.constants import LOSS_IGNORE_TOKEN_ID
from tts_max_tpu_torch.models import llama
from tts_max_tpu_torch.parallel import collectives
from tts_max_tpu_torch.parallel.mesh import BATCH, DATA_AXIS, FSDP_AXIS, TENSOR_AXIS, Mesh
from tts_max_tpu_torch.parallel.sharding import ShardLayout, map_paths
from tts_max_tpu_torch.parallel.tensor import TensorParallel
from tts_max_tpu_torch.training.optim import AdamW, apply_updates, global_norm, tree_map


class StepMetrics(NamedTuple):
    loss: float  # mean loss over micro-steps
    grad_norm: float
    nonfinite: float  # 1.0 if the update was skipped
    tokens: int  # number of loss tokens


def _nll_sum(logits: torch.Tensor, labels: torch.Tensor):
    """(sum of the shifted cross entropy over valid tokens, their number)."""
    logits = logits[:, :-1]
    targets = labels[:, 1:].long()
    valid = targets != LOSS_IGNORE_TOKEN_ID
    safe = torch.where(valid, targets, 0)
    logprobs = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logprobs, -1, safe[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum(), valid.sum()


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor):
    """HF-convention shifted cross entropy: logits[:, :-1] predict
    labels[:, 1:]; -100 positions are ignored; mean over valid tokens.
    Returns (loss, number of valid tokens)."""
    s, n = _nll_sum(logits, labels)
    return s / n.clamp_min(1), n


def chunked_causal_lm_loss(params, cfg: llama.LlamaConfig, hidden: torch.Tensor,
                           labels: torch.Tensor, chunk_size: int):
    """Blockwise cross entropy over the 193856-token head.

    The sequence is cut into ``chunk_size``-token chunks; each computes its
    fp32 logits [B, C, V] and reduces them at once to ``logsumexp -
    target_logit``, under ``torch.utils.checkpoint`` so the backward pass
    recomputes a chunk's logits instead of storing them: one chunk's
    logits are live at a time. The same value as :func:`causal_lm_loss`."""
    nll_sum, n_valid = _chunked_nll_sum(params, cfg, hidden, labels, chunk_size)
    return nll_sum / n_valid.clamp_min(1), n_valid


class _VocabParallelNLL(torch.autograd.Function):
    """``logsumexp - target logit`` of logits whose vocab is split over a
    group, from this rank's block [..., V/t] (its first id ``lo``): the
    max, the sum of exponentials and the target logit are each reduced
    over the group (three all-reduces), so no rank holds a whole row. The
    backward is the block's ``softmax - onehot(target)``, with no
    collective."""

    @staticmethod
    def forward(ctx, logits, targets, lo, group):
        n = logits.shape[-1]
        m = collectives.all_reduce_max(logits.max(dim=-1).values, group)
        e = torch.exp(logits - m[..., None])
        s = collectives.all_reduce_sum(e.sum(dim=-1), group)
        local = targets - lo
        inside = (local >= 0) & (local < n)
        idx = torch.where(inside, local, 0)
        tgt = torch.where(inside, torch.gather(logits, -1, idx[..., None])[..., 0], 0.0)
        tgt = collectives.all_reduce_sum(tgt, group)
        ctx.save_for_backward(e.div_(s[..., None]), idx, inside)
        return torch.log(s) + m - tgt

    @staticmethod
    def backward(ctx, g):
        p, idx, inside = ctx.saved_tensors
        grad = p * g[..., None]
        grad.scatter_add_(-1, idx[..., None], -(g * inside)[..., None])
        return grad, None, None, None


def token_nll(hc, tc, params, cfg, tp=None):
    """``logsumexp - target logit`` [B, C] of hidden states ``hc`` [B, C, D]
    and targets ``tc`` [B, C] (in range), vocab-parallel under a ``tp``
    that splits the head."""
    if tp is not None and tp.head:
        logits, lo = llama.local_logits(hc, params, cfg, tp)
        return _VocabParallelNLL.apply(logits, tc, lo, tp.group)
    logits = llama._logits(hc, params, cfg, tp=tp)  # fp32 [B, C, V]
    return (torch.logsumexp(logits, dim=-1)
            - torch.gather(logits, -1, tc[..., None])[..., 0])


def _chunk_nll(hc, tc, params, cfg, tp=None):
    valid = tc != LOSS_IGNORE_TOKEN_ID
    nll = token_nll(hc, torch.where(valid, tc, 0), params, cfg, tp)
    return torch.where(valid, nll, 0.0).sum(), valid.sum()


def _chunked_nll_sum(params, cfg, hidden, labels, chunk_size, tp=None):
    h = hidden[:, :-1]
    t = labels[:, 1:].long()
    T = h.shape[1]
    C = min(chunk_size, T) if chunk_size > 0 else T
    nll_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    n_valid = torch.zeros((), dtype=torch.int64, device=h.device)
    for c0 in range(0, T, C):
        s, k = checkpoint(_chunk_nll, h[:, c0:c0 + C], t[:, c0:c0 + C], params, cfg, tp,
                          use_reentrant=False)
        nll_sum = nll_sum + s
        n_valid = n_valid + k
    return nll_sum, n_valid


def nll_sum(params, cfg: llama.LlamaConfig, batch, loss_chunk_size: int = 0,
            gather_layer=None, tp=None):
    """(the summed cross entropy of a micro-batch, its valid tokens): the
    loss before its division by the token count. Under ``tp`` the loss is
    always chunked (one chunk without ``loss_chunk_size``), vocab-parallel
    where the head is split."""
    hidden = llama.forward_hidden(params, cfg, batch["input_ids"], gather_layer, tp)
    if loss_chunk_size > 0 or tp is not None:
        return _chunked_nll_sum(params, cfg, hidden, batch["labels"], loss_chunk_size, tp)
    return _nll_sum(llama._logits(hidden, params, cfg), batch["labels"])


def loss_fn(params, cfg: llama.LlamaConfig, batch, loss_chunk_size: int = 0):
    s, n = nll_sum(params, cfg, batch, loss_chunk_size)
    return s / n.clamp_min(1), n


def to_device_batch(batch, device) -> dict:
    """numpy or torch arrays -> int64 tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
            .to(device=device, dtype=torch.int64) for k, v in batch.items()}


def _loss_and_grads(params, cfg, batch, loss_chunk_size):
    """(loss, valid tokens, grads in the params' dtypes) of one micro-batch."""
    leaves = []

    def track(p):
        q = p.detach().requires_grad_(True)
        leaves.append(q)
        return q

    live = tree_map(track, params)
    with torch.enable_grad():
        loss, toks = loss_fn(live, cfg, batch, loss_chunk_size)
        grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return loss.detach(), toks, tree_map(lambda _: next(it), params)


def train_step(params, opt_state, batch, *, cfg: llama.LlamaConfig, tx: AdamW,
               gradient_clip_value: float = 1.0, loss_chunk_size: int = 0):
    """One optimizer step over a macro-batch.

    batch: {"input_ids": [A, B, L], "labels": [A, B, L]} (numpy or tensors)
    with A gradient-accumulation micro-steps. For A > 1 the grads are summed
    in fp32 and divided by A, as JAX's fp32 ``zero_grads`` carry does.
    Returns (new_params, new_opt_state, StepMetrics); ``params`` is not
    modified."""
    batch = to_device_batch(batch, llama.params_device(params))
    accum = batch["input_ids"].shape[0]
    if accum == 1:
        loss, toks, grads = _loss_and_grads(
            params, cfg, {k: v[0] for k, v in batch.items()}, loss_chunk_size)
    else:
        grads, loss_sum, toks = None, torch.zeros(()), 0
        for a in range(accum):
            mloss, mtoks, g = _loss_and_grads(
                params, cfg, {k: v[a] for k, v in batch.items()}, loss_chunk_size)
            grads = (tree_map(lambda x: x.float(), g) if grads is None
                     else tree_map(torch.add, grads, g))
            loss_sum = loss_sum + mloss.cpu()
            toks = toks + mtoks
        grads = tree_map(lambda x: x / accum, grads)
        loss = loss_sum / accum

    with torch.no_grad():
        gnorm = global_norm(grads)
        new_params, new_state, finite = _clip_and_update(params, opt_state, grads, gnorm, tx,
                                                         gradient_clip_value)
    metrics = StepMetrics(loss=float(loss), grad_norm=float(gnorm),
                          nonfinite=0.0 if finite else 1.0, tokens=int(toks))
    return new_params, new_state, metrics


def _clip_and_update(params, opt_state, grads, gnorm, tx, gradient_clip_value):
    """Clip to the global norm ``gnorm`` (the same on every rank), guard a
    non-finite one, and step AdamW: (new params, new state, finite)."""
    finite = bool(torch.isfinite(gnorm))
    if finite:
        if float(gnorm) > gradient_clip_value:
            scale = gradient_clip_value / gnorm
            grads = tree_map(lambda g: g * scale, grads)
    else:
        grads = tree_map(torch.zeros_like, grads)
    updates, new_state = tx.update(grads, opt_state, params)
    return (apply_updates(params, updates) if finite else params), new_state, finite


def eval_step(params, batch, *, cfg: llama.LlamaConfig, loss_chunk_size: int = 0):
    """(loss, valid tokens) on one eval micro-batch [B, L]."""
    batch = to_device_batch(batch, llama.params_device(params))
    with torch.no_grad():
        loss, toks = loss_fn(params, cfg, batch, loss_chunk_size)
    return float(loss), int(toks)


# --- over a mesh -------------------------------------------------------------


class _GatherShard(torch.autograd.Function):
    """A leaf's full value from every rank's shard (all-gather along ``dim``)
    in the forward; its grad's rank-sum reduce-scattered back to the shard
    in the backward, summed in fp32 and rounded once to the leaf's dtype."""

    @staticmethod
    def forward(ctx, shard, dim, group):
        ctx.dim, ctx.group = dim, group
        return collectives.all_gather(shard, dim, group)

    @staticmethod
    def backward(ctx, grad):
        out = collectives.reduce_scatter_sum(grad.float(), ctx.dim, ctx.group)
        return out.to(grad.dtype), None, None


class ShardedTrainStep:
    """The train step over a ``(data, fsdp, tensor)`` mesh (JAX's
    ``make_train_step``), with ``train_step``'s signature and metrics.

    Each rank steps on its rows of the global batch, ``[A, B_local, L]``;
    ranks may pad to different lengths. The loss is JAX's global-batch
    mean: the valid tokens of each micro-batch are summed over the ranks
    first (one all-reduce a step), each rank backpropagates its summed
    cross entropy over that global count, and the grads are summed over the
    ranks, in fp32. The logged loss is the rank-sum of those terms.

    FSDP (``mesh.shards_params``): at rest a rank holds its block of every
    leaf the rules split over ``fsdp`` (``ShardLayout``), and the same block
    of its Adam moments. A layer's blocks are gathered inside the layer,
    so under remat its recompute gathers them again, and their grads are
    reduce-scattered in the backward; the embedding and head are gathered
    once a step and their grads reduce-scattered once a step. Whole leaves'
    grads are all-reduced in one flat fp32 buffer. Data-parallel alone
    (``dp``): every leaf is whole. The clip and the non-finite guard read
    the norm summed over the ranks, so they agree on every rank; AdamW is
    elementwise and runs on the shards as they are.

    Tensor parallelism (``mesh.splits_tensor``): a rank also keeps only its
    tensor block of the leaves the rules split over ``tensor`` (inside its
    fsdp shard under ``fsdp_tp``), and the layers run on those blocks
    (``parallel/tensor.py``) once the fsdp gathers have made them whole
    along ``fsdp``. The loss is the vocab-parallel cross entropy, chunked.
    Tensor peers see the same rows: the batch group, which sums the token
    counts, the losses and the grads, holds one rank of each tensor
    coordinate. A leaf the layers do not split (the norms) gets the same
    grad on every tensor peer, since each column-parallel entry sums its
    input's grad over the peers.
    """

    def __init__(self, mesh: Mesh, cfg: llama.LlamaConfig, tx: AdamW, params,
                 gradient_clip_value: float = 1.0, loss_chunk_size: int = 0):
        self.cfg, self.tx = cfg, tx
        self.clip, self.chunk = gradient_clip_value, loss_chunk_size
        self.layout = ShardLayout(params, mesh)
        self.tp = TensorParallel.create(cfg, mesh, params)
        self.sharded = self.layout.sharded
        self.tensor_sharded = self.layout.tensor_sharded
        self.fsdp_group, self.batch_group = mesh.group(FSDP_AXIS), mesh.group(BATCH)
        self.tensor_group = mesh.group(TENSOR_AXIS) if self.tp is not None else None
        self.data_group = (mesh.group(DATA_AXIS)
                           if mesh.size(DATA_AXIS) > 1 and self.sharded else None)
        # a layer's leaves, keyed under "layers/", lose the stacked dim
        self.layer_dims = {p[len("layers/"):]: self.layout.dims[p] - 1
                           for p in self.sharded if p.startswith("layers/")}
        self.once = sorted(p for p in self.sharded if not p.startswith("layers/"))

    def shard(self, params, opt_state):
        """This rank's shards of full params and optimizer state."""
        return self.layout.shard(params), self.layout.shard_opt_state(opt_state)

    def _gather_layer(self, lp):
        return map_paths(lambda p, x: (_GatherShard.apply(x, self.layer_dims[p],
                                                          self.fsdp_group)
                                       if p in self.layer_dims else x), lp)

    def _with_full(self, params):
        """``params`` with the once-a-step leaves (embedding, head) gathered."""
        return map_paths(lambda p, x: (self.layout.gather_fsdp_leaf(p, x) if p in self.once
                                       else x), params)

    def reduced_grads(self, params, micro_terms):
        """Backpropagate each micro-step's term (``fn(live params) -> (term,
        aux)``, run on the params with the once-a-step leaves gathered) and
        reduce the grads over the mesh: their sum over micro-steps (fp32
        when there are several) divided by their number, each leaf in the
        dtype the one-device step gives. Returns (grads laid out like
        ``params``, [(term, aux)] detached)."""
        accum = len(micro_terms)
        gathered = self._with_full(params)
        sums, outs = {}, []
        for fn in micro_terms:
            leaves = {}

            def track(p, x):
                leaves[p] = x.detach().requires_grad_(True)
                return leaves[p]

            live = map_paths(track, gathered)
            with torch.enable_grad():
                term, aux = fn(live)
                g = torch.autograd.grad(term, list(leaves.values()))
            outs.append((term.detach(), aux))
            for p, x in zip(leaves, g):
                x = x.float() if accum > 1 else x
                sums[p] = x if p not in sums else sums[p] + x
        del gathered
        grads = {p: (x / accum if accum > 1 else x) for p, x in sums.items()}
        for p in self.once:
            grads[p] = collectives.reduce_scatter_sum(grads[p].float(), self.layout.dims[p],
                                                      self.fsdp_group)
        if self.data_group is not None:
            sh = sorted(self.sharded)
            grads.update(zip(sh, collectives.all_reduce_flat([grads[p] for p in sh],
                                                             self.data_group)))
        whole = [p for p in grads if p not in self.sharded]
        grads.update(zip(whole, collectives.all_reduce_flat([grads[p] for p in whole],
                                                            self.batch_group)))
        # the dtypes the one-device step gives: the leaf's, fp32 under accumulation
        return map_paths(lambda p, x: grads[p].to(torch.float32 if accum > 1 else x.dtype),
                         params), outs

    def global_norm(self, grads) -> torch.Tensor:
        """The grads' global norm over the mesh, the same on every rank."""
        return global_norm(grads, self.fsdp_group, self.sharded, self.tensor_group,
                           self.tensor_sharded)

    def __call__(self, params, opt_state, batch):
        batch = to_device_batch(batch, llama.params_device(params))
        ids, labels = batch["input_ids"], batch["labels"]
        accum = ids.shape[0]
        n_global = collectives.all_reduce_sum(
            (labels[:, :, 1:] != LOSS_IGNORE_TOKEN_ID).sum(dim=(1, 2)), self.batch_group)

        def micro(a):
            def fn(live):
                s, _ = nll_sum(live, self.cfg, {"input_ids": ids[a], "labels": labels[a]},
                               self.chunk, self._gather_layer, self.tp)
                return s / n_global[a].clamp_min(1), None
            return fn

        grads, outs = self.reduced_grads(params, [micro(a) for a in range(accum)])
        losses = collectives.all_reduce_sum(torch.stack([t for t, _ in outs]),
                                            self.batch_group)
        loss = losses.sum() / accum
        with torch.no_grad():
            gnorm = self.global_norm(grads)
            new_params, new_state, finite = _clip_and_update(params, opt_state, grads, gnorm,
                                                             self.tx, self.clip)
        metrics = StepMetrics(loss=float(loss), grad_norm=float(gnorm),
                              nonfinite=0.0 if finite else 1.0, tokens=int(n_global.sum()))
        return new_params, new_state, metrics

    @torch.no_grad()
    def eval_step(self, params, batch):
        """(loss, valid tokens) of one eval micro-batch [B_local, L] over the
        global batch: the ranks' summed cross entropies over their summed
        counts, the same on every rank."""
        batch = to_device_batch(batch, llama.params_device(params))
        s, n = nll_sum(self._with_full(params), self.cfg, batch, self.chunk,
                       self._gather_layer, self.tp)
        v = collectives.all_reduce_sum(torch.stack([s.float(), n.float()]), self.batch_group)
        return float(v[0] / v[1].clamp_min(1)), int(v[1])


def make_train_step(mesh: Mesh, cfg: llama.LlamaConfig, tx: AdamW, params,
                    gradient_clip_value: float = 1.0, loss_chunk_size: int = 0):
    """The step over ``mesh`` for full ``params`` (the layout comes from
    their shapes); ``.shard(params, opt_state)`` gives a rank's state."""
    return ShardedTrainStep(mesh, cfg, tx, params, gradient_clip_value, loss_chunk_size)
