"""The collectives of data-parallel, FSDP and tensor-parallel work, each
counted.

Each function adds one to its ``.calls`` where it issues its collective,
and nowhere else, as the kernels' wrappers count their launches: a run's
counts then show which collectives its steps made. They run on a group of
any size, one rank included: there is no shortcut for a world of one.

``all_gather`` and ``reduce_scatter_sum`` work along any dim: rank i of the
group holds block i of that dim (the rows JAX's ``NamedSharding`` gives the
device at index i of the axis).

The tensor-parallel operators, where GSPMD would insert the collectives in
the JAX package (Megatron's pair):

- ``tensor_enter``: the column-parallel entry, the identity forward and
  the sum of the grad over the tensor group backward (counted there);
- ``tensor_exit``: the row-parallel exit, the sum over the tensor group
  forward and the identity backward;
- ``tensor_whole``: a leaf's tensor blocks joined (``all_gather``) for a
  block that runs whole on every rank; backward, this rank's block of the
  grad, which every rank computed whole and alike.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _gather_single():
    return getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _reduce_scatter_single():
    return getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over the group, in place; returns it."""
    all_reduce_sum.calls += 1
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_reduce_flat(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """The sums over the group of several tensors through one all-reduce of
    their fp32 concatenation; each comes back in fp32, in its shape."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    all_reduce_sum(flat, group)
    out, o = [], 0
    for t in tensors:
        out.append(flat[o:o + t.numel()].view(t.shape))
        o += t.numel()
    return out


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``t`` over the group, in place; returns it."""
    all_reduce_max.calls += 1
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` of global rank ``src`` on every rank of the group, in place."""
    broadcast.calls += 1
    dist.broadcast(t, src=src, group=group)
    return t


def all_gather(shard: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's shards joined along ``dim`` in rank order."""
    all_gather.calls += 1
    n = dist.get_world_size(group)
    dim %= shard.ndim
    shard = shard.contiguous()
    out = shard.new_empty((n * shard.numel(),))
    _gather_single()(out, shard.reshape(-1), group=group)
    out = out.view(n, *shard.shape)
    if dim == 0:
        return out.reshape(n * shard.shape[0], *shard.shape[1:])
    full = list(shard.shape)
    full[dim] *= n
    return out.movedim(0, dim).reshape(full)


def reduce_scatter_sum(full: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``full`` over the group."""
    reduce_scatter_sum.calls += 1
    n = dist.get_world_size(group)
    shape = list(full.shape)
    if shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(full.shape)} does not divide by {n} ranks")
    shape[dim] //= n
    blocks = full.reshape(*full.shape[:dim], n, shape[dim], *full.shape[dim + 1:])
    blocks = blocks.movedim(dim, 0).contiguous()
    out = full.new_empty((full.numel() // n,))
    _reduce_scatter_single()(out, blocks.reshape(-1), op=dist.ReduceOp.SUM, group=group)
    return out.view(shape)


def barrier(group=None) -> None:
    """Wait for every rank of the group (the world by default)."""
    barrier.calls += 1
    dist.barrier(group=group)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        tensor_enter.calls += 1
        grad = grad.contiguous()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_tensor(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Whole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, dim, group):
        ctx.dim, ctx.n = dim % block.ndim, block.shape[dim]
        ctx.index = dist.get_rank(group)
        return all_gather(block, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None


def tensor_enter(x: torch.Tensor, group) -> torch.Tensor:
    """Column-parallel entry: ``x`` (the same on every tensor rank) as it
    is; its grad summed over the group in the backward."""
    return _Enter.apply(x, group)


def _sum_tensor(x, group):
    tensor_exit.calls += 1
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def tensor_exit(x: torch.Tensor, group) -> torch.Tensor:
    """Row-parallel exit: the sum over the group of the ranks' partial
    products; the grad passes through as it is. Without autograd the sum
    is taken in place in ``x`` (made contiguous)."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return _sum_tensor(x.contiguous(), group)
    return _Exit.apply(x, group)


def tensor_whole(block: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The whole leaf from the ranks' blocks along ``dim`` (one counted
    ``all_gather``); the grad of this rank's block is its slice of the
    whole grad."""
    return _Whole.apply(block, dim, group)


# counts() keeps the data-parallel and FSDP set; the tensor-parallel
# operators, the max and the broadcast are read through counts_tp()
COUNTED = (all_reduce_sum, all_gather, reduce_scatter_sum, barrier)
COUNTED_TP = (tensor_enter, tensor_exit, all_reduce_max, broadcast)
for _fn in COUNTED + COUNTED_TP:
    _fn.calls = 0


def reset_counts() -> None:
    for fn in COUNTED + COUNTED_TP:
        fn.calls = 0


def counts() -> dict[str, int]:
    return {fn.__name__: fn.calls for fn in COUNTED}


def counts_tp() -> dict[str, int]:
    return {fn.__name__: fn.calls for fn in COUNTED_TP}
