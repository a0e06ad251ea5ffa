"""The collectives of data-parallel and FSDP training, each counted.

Each function adds one to its ``.calls`` where it issues its collective,
and nowhere else, as the kernels' wrappers count their launches: a run's
counts then show which collectives its steps made. They run on a group of
any size, one rank included: there is no shortcut for a world of one.

``all_gather`` and ``reduce_scatter_sum`` work along any dim: rank i of the
group holds block i of that dim (the rows JAX's ``NamedSharding`` gives the
device at index i of the axis).
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


def all_gather(shard: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's shards joined along ``dim`` in rank order."""
    all_gather.calls += 1
    n = dist.get_world_size(group)
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


COUNTED = (all_reduce_sum, all_gather, reduce_scatter_sum, barrier)
for _fn in COUNTED:
    _fn.calls = 0


def reset_counts() -> None:
    for fn in COUNTED:
        fn.calls = 0


def counts() -> dict[str, int]:
    return {fn.__name__: fn.calls for fn in COUNTED}
