"""RLHF's trainer/sampler topology over ``torch.distributed`` (counterpart of
``tts_max_tpu/training/rlhf/topology.py``).

The world's ranks split into two disjoint meshes: the trainer's, where the
GRPO update runs on FSDP-sharded params and Adam moments, and the
sampler's, a tensor-parallel mesh where ``generate`` or the serving engine
makes the rollouts (the vLLM server's role). ``push_to_sampler`` is the
weight broadcast between rollout rounds: the trainer's shards are gathered
leaf by leaf, trainer rank 0 broadcasts each whole leaf to the sampler
ranks, and each keeps its tensor block, so one whole leaf at a time is in
flight.

Each process is one rank, so each holds only its side: the trainer's mesh
and shards on a trainer rank, the sampler's on a sampler rank (the other
side's are None). ``new_group`` is collective over the world, so every
rank builds both meshes, in one order. The split needs two ranks at least,
on distinct devices: on one card it cannot run (NCCL takes one rank a
card), and the tests run it over gloo ranks on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from tts_max_tpu_torch.core.config import MeshConfig
from tts_max_tpu_torch.parallel import collectives, mesh as pmesh
from tts_max_tpu_torch.parallel.sharding import ShardLayout
from tts_max_tpu_torch.training.optim import tree_items


def topology_shapes(n: int, n_sampler: int, trainer_cfg: MeshConfig | None = None,
                    sampler_cfg: MeshConfig | None = None):
    """The trainer's and the sampler's ``(data, fsdp, tensor)`` over ``n``
    ranks, as JAX lays them out: the last ``n_sampler`` ranks form the
    sampler, ``(1, 1, n_sampler)`` by default; the rest the trainer,
    ``(-1, 2, 1)`` when their count is even, else ``(-1, 1, 1)``."""
    if not 1 <= n_sampler < n:
        raise ValueError(f"n_sampler={n_sampler} must leave >=1 trainer device of {n}")
    n_trainer = n - n_sampler
    if trainer_cfg is None:
        trainer_cfg = MeshConfig(data=-1, fsdp=2 if n_trainer % 2 == 0 else 1, tensor=1)
    if sampler_cfg is None:
        sampler_cfg = MeshConfig(data=1, fsdp=1, tensor=n_sampler)
    return (pmesh.resolve_mesh_shape(trainer_cfg, n_trainer),
            pmesh.resolve_mesh_shape(sampler_cfg, n_sampler))


@dataclasses.dataclass
class TrainerSamplerTopology:
    """Two disjoint meshes over the world's ranks and the weight push.
    ``trainer_mesh`` is this rank's trainer mesh (None on a sampler rank),
    ``sampler_mesh`` its sampler mesh (None on a trainer rank)."""

    trainer_mesh: pmesh.Mesh | None
    sampler_mesh: pmesh.Mesh | None
    trainer_ranks: tuple[int, ...]
    sampler_ranks: tuple[int, ...]
    push_group: object  # trainer rank 0 and the sampler ranks
    _full: dict | None = None  # path -> (shape, dtype) of the whole params
    _device: torch.device | None = None
    _trainer_layout: ShardLayout | None = None
    _sampler_layout: ShardLayout | None = None

    @classmethod
    def create(cls, n_sampler: int, trainer_cfg: MeshConfig | None = None,
               sampler_cfg: MeshConfig | None = None) -> "TrainerSamplerTopology":
        """Split the world (every rank calls this): the LAST ``n_sampler``
        ranks become the sampler's tensor-parallel mesh, the rest the
        trainer's. Raises JAX's ``ValueError`` unless ``1 <= n_sampler <
        world``, a world of one process included."""
        n = dist.get_world_size() if dist.is_initialized() else 1
        trainer_shape, sampler_shape = topology_shapes(n, n_sampler, trainer_cfg, sampler_cfg)
        trainer = tuple(range(n - n_sampler))
        sampler = tuple(range(n - n_sampler, n))
        t_mesh = pmesh.build_mesh(trainer_shape, ranks=trainer)
        s_mesh = pmesh.build_mesh(sampler_shape, "tp", ranks=sampler)
        push = dist.new_group([trainer[0], *sampler])
        return cls(t_mesh, s_mesh, trainer, sampler, push)

    @property
    def is_trainer(self) -> bool:
        return self.trainer_mesh is not None

    # --- weight placement ---------------------------------------------------

    def shard_for_trainer(self, params):
        """This trainer rank's shards of the whole ``params`` (every rank
        calls it with them: it records their shapes for the push), or None
        on a sampler rank."""
        self._full = {p: (tuple(x.shape), x.dtype) for p, x in tree_items(params)}
        self._device = next(x for _, x in tree_items(params)).device
        if self.sampler_mesh is not None:
            self._sampler_layout = ShardLayout(params, self.sampler_mesh)
        if not self.is_trainer:
            return None
        self._trainer_layout = ShardLayout(params, self.trainer_mesh)
        return self._trainer_layout.shard(params)

    def push_to_sampler(self, params):
        """Every rank calls it. On a trainer rank ``params`` are its shards
        (as ``shard_for_trainer`` laid them out) and it returns None; on a
        sampler rank ``params`` is not read and it returns this rank's
        tensor blocks of the trainer's params, bit for bit."""
        if self._full is None:
            raise RuntimeError("push_to_sampler before shard_for_trainer")
        src = self.trainer_ranks[0]
        in_push = dist.get_rank() in (src, *self.sampler_ranks)
        local = dict(tree_items(params)) if self.is_trainer else {}
        out = {}
        for path, (shape, dtype) in self._full.items():
            if self.is_trainer:
                full = self._trainer_layout.gather_leaf(path, local[path]).contiguous()
            else:
                full = torch.empty(shape, dtype=dtype, device=self._device)
            if in_push:
                collectives.broadcast(full, src, self.push_group)
            if not self.is_trainer:
                out[path] = self._sampler_layout.shard_leaf(path, full)
            del full
        if self.is_trainer:
            return None
        return _unflatten(out)


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out
