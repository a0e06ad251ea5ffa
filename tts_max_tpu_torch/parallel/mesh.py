"""The launcher's rendezvous and the ``(data, fsdp, tensor)`` mesh over
``torch.distributed`` (counterpart of ``tts_max_tpu/parallel/mesh.py``).

The axes keep the JAX package's roles:

- ``data``: batch parallelism (DDP): params replicated, grads summed;
- ``fsdp``: batch parallelism with every rule-sharded param and its Adam
  moments split over the ranks (FSDP / ZeRO);
- ``tensor``: tensor parallelism (Megatron's layout): the rules split the
  vocab of the embedding and head, the output columns of ``wq``/``wk``/
  ``wv``/``w_gate``/``w_up`` and the input rows of ``wo``/``w_down``; the
  tensor peers of a rank read the same batch rows.

Ranks lie on the mesh in row-major order, ``rank = (d * fsdp + f) * tensor +
t``, as JAX's device array. A mesh may also lie over a list of ranks (a
sub-mesh, as RLHF's trainer/sampler topology makes two), in the list's
order. Where JAX's collectives come from GSPMD, the
port calls them itself (``collectives.py``) on process groups made here.

A process joins a group whenever a launcher's variables are present, world
size 1 included (``torchrun --nproc_per_node 1``), on NCCL for a ``cuda``
device and on gloo for the CPU. Without them it runs alone, with no group.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import os
from typing import Mapping

import torch
import torch.distributed as dist

from tts_max_tpu_torch.core.config import MeshConfig, Strategy

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tensor"
AXIS_NAMES = (DATA_AXIS, FSDP_AXIS, TENSOR_AXIS)
BATCH = "batch"  # the group of (data, fsdp): the ranks that split one batch


@dataclasses.dataclass(frozen=True)
class EnvironmentContext:
    """Process-level distributed context; ``owns_group``: the group was made
    by ``initialize_distributed`` (``destroy_distributed`` ends it)."""

    global_rank: int = 0
    local_rank: int = 0
    world_size: int = 1
    num_nodes: int = 1
    is_main: bool = True
    owns_group: bool = False


@dataclasses.dataclass(frozen=True)
class LauncherEnv:
    """What a launcher told this process: its ranks, the world and where to
    meet (``source`` "torchrun" or "slurm")."""

    source: str
    rank: int
    local_rank: int
    world_size: int
    num_nodes: int
    master_addr: str
    master_port: int

    def context(self, owns_group: bool = False) -> EnvironmentContext:
        return EnvironmentContext(self.rank, self.local_rank, self.world_size,
                                  self.num_nodes, self.rank == 0, owns_group)


def _master(env: Mapping[str, str], source: str) -> tuple[str, int]:
    addr, port = env.get("MASTER_ADDR"), env.get("MASTER_PORT")
    if not (addr and port):
        raise ValueError(f"{source} rank variables are set but MASTER_ADDR/MASTER_PORT "
                         "are not: the ranks have nowhere to meet")
    return addr, int(port)


def launcher_env(env: Mapping[str, str] | None = None) -> LauncherEnv | None:
    """The rendezvous a launcher set up, in the JAX package's precedence:

    1. torchrun's ``RANK``/``WORLD_SIZE`` (with ``LOCAL_RANK``,
       ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``);
    2. SLURM's ``SLURM_PROCID``/``SLURM_NTASKS`` (with ``SLURM_LOCALID``,
       ``SLURM_NNODES``) and ``MASTER_ADDR``/``MASTER_PORT`` exported by the
       job script. A SLURM job of one task without them is a single process;
       of more tasks it raises;
    3. neither: None, a single process.
    """
    env = os.environ if env is None else env
    if "RANK" in env and "WORLD_SIZE" in env:
        world = int(env["WORLD_SIZE"])
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
        return LauncherEnv("torchrun", int(env["RANK"]), int(env.get("LOCAL_RANK", 0)),
                           world, max(1, world // max(1, local_world)),
                           *_master(env, "torchrun"))
    if "SLURM_PROCID" in env and "SLURM_NTASKS" in env:
        world = int(env["SLURM_NTASKS"])
        if world == 1 and not (env.get("MASTER_ADDR") and env.get("MASTER_PORT")):
            return None
        return LauncherEnv("slurm", int(env["SLURM_PROCID"]), int(env.get("SLURM_LOCALID", 0)),
                           world, int(env.get("SLURM_NNODES", 1)), *_master(env, "SLURM"))
    return None


def initialize_distributed(device: str | torch.device = "cuda") -> EnvironmentContext:
    """Join the launcher's group (NCCL on ``cuda:LOCAL_RANK``, gloo on the
    CPU); a single process without a launcher. A group that exists already
    is kept. ``cuda`` without a card raises: there is no fallback."""
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("SLURM_LOCALID", 0)))
        return EnvironmentContext(rank, local, world, 1, rank == 0)
    launcher = launcher_env()
    if launcher is None:
        return EnvironmentContext()
    kind = torch.device(device).type
    bound = {}
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda rendezvous was asked for but torch.cuda.is_available() "
                               "is False; pass --device cpu for gloo on the CPU")
        torch.cuda.set_device(launcher.local_rank)
        # bound to its card, NCCL sets up its communicators here and in
        # new_group, not inside the first step
        bound = {"device_id": torch.device("cuda", launcher.local_rank)}
    dist.init_process_group(
        "nccl" if kind == "cuda" else "gloo",
        init_method=f"tcp://{launcher.master_addr}:{launcher.master_port}",
        rank=launcher.rank, world_size=launcher.world_size,
        timeout=datetime.timedelta(minutes=10), **bound)
    return launcher.context(owns_group=True)


def destroy_distributed(env: EnvironmentContext) -> None:
    """End the group ``initialize_distributed`` made for ``env`` (a group the
    caller made is left alone), so that a process can run entry points in
    turn."""
    if env.owns_group and dist.is_initialized():
        dist.destroy_process_group()


def resolve_mesh_shape(cfg: MeshConfig, n_devices: int) -> tuple[int, int, int]:
    fsdp = max(1, cfg.fsdp)
    tensor = max(1, cfg.tensor)
    if n_devices % (fsdp * tensor) != 0:
        raise ValueError(
            f"mesh (fsdp={fsdp}, tensor={tensor}) does not divide {n_devices} devices")
    data = cfg.data if cfg.data > 0 else n_devices // (fsdp * tensor)
    if data * fsdp * tensor != n_devices:
        raise ValueError(f"mesh ({data},{fsdp},{tensor}) != device count {n_devices}")
    return data, fsdp, tensor


def mesh_for_strategy(strategy: Strategy, n_devices: int) -> tuple[int, int, int]:
    """A strategy's ``(data, fsdp, tensor)`` shape over ``n_devices`` ranks,
    as JAX's ``mesh_for_strategy`` lays it out."""
    n = n_devices
    s = Strategy(strategy).canonical()
    if s in (Strategy.SINGLE, Strategy.DP):
        return resolve_mesh_shape(MeshConfig(data=-1, fsdp=1, tensor=1), n)
    if s is Strategy.FSDP:
        return resolve_mesh_shape(MeshConfig(data=1, fsdp=n, tensor=1), n)
    if s is Strategy.TP:
        return resolve_mesh_shape(MeshConfig(data=1, fsdp=1, tensor=n), n)
    if s is Strategy.FSDP_TP:
        return resolve_mesh_shape(MeshConfig(data=-1, fsdp=max(1, n // 2), tensor=2), n)
    raise ValueError(f"unknown strategy {strategy}")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ``(data, fsdp, tensor)`` mesh of a group: its shape, this rank's
    coordinates, and the process group of each axis and of ``batch`` (data x
    fsdp) through this rank. ``shards_params`` says whether rule-sharded
    params are split over ``fsdp``: under the fsdp strategy they are at
    every size, size 1 included, so that one rank runs the same gathers and
    reduce-scatters as many. ``splits_tensor`` says the same of ``tensor``:
    true under ``tp`` and ``fsdp_tp`` at every size, where one rank runs
    the tensor-parallel layers with one block a leaf and makes every
    collective."""

    shape: tuple[int, int, int]
    coords: tuple[int, int, int] = (0, 0, 0)
    groups: Mapping[str, object] = dataclasses.field(default_factory=dict)
    shards_params: bool = False
    splits_tensor: bool = False

    def size(self, axis: str) -> int:
        if axis == BATCH:
            return self.shape[0] * self.shape[1]
        return self.shape[AXIS_NAMES.index(axis)]

    def index(self, axis: str) -> int:
        if axis == BATCH:
            return self.coords[0] * self.shape[1] + self.coords[1]
        return self.coords[AXIS_NAMES.index(axis)]

    def group(self, axis: str):
        return self.groups[axis]


def _axis_members(shape, axes) -> list[tuple[int, ...]]:
    """Every group of ranks that differ only along ``axes``, in one order
    that every rank computes alike."""
    d, f, t = shape
    groups: dict[tuple, list[int]] = {}
    for c in itertools.product(range(d), range(f), range(t)):
        fixed = tuple(v for name, v in zip(AXIS_NAMES, c) if name not in axes)
        groups.setdefault(fixed, []).append((c[0] * f + c[1]) * t + c[2])
    return [tuple(g) for g in groups.values()]


def build_mesh(shape: tuple[int, int, int], strategy: Strategy | None = None,
               ranks=None) -> Mesh | None:
    """The mesh of ``shape`` over ``ranks`` (default: the whole group, whose
    world size ``shape`` must then equal), or None on a rank outside them.
    Every rank of the world calls it, in one order, member or not:
    ``new_group`` is collective over the world, so every rank makes every
    axis group; groups with the same ranks are made once."""
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs a process group (initialize_distributed)")
    world, rank = dist.get_world_size(), dist.get_rank()
    ranks = tuple(range(world)) if ranks is None else tuple(ranks)
    if shape[0] * shape[1] * shape[2] != len(ranks):
        raise ValueError(f"mesh {tuple(shape)} != {len(ranks)} ranks")
    d, f, t = shape
    made: dict[tuple[int, ...], object] = {}
    groups = {}
    for name, axes in ((DATA_AXIS, (DATA_AXIS,)), (FSDP_AXIS, (FSDP_AXIS,)),
                       (TENSOR_AXIS, (TENSOR_AXIS,)), (BATCH, (DATA_AXIS, FSDP_AXIS))):
        for members in _axis_members(shape, axes):
            members = tuple(ranks[i] for i in members)
            if members not in made:
                made[members] = dist.new_group(list(members))
            if rank in members:
                groups[name] = made[members]
    if rank not in ranks:
        return None
    i = ranks.index(rank)
    coords = (i // (f * t), (i // t) % f, i % t)
    s = Strategy(strategy).canonical() if strategy is not None else None
    return Mesh(tuple(shape), coords, groups,
                shards_params=f > 1 or s in (Strategy.FSDP, Strategy.FSDP_TP),
                splits_tensor=t > 1 or s in (Strategy.TP, Strategy.FSDP_TP))
