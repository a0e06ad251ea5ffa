"""Parameter partition rules and the shards they give (counterpart of
``tts_max_tpu/parallel/sharding.py``).

The rules are the JAX package's, on the same "/"-joined paths of the
stacked ``[L, ...]`` layer leaves; a spec is a plain tuple of axis names
(or None) a dim. ``params_specs`` applies JAX's divisibility rule: an axis
that does not divide its dim, or has size 1, is dropped and the dim is
replicated. ``ShardLayout`` holds, for each leaf, the dim split over
``fsdp`` and the dim split over ``tensor`` (None: replicated): the rank at
``(f, t)`` keeps block f of the one and block t of the other, and so do
the leaf's Adam moments (ZeRO). Under ``fsdp_tp`` ``wq`` ``[L, D, q_dim]``
keeps block ``(f, t)`` of dims ``(1, 2)``.
"""

from __future__ import annotations

import re

import torch

from tts_max_tpu_torch.parallel import collectives
from tts_max_tpu_torch.parallel.mesh import FSDP_AXIS, TENSOR_AXIS, Mesh
from tts_max_tpu_torch.training.optim import tree_items

# (path regex, spec): the first match wins. "layers/..." leaves are stacked
# over a leading n_layers dim, hence their leading None.
LLAMA_PARTITION_RULES: tuple[tuple[str, tuple], ...] = (
    (r"embed/embedding$", (TENSOR_AXIS, FSDP_AXIS)),
    (r"lm_head/kernel$", (FSDP_AXIS, TENSOR_AXIS)),
    (r"layers/attn/w[qkv]/kernel$", (None, FSDP_AXIS, TENSOR_AXIS)),
    (r"layers/attn/wo/kernel$", (None, TENSOR_AXIS, FSDP_AXIS)),
    (r"layers/mlp/w_(gate|up)/kernel$", (None, FSDP_AXIS, TENSOR_AXIS)),
    (r"layers/mlp/w_down/kernel$", (None, TENSOR_AXIS, FSDP_AXIS)),
    # unstacked variants (single-layer modules, e.g. codec transformer blocks)
    (r"attn/w[qkv]/kernel$", (FSDP_AXIS, TENSOR_AXIS)),
    (r"attn/wo/kernel$", (TENSOR_AXIS, FSDP_AXIS)),
    (r"mlp/w_(gate|up)/kernel$", (FSDP_AXIS, TENSOR_AXIS)),
    (r"mlp/w_down/kernel$", (TENSOR_AXIS, FSDP_AXIS)),
    (r"norm/scale$", ()),
    (r".*", ()),
)


def path_str(path) -> str:
    """"a/b/c" of a sequence of keys (a string is returned as it is)."""
    return path if isinstance(path, str) else "/".join(str(p) for p in path)


def spec_for_path(path: str, rules=LLAMA_PARTITION_RULES) -> tuple:
    for pattern, spec in rules:
        if re.search(pattern, path):
            return spec
    return ()


def map_paths(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: map_paths(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_paths(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def leaf_spec(path: str, shape, axis_sizes: dict, rules=LLAMA_PARTITION_RULES,
              keep_unit: tuple = ()) -> tuple:
    """The spec of one leaf, one entry a dim: its rule cut to the leaf's rank,
    each axis kept where its size divides the dim and is above 1 (or is in
    ``keep_unit``), else None."""
    spec = tuple(spec_for_path(path, rules))[:len(shape)]
    spec = spec + (None,) * (len(shape) - len(spec))
    out = []
    for dim, axis in zip(shape, spec):
        size = axis_sizes.get(axis, 1) if axis is not None else 1
        keep = axis is not None and dim % size == 0 and (size > 1 or axis in keep_unit)
        out.append(axis if keep else None)
    return tuple(out)


def params_specs(params, axis_sizes: dict, rules=LLAMA_PARTITION_RULES,
                 keep_unit: tuple = ()) -> dict[str, tuple]:
    """{path: spec} of a param tree (JAX's ``params_shardings`` as tuples)."""
    return {p: leaf_spec(p, tuple(x.shape), axis_sizes, rules, keep_unit)
            for p, x in tree_items(params)}


class ShardLayout:
    """Which dim of each param leaf the mesh splits over ``fsdp`` and over
    ``tensor``, and the shard / gather of trees laid out like the params
    (the params, their grads, Adam's ``mu`` and ``nu``). Leaves not split
    stay whole on every rank. Under ``mesh.shards_params`` an fsdp axis of
    size 1 still splits (into one block), and under ``mesh.splits_tensor``
    a tensor axis of size 1, so one rank runs the collectives many would."""

    def __init__(self, params, mesh: Mesh, rules=LLAMA_PARTITION_RULES):
        sizes = {"data": mesh.shape[0], FSDP_AXIS: mesh.shape[1], TENSOR_AXIS: mesh.shape[2]}
        keep = ((FSDP_AXIS,) if mesh.shards_params else ()) + (
            (TENSOR_AXIS,) if mesh.splits_tensor else ())
        self.mesh = mesh
        self.specs = params_specs(params, sizes, rules, keep)
        self.dims = {p: (s.index(FSDP_AXIS) if FSDP_AXIS in s else None)
                     for p, s in self.specs.items()}
        self.tdims = {p: (s.index(TENSOR_AXIS) if TENSOR_AXIS in s else None)
                      for p, s in self.specs.items()}
        self.n, self.index = mesh.size(FSDP_AXIS), mesh.index(FSDP_AXIS)
        self.nt, self.tindex = mesh.size(TENSOR_AXIS), mesh.index(TENSOR_AXIS)

    @property
    def sharded(self) -> frozenset:
        """The leaves split over ``fsdp``."""
        return frozenset(p for p, d in self.dims.items() if d is not None)

    @property
    def tensor_sharded(self) -> frozenset:
        """The leaves split over ``tensor``."""
        return frozenset(p for p, d in self.tdims.items() if d is not None)

    def shard_leaf(self, path: str, full: torch.Tensor) -> torch.Tensor:
        d, t = self.dims.get(path), self.tdims.get(path)
        if d is None and t is None:
            return full
        for dim, n, i in ((d, self.n, self.index), (t, self.nt, self.tindex)):
            if dim is not None:
                b = full.shape[dim] // n
                full = full.narrow(dim, i * b, b)
        return full.clone()

    def shard(self, tree):
        """This rank's shards of a full tree laid out like the params."""
        return map_paths(self.shard_leaf, tree)

    def gather_fsdp_leaf(self, path: str, local: torch.Tensor) -> torch.Tensor:
        """The leaf's tensor block from the fsdp group's shards."""
        d = self.dims.get(path)
        if d is None:
            return local
        return collectives.all_gather(local, d, self.mesh.group(FSDP_AXIS))

    def gather_leaf(self, path: str, local: torch.Tensor) -> torch.Tensor:
        """The whole leaf: over ``fsdp``, then over ``tensor``."""
        full = self.gather_fsdp_leaf(path, local)
        t = self.tdims.get(path)
        if t is None:
            return full
        return collectives.all_gather(full, t, self.mesh.group(TENSOR_AXIS))

    def gather(self, tree, to_cpu: bool = False, keep: bool = True):
        """The full tree from every rank's shards (a collective: every rank
        calls it); ``to_cpu`` moves each leaf to the host as it is gathered,
        so that one full leaf at a time is on the device. A rank that does
        not ``keep`` the tree drops each leaf once it is gathered, and gets
        None."""
        def one(path, leaf):
            full = self.gather_leaf(path, leaf)
            if not keep:
                return None
            return full.detach().cpu() if to_cpu else full

        out = map_paths(one, tree)
        return out if keep else None

    def shard_opt_state(self, state: dict) -> dict:
        return {**state, "mu": self.shard(state["mu"]), "nu": self.shard(state["nu"])}

    def gather_opt_state(self, state: dict, to_cpu: bool = False, keep: bool = True):
        mu, nu = self.gather(state["mu"], to_cpu, keep), self.gather(state["nu"], to_cpu, keep)
        return {**state, "mu": mu, "nu": nu} if keep else None
