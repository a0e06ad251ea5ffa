"""Tensor parallelism of the Llama layers over a mesh's ``tensor`` group
(where GSPMD partitions the JAX package's forward under a mesh).

``TensorParallel.create(cfg, mesh, params)`` reads which leaves the rules
split over ``tensor`` (``sharding.params_specs`` on the config's full
shapes) and decides, a block at a time, how ``models/llama.py`` runs it on
this rank's blocks:

- the attention block runs on local heads (``n_heads/t`` query and
  ``n_kv_heads/t`` KV heads: ``wq``/``wk``/``wv`` column-parallel behind
  one ``tensor_enter``, ``wo`` row-parallel before one ``tensor_exit``)
  when its four leaves are split and both head counts divide by ``t``;
  the MLP block (``w_gate``/``w_up`` column-, ``w_down`` row-parallel)
  when its three leaves are split;
- a block that cannot (heads that do not divide, as JAX's engine
  replicates the KV for them, or leaves the rules left whole, such as
  quantized ones, whose paths match no ``kernel$`` rule) runs whole on
  every rank: its split leaves are gathered (``tensor_whole``) and no sum
  is taken over the ranks;
- the embedding, vocab-split, is a masked lookup of the local rows and a
  sum (``tensor_exit``), exact since every other rank adds zeros;
- the head, vocab-split, gives each rank the logits of its vocab block,
  joined along the last dim (``all_gather``) where the whole row is needed
  and reduced block-wise by the vocab-parallel cross entropy in training.
  A vocab window (``slice_logits_head``) is built replicated on every rank,
  once a weight update, from the blocks that cross it (one sum of
  zero-padded rows, exact): its logits then need no collective.

Every rank of the group ends a forward with the same hidden state and the
same logits, so greedy and seeded sampling and the host's decisions (stops,
admissions) agree across it.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from tts_max_tpu_torch.models import llama
from tts_max_tpu_torch.models.quantization import embed_lookup, is_quantized
from tts_max_tpu_torch.parallel import collectives
from tts_max_tpu_torch.parallel.mesh import TENSOR_AXIS, Mesh
from tts_max_tpu_torch.parallel.sharding import params_specs

_BLOCKS = {"attn": ("wq", "wk", "wv", "wo"), "mlp": ("w_gate", "w_up", "w_down")}
# the tensor dim of each layer leaf (in a layer's view, the stacked dim
# dropped) when the rules split it: output columns, or input rows
_SPLIT_DIM = {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "w_gate": 1, "w_up": 1, "w_down": 0}


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    group: object
    size: int
    rank: int
    embed: bool  # the embedding's vocab split over the group
    head: bool  # the head's vocab split (the embedding's when tied)
    attn: bool  # the attention block runs on local heads
    mlp: bool  # the MLP block runs on local columns
    # "block/leaf" -> dim (a layer's view) of the split leaves of a block
    # that runs whole: they are gathered inside the block
    whole: Mapping[str, int] = dataclasses.field(default_factory=dict)

    @classmethod
    def create(cls, cfg: llama.LlamaConfig, mesh: Mesh | None, params=None
               ) -> "TensorParallel | None":
        """The plan of ``mesh`` for ``cfg``, or None where the mesh does not
        split ``tensor``. ``params`` (full or this rank's blocks; only which
        leaves are quantized is read) defaults to plain leaves."""
        if mesh is None or not mesh.splits_tensor:
            return None
        t = mesh.size(TENSOR_AXIS)
        sizes = {"data": mesh.shape[0], "fsdp": 1, TENSOR_AXIS: t}
        specs = params_specs(llama.abstract_params(cfg), sizes, keep_unit=(TENSOR_AXIS,))

        def plain(path):
            node = params
            for k in path.split("/"):
                if node is None:
                    return True
                node = node.get(k) if isinstance(node, dict) else None
            return not (node is not None and is_quantized(node))

        def split(path, dim):
            spec = specs.get(path, ())
            return len(spec) > dim and spec[dim] == TENSOR_AXIS and plain(path)

        embed = split("embed/embedding", 0)
        head = embed if cfg.tie_embeddings else split("lm_head/kernel", 1)
        leaves = {f"{b}/{n}": split(f"layers/{b}/{n}/kernel", _SPLIT_DIM[n] + 1)
                  for b, names in _BLOCKS.items() for n in names}
        attn = (all(leaves[f"attn/{n}"] for n in _BLOCKS["attn"])
                and cfg.n_heads % t == 0 and cfg.n_kv_heads % t == 0)
        mlp = all(leaves[f"mlp/{n}"] for n in _BLOCKS["mlp"])
        runs = {"attn": attn, "mlp": mlp}
        whole = {key: _SPLIT_DIM[key.split("/")[1]] for key, s in leaves.items()
                 if s and not runs[key.split("/")[0]]}
        return cls(mesh.group(TENSOR_AXIS), t, mesh.index(TENSOR_AXIS), embed, head,
                   attn, mlp, whole)

    def kv_heads(self, cfg: llama.LlamaConfig) -> int:
        """The KV heads a rank's cache holds: its local ones, or all of them
        where the attention block runs whole."""
        return cfg.n_kv_heads // self.size if self.attn else cfg.n_kv_heads

    # --- the operators the layers call --------------------------------------

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return collectives.tensor_enter(x, self.group)

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        return collectives.tensor_exit(x, self.group)

    def block_weights(self, block: str, w: dict) -> tuple[dict, bool]:
        """(the block's kernels, whether it runs split): a block that runs
        whole gets its split leaves gathered."""
        if getattr(self, block):
            return w, True
        return {n: (collectives.tensor_whole(x, self.whole[f"{block}/{n}"], self.group)
                    if f"{block}/{n}" in self.whole else x) for n, x in w.items()}, False

    def lookup(self, emb: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
        """Vocab-parallel embedding: the local rows' lookup, zeros for the
        ids of other ranks' blocks, summed over the group."""
        n = emb.shape[0]
        local = tokens.long() - self.rank * n
        inside = (local >= 0) & (local < n)
        x = embed_lookup(emb, torch.where(inside, local, 0), dtype)
        return self.exit(torch.where(inside[..., None], x, x.new_zeros(())))

    def gather_logits(self, local: torch.Tensor) -> torch.Tensor:
        """The whole vocab row from the ranks' blocks [..., V/t]."""
        return collectives.all_gather(local, -1, self.group)

    def window_head(self, block: torch.Tensor, lo: int, size: int, dim: int) -> torch.Tensor:
        """Rows (``dim`` 0, an embedding) or columns (``dim`` 1, an
        ``lm_head``) [lo, lo + size) of the vocab-split head, whole on every
        rank: each rank writes the part its block holds into zeros, and
        one sum over the group joins them."""
        n = block.shape[dim]
        a, b = max(lo, self.rank * n), min(lo + size, (self.rank + 1) * n)
        shape = list(block.shape)
        shape[dim] = size
        out = block.new_zeros(shape)
        if a < b:
            out.narrow(dim, a - lo, b - a).copy_(block.narrow(dim, a - self.rank * n, b - a))
        return self.exit(out)
