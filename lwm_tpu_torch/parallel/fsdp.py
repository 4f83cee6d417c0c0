"""Weights and optimizer state sharded over the shard group (fsdp × sp).

Counterpart of XLA's gathers under the JAX trainer's sharded `jax.jit`
(`lwm_tpu/train.py:322-359`: the train state partitioned by the rule table,
params and moments alike). The port builds it on the mesh's own
collectives (`parallel.mesh`), not on FSDP2's `fully_shard`: the same code
runs over NCCL on cards and over gloo on the CPU or for two ranks sharing
one card, where gloo takes host tensors only and the `Mesh` collectives
stage card tensors through host memory.

- `shard_model(model)` (called by `train.create_train_state`) replaces each
  parameter whose rule gives a dim to ("fsdp", "sp") by this rank's slice
  of it (`parallel.partition.local_shard`, after its tp slice) and records
  every parameter's `Placement` in `model.placements`. A dim that does not
  split raises, naming the leaf and the mesh.
- A block's forward (`models.llama.LLaMABlock`) gathers its sharded
  weights over the shard group in one flat all-gather (`gather_weights`,
  `parallel.mesh.GatherShards`); the whole copies live while the block
  runs and are freed when its outputs no longer need them (under the
  `nothing_saveable` and `save_flash` remats the backward replays the block
  and so gathers them again). The embeddings and the heads gather theirs
  at use (`full_weight`).
- The backward of a gather reduce-scatters the whole weights' gradients
  over the shard group (a sum), so a shard's `.grad` is the shard group's;
  the trainer then sums gradients over dp (`train.reduce_gradients`),
  never over tp: a tp-split leaf's gradient is its own slice's, and a leaf
  held whole over tp has the same gradient on every tp rank.
- `Placement` says how a rank holds a leaf: its whole shape, the dim split
  over tp and the dim split over the shard group. `local_part` and
  `whole` go from one to the other (the checkpoint's load and save, the
  seeded init).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from lwm_tpu_torch.parallel.mesh import GatherShards
from lwm_tpu_torch.parallel.partition import (
    local_shard, local_slice, shard_dim, tp_dim, whole_leaf,
)


@dataclasses.dataclass(frozen=True)
class Placement:
    """How this rank holds leaf `name` on `mesh`: `shape` the whole
    leaf's; `tp` the dim split over tp, `shard` the dim split over the
    shard group (None: held whole over it)."""

    name: str
    shape: tuple
    tp: Optional[int]
    shard: Optional[int]
    mesh: object = dataclasses.field(compare=False, default=None)

    @property
    def over_tp(self):
        return self.tp is not None

    @property
    def over_shard(self):
        return self.shard is not None

    def local_part(self, whole):
        """This rank's part of the whole leaf (a copy, or the leaf itself
        where the rank holds it whole)."""
        if tuple(whole.shape) != self.shape:
            raise ValueError(f"{self.name} is {tuple(whole.shape)}, the model's {self.shape}")
        if self.over_shard:
            return local_shard(self.name, whole, self.mesh)
        return local_slice(self.name, whole, self.mesh) if self.over_tp else whole

    def whole(self, part):
        """The whole leaf from the ranks' parts (a collective over the shard
        group and tp; the part itself where the rank holds it whole)."""
        if self.over_shard:
            return whole_leaf(self.name, part, self.mesh)
        return self.mesh.all_gather(part, "tp", self.tp) if self.over_tp else part


def _placement(name, local_shape, mesh, sharded):
    """The Placement of a leaf of tp-local shape `local_shape`."""
    shape = list(local_shape)
    t = tp_dim(name) if mesh is not None and mesh.tp > 1 else None
    if t is not None:
        shape[t] *= mesh.tp
    s = shard_dim(name) if sharded and mesh.shard > 1 else None
    return Placement(name, tuple(shape), t, s, mesh)


def placements(model):
    """{name: Placement} of `model`'s parameters: `model.placements` once
    sharded, else derived from its mesh's tp (held whole over the shard
    group, as inference holds them)."""
    got = model.__dict__.get("placements")
    if got is not None:
        return got
    mesh = getattr(model, "mesh", None)
    return {n: _placement(n, p.shape, mesh, False) for n, p in model.named_parameters()}


# modules that gather their own weight at use (`full_weight`), by name
_SELF_GATHERED = ("wte", "lm_head", "vte", "vision_head")


def shard_model(model):
    """Shard `model`'s parameters over its mesh's shard group in place (see
    the module note); a no-op without a mesh or with a shard group of one
    rank, apart from recording the placements. Returns the model."""
    mesh = getattr(model, "mesh", None)
    if "placements" in model.__dict__:
        return model
    if mesh is None:
        model.placements = placements(model)
        return model
    got = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            pl = _placement(name, p.shape, mesh, True)
            if pl.over_shard:
                n = mesh.shard
                if p.shape[pl.shard] % n:
                    raise ValueError(
                        f"{name}: dim {pl.shard} of {tuple(p.shape)} (tp-local) does not split over "
                        f"fsdp x sp={n} (mesh {'x'.join(map(str, mesh.dims))} = dp, fsdp, tp, sp)")
                w = p.shape[pl.shard] // n
                p.data = p.data.narrow(pl.shard, mesh.shard_rank * w, w).contiguous().clone()
            got[name] = pl
    model.placements = got
    for name, mod in model.named_modules():
        entries = None
        if name.startswith("h.") and name.count(".") == 1:   # a block: its dense weights
            entries = [(sub, got[f"{name}.{sub}.weight"].shard) for sub, _ in mod.named_modules()
                       if f"{name}.{sub}.weight" in got and got[f"{name}.{sub}.weight"].over_shard]
        elif name in _SELF_GATHERED and got[f"{name}.weight"].over_shard:
            entries = [("", got[f"{name}.weight"].shard)]
        mod.__dict__["_gather"] = (mesh, entries) if entries else None
    return model


def gather_weights(module):
    """{submodule path: its whole weight} of a sharded block, gathered over
    the shard group in one collective (`GatherShards`); None when the
    module holds nothing sharded."""
    spec = module.__dict__.get("_gather")
    if spec is None:
        return None
    mesh, entries = spec
    shards = [module.get_submodule(path).weight for path, _ in entries]
    whole = GatherShards.apply(mesh, tuple(d for _, d in entries), *shards)
    return {path: w for (path, _), w in zip(entries, whole)}


def full_weight(module):
    """`module.weight` whole over the shard group: gathered when the module
    holds a shard of it (the embeddings and the heads), else itself."""
    got = gather_weights(module)
    return module.weight if got is None else got[""]
