"""The device mesh: the counterpart of `lwm_tpu/parallel/mesh.py`.

`--mesh_dim` keeps the JAX grammar (`parse_mesh_dims`): four comma-separated
sizes of the axes (dp, fsdp, tp, sp), at most one of them -1 (inferred from
the number of ranks), with an optional leading `!`. JAX reads `!` as "take
the devices in raw enumeration order instead of `mesh_utils`' physical
layout"; here ranks are always laid out in raw order (rank r holds the mesh
coordinate of r in row-major (dp, fsdp, tp, sp) order), so `!` changes
nothing. One rank drives one card (or the CPU), so a mesh of n devices is a
job of n processes, started by `torchrun`.

What the port runs on a mesh:
- training on dp (each dp group takes its rows of the batch) and sp (each sp
  rank its slice of the sequence, attention by `ops.ring.ring_attention`;
  gradients summed over every rank). fsdp or tp > 1 in training raises in
  `train.check_mesh` (FSDP2 comes with ROADMAP A4.1);
- inference on all four axes: the batch (the server's slots, generate's rows)
  split over dp × fsdp, the weights split over tp (`parallel.partition`) and
  replicated over dp × fsdp × sp, and the KV cache split over tp (its heads)
  and sp (its sequence: `ops.ring.ring_attention_inference`).

Beside the per-axis groups of the torch `DeviceMesh`, a mesh holds two
groups of its own: "batch" (the dp × fsdp ranks that share a tp and sp
coordinate) and "model" (the tp × sp ranks that share a batch shard, which
compute the same rows). Its collectives (`all_reduce`, `all_gather`,
`broadcast`) run over a named group; under gloo, which takes CPU tensors
only, card tensors are staged through host memory (two ranks sharing one
card), as the backend decides and never as a fallback.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist

MESH_AXES = ("dp", "fsdp", "tp", "sp")
SP_LAYOUTS = ("contiguous", "striped")


def parse_mesh_dims(mesh_dim: str, n_devices: int, n_axes: int = 4):
    """The mesh_dim grammar → (dims, strict_order): the sizes with a -1
    inferred from `n_devices`, and whether a leading '!' was given
    (`lwm_tpu/parallel/mesh.py:30-58`, the same errors)."""
    s = mesh_dim.strip()
    strict_order = s.startswith("!")
    if strict_order:
        s = s[1:]
    dims = [int(x) for x in s.split(",")]
    if len(dims) != n_axes:
        raise ValueError(f"mesh_dim {mesh_dim!r} has {len(dims)} entries, expected {n_axes}")
    if sum(d == -1 for d in dims) > 1:
        raise ValueError(f"mesh_dim {mesh_dim!r} has more than one -1 entry")
    if -1 in dims:
        known = math.prod(d for d in dims if d != -1)
        if n_devices % known != 0:
            raise ValueError(
                f"cannot infer -1 in {mesh_dim!r}: {n_devices} devices not divisible by {known}"
            )
        dims[dims.index(-1)] = n_devices // known
    if math.prod(dims) != n_devices:
        raise ValueError(f"mesh_dim {mesh_dim!r} = {dims} does not cover {n_devices} devices")
    return dims, strict_order


def initialize_distributed(config=None, device="cuda", backend=None):
    """Join the job's process group, as `jax.distributed.initialize` joins
    JAX's (`lwm_tpu/parallel/mesh.py:123-137`): when `config`'s
    `initialize_jax_distributed` is set (the trainer's
    `--jax_distributed.*` flags: `coordinator_address` host:port,
    `num_processes`, `process_id`, each from torchrun's environment when
    unset) or when torchrun's WORLD_SIZE is above 1. The backend is NCCL
    for the card and gloo for the CPU unless `backend` names one (gloo on
    the card: two ranks sharing one card, which NCCL refuses). On the card
    the process drives `local_device_ids`' first card, else LOCAL_RANK's
    (modulo the cards it sees). Returns the world size (1 without a group)."""
    config = dict(config or {})
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if dist.is_initialized():
        return dist.get_world_size()
    if not config.get("initialize_jax_distributed") and env_world <= 1:
        return 1
    device = torch.device(device)
    if device.type == "cuda":
        ids = config.get("local_device_ids")
        local = int(ids.split(",")[0]) if ids else int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local % torch.cuda.device_count())
    address = config.get("coordinator_address")
    world = config.get("num_processes")
    rank = config.get("process_id")
    dist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method=f"tcp://{address}" if address else "env://",
        world_size=env_world if world is None else int(world),
        rank=int(os.environ.get("RANK", "0")) if rank is None else int(rank),
    )
    return dist.get_world_size()


# the mesh's own groups → the axes they span
GROUP_AXES = {"batch": ("dp", "fsdp"), "model": ("tp", "sp")}
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, fsdp, tp, sp) mesh over the job's ranks and the sequence's
    layout over sp: "contiguous" (sp rank i holds positions [i·s, (i+1)·s)
    of a sequence of sp·s) or "striped" (positions i, i + sp, i + 2·sp, …;
    `ops.striped`). `device_mesh` is the torch DeviceMesh, None on one rank;
    `groups` this rank's "batch" and "model" process groups."""

    dims: tuple
    device_mesh: object = None
    layout: str = "contiguous"
    groups: dict = dataclasses.field(default_factory=dict, compare=False)

    @property
    def shape(self):
        return dict(zip(MESH_AXES, self.dims))

    @property
    def size(self):
        return math.prod(self.dims)

    @property
    def dp(self):
        return self.shape["dp"]

    @property
    def fsdp(self):
        return self.shape["fsdp"]

    @property
    def tp(self):
        return self.shape["tp"]

    @property
    def sp(self):
        return self.shape["sp"]

    @property
    def batch(self):
        """Batch shards: dp × fsdp."""
        return self.dp * self.fsdp

    def axis_size(self, axis=None):
        """The ranks of `axis` (a mesh axis, "batch", "model", or None: all)."""
        if axis is None:
            return self.size
        return math.prod(self.shape[a] for a in GROUP_AXES.get(axis, (axis,)))

    def _local_rank(self, axis):
        return 0 if self.device_mesh is None else self.device_mesh.get_local_rank(axis)

    @property
    def dp_rank(self):
        return self._local_rank("dp")

    @property
    def tp_rank(self):
        return self._local_rank("tp")

    @property
    def sp_rank(self):
        return self._local_rank("sp")

    @property
    def batch_rank(self):
        """This rank's batch shard: dp_rank · fsdp + fsdp_rank."""
        return self.dp_rank * self.fsdp + self._local_rank("fsdp")

    def rank_of(self, dp=0, fsdp=0, tp=0, sp=0):
        """The global rank at a mesh coordinate (ranks in row-major order)."""
        rank = 0
        for size, i in zip(self.dims, (dp, fsdp, tp, sp)):
            rank = rank * size + i
        return rank

    def group(self, axis=None):
        """The process group of `axis` (a mesh axis, "batch" or "model"), or
        of every rank; None on one rank."""
        if self.device_mesh is None:
            return None
        if axis is None:
            return dist.group.WORLD
        if axis in GROUP_AXES:
            return self.groups[axis]
        return self.device_mesh.get_group(axis)

    @staticmethod
    def _on_host(group, x):
        return x.device.type != "cpu" and dist.get_backend(group) == "gloo"

    def all_reduce(self, x, axis=None, op="sum"):
        """x reduced ("sum" or "max") over the ranks of `axis`; a new tensor
        on x's device (x itself when the axis has one rank)."""
        if self.axis_size(axis) == 1:
            return x
        group = self.group(axis)
        y = (x.cpu() if self._on_host(group, x) else x.clone()).contiguous()
        dist.all_reduce(y, op=_OPS[op], group=group)
        return y.to(x.device)

    def all_gather(self, x, axis=None, dim=0):
        """The ranks' x of `axis`, concatenated along `dim` in rank order."""
        n = self.axis_size(axis)
        if n == 1:
            return x
        group = self.group(axis)
        y = (x.cpu() if self._on_host(group, x) else x).contiguous()
        parts = [torch.empty_like(y) for _ in range(n)]
        dist.all_gather(parts, y, group=group)
        return torch.cat(parts, dim).to(x.device)

    def broadcast(self, x, axis=None, src=0):
        """The x of the rank at index `src` of `axis`'s group, on every rank
        of the group (a new tensor on x's device)."""
        if self.axis_size(axis) == 1:
            return x
        group = self.group(axis)
        y = (x.cpu() if self._on_host(group, x) else x.clone()).contiguous()
        dist.broadcast(y, src=dist.get_global_rank(group, src), group=group)
        return y.to(x.device)

    def gather_sequence(self, x):
        """This rank's [b, s_local, ...] slice → the sp group's [b, sp·s_local,
        ...] in slot order."""
        return self.all_gather(x, "sp", 1)

    @property
    def is_rank0(self):
        return not dist.is_initialized() or dist.get_rank() == 0


def mesh_of(model):
    """`model.mesh` when it spans more than one rank, else None."""
    mesh = getattr(model, "mesh", None)
    return mesh if mesh is not None and mesh.size > 1 else None


def create_mesh(mesh_dim, device="cuda", layout="contiguous"):
    """The mesh of `mesh_dim` over the job's ranks (`initialize_distributed`
    first when there are several), on `torch.distributed.device_mesh.
    init_device_mesh` over the axes (dp, fsdp, tp, sp) in that order, with
    its "batch" and "model" groups. A `mesh_dim` the job's ranks do not cover
    raises ValueError (a mesh of n devices runs as n processes: `torchrun`)."""
    if layout not in SP_LAYOUTS:
        raise ValueError(f"sp layout {layout!r}: use one of {SP_LAYOUTS}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    dims, _ = parse_mesh_dims(mesh_dim, world)
    if world == 1:
        return Mesh(tuple(dims), None, layout)
    from torch.distributed.device_mesh import init_device_mesh

    device_mesh = init_device_mesh(torch.device(device).type, tuple(dims),
                                   mesh_dim_names=MESH_AXES)
    mesh = Mesh(tuple(dims), device_mesh, layout)
    grid = torch.arange(world).reshape(dims)
    for name, axes in GROUP_AXES.items():
        inner = [MESH_AXES.index(a) for a in axes]
        outer = [i for i in range(4) if i not in inner]
        rows = grid.permute(outer + inner).reshape(-1, math.prod(dims[i] for i in inner))
        for ranks in rows.tolist():   # every rank makes every group, in one order
            group = dist.new_group(ranks)
            if dist.get_rank() in ranks:
                mesh.groups[name] = group
    return mesh


def get_ranks_and_size(mesh):
    """What this rank's loader reads and keeps (`lwm_tpu/parallel/mesh.py:
    74-93` is the JAX host's): every rank reads the whole global batch, as
    JAX's one host does, so the loader's line sharding is one node of one
    (`dp_node_size` 1, `mp_node_size` 1); the rank keeps its dp rows and
    sp columns (`data.text.shard_batch`): `dp_size`/`dp_rank`, `sp_size`/
    `sp_rank` and the `sp_layout`."""
    return dict(shard_on_batch=False, dp_node_size=1, dp_node_rank=0, mp_node_size=1,
                mp_node_rank=0, dp_size=mesh.dp, dp_rank=mesh.dp_rank, sp_size=mesh.sp,
                sp_rank=mesh.sp_rank, sp_layout=mesh.layout)
