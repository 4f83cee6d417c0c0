"""The device mesh: the counterpart of `lwm_tpu/parallel/mesh.py`.

`--mesh_dim` keeps the JAX grammar (`parse_mesh_dims`): four comma-separated
sizes of the axes (dp, fsdp, tp, sp), at most one of them -1 (inferred from
the number of ranks), with an optional leading `!`. JAX reads `!` as "take
the devices in raw enumeration order instead of `mesh_utils`' physical
layout"; here ranks are always laid out in raw order (rank r holds the mesh
coordinate of r in row-major (dp, fsdp, tp, sp) order), so `!` changes
nothing. One rank drives one card (or the CPU), so a mesh of n devices is a
job of n processes, started by `torchrun`.

What the port runs on a mesh: dp (each dp group takes its rows of the
batch) and sp (each sp rank its slice of the sequence, attention by
`ops.ring.ring_attention`; gradients summed over every rank). fsdp and tp
> 1 raise: the partition rules (`lwm_tpu/parallel/partition.py`) come with
a later multi-GPU slice (ROADMAP A4).
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


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, fsdp, tp, sp) mesh over the job's ranks and the sequence's
    layout over sp: "contiguous" (sp rank i holds positions [i·s, (i+1)·s)
    of a sequence of sp·s) or "striped" (positions i, i + sp, i + 2·sp, …;
    `ops.striped`). `device_mesh` is the torch DeviceMesh, None on one rank."""

    dims: tuple
    device_mesh: object = None
    layout: str = "contiguous"

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
    def sp(self):
        return self.shape["sp"]

    def _local_rank(self, axis):
        return 0 if self.device_mesh is None else self.device_mesh.get_local_rank(axis)

    @property
    def dp_rank(self):
        return self._local_rank("dp")

    @property
    def sp_rank(self):
        return self._local_rank("sp")

    def group(self, axis=None):
        """The process group of `axis` ("dp" or "sp"), or of every rank."""
        if self.device_mesh is None:
            return None
        return dist.group.WORLD if axis is None else self.device_mesh.get_group(axis)

    def gather_sequence(self, x):
        """This rank's [b, s_local, ...] slice → the sp group's [b, sp·s_local,
        ...] in slot order (under gloo, which gathers CPU tensors only,
        staged through host memory)."""
        group = self.group("sp")
        host = dist.get_backend(group) == "gloo"
        y = (x.cpu() if host else x).contiguous()
        parts = [torch.empty_like(y) for _ in range(self.sp)]
        dist.all_gather(parts, y, group=group)
        return torch.cat(parts, 1).to(x.device)

    @property
    def is_rank0(self):
        return not dist.is_initialized() or dist.get_rank() == 0


def create_mesh(mesh_dim, device="cuda", layout="contiguous"):
    """The mesh of `mesh_dim` over the job's ranks (`initialize_distributed`
    first when there are several), on `torch.distributed.device_mesh.
    init_device_mesh` over the axes (dp, fsdp, tp, sp) in that order."""
    if layout not in SP_LAYOUTS:
        raise ValueError(f"sp layout {layout!r}: use one of {SP_LAYOUTS}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    dims, _ = parse_mesh_dims(mesh_dim, world)
    shape = dict(zip(MESH_AXES, dims))
    for axis in ("fsdp", "tp"):
        if shape[axis] > 1:
            raise NotImplementedError(
                f"mesh_dim {mesh_dim!r}: {axis} = {shape[axis]} needs the partition rules, which "
                "come with a later multi-GPU slice (ROADMAP A4); the port trains on dp and sp")
    if world == 1:
        return Mesh(tuple(dims), None, layout)
    from torch.distributed.device_mesh import init_device_mesh

    device_mesh = init_device_mesh(torch.device(device).type, tuple(dims),
                                   mesh_dim_names=MESH_AXES)
    return Mesh(tuple(dims), device_mesh, layout)


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
