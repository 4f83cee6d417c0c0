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
- training on all four axes: the batch's rows split over dp × fsdp, the
  sequence over sp (attention by `ops.ring.ring_attention`), the weights
  and the optimizer's moments split over tp and over the shard group
  (fsdp × sp) by the partition rules (`parallel.partition`,
  `parallel.fsdp`), tensor-parallel blocks through `TPEntry`/`TPExit`;
- inference on all four axes: the batch (the server's slots, generate's rows)
  split over dp × fsdp, the weights split over tp (`parallel.partition`) and
  replicated over dp × fsdp × sp, and the KV cache split over tp (its heads)
  and sp (its sequence: `ops.ring.ring_attention_inference`).

Beside the per-axis groups of the torch `DeviceMesh`, a mesh holds groups
of its own: "batch" (the dp × fsdp ranks that share a tp and sp
coordinate), "model" (the tp × sp ranks that share a batch shard, which
compute the same rows) and "shard" (the fsdp × sp ranks that share a dp
and a tp coordinate: the rule table's ("fsdp", "sp"), over which a
weight's shards are gathered). Its collectives (`all_reduce`, `all_gather`,
`reduce_scatter`, `broadcast`) run over a named group; under gloo, which
takes CPU tensors only, card tensors are staged through host memory (two
ranks sharing one card), as the backend decides and never as a fallback.
The differentiable ones (`TPEntry`, `TPExit`, `GatherLast`,
`GatherShards`) are autograd Functions over them.
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
GROUP_AXES = {"batch": ("dp", "fsdp"), "model": ("tp", "sp"), "shard": ("fsdp", "sp")}
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

    @property
    def shard(self):
        """The weights' shard group's ranks: fsdp × sp."""
        return self.fsdp * self.sp

    @property
    def shard_rank(self):
        """This rank's index in the shard group: fsdp_rank · sp + sp_rank
        (a leaf's ("fsdp", "sp") dim is split in this order, as JAX's)."""
        return self._local_rank("fsdp") * self.sp + self.sp_rank

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

    @staticmethod
    def _ring(group):
        """(this rank's index, n, the next rank, the previous rank) of the
        ring over `group`'s ranks. Under gloo the gathers and reduce-scatters
        run as rings of point-to-point sends on the host, which move host
        memory faster than gloo's own all-gather, reduce-scatter or
        all-reduce do (PERF.md §5)."""
        ranks = dist.get_process_group_ranks(group)
        i, n = ranks.index(dist.get_rank()), len(ranks)
        return i, n, ranks[(i + 1) % n], ranks[(i - 1) % n]

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
        if dist.get_backend(group) == "gloo" and x.dtype != torch.bool:   # sends on the host
            i, n, nxt, prv = self._ring(group)
            whole = torch.empty((n, *x.shape), dtype=x.dtype)
            whole[i] = x
            for step in range(n - 1):   # pass on the part received the step before
                _exchange(whole[(i - step) % n], nxt, whole[(i - step - 1) % n], prv, group)
            out = (whole.view(-1, *x.shape[1:]) if x.dim() and dim % x.dim() == 0
                   else torch.cat(whole.unbind(0), dim))
            return out.to(x.device)
        y = (x.cpu() if self._on_host(group, x) else x).contiguous()
        parts = [torch.empty_like(y) for _ in range(n)]
        dist.all_gather(parts, y, group=group)
        return torch.cat(parts, dim).to(x.device)

    def reduce_scatter(self, x, axis=None):
        """x [n·m, ...] summed over the n ranks of `axis`; this rank keeps
        rows [i·m, (i + 1)·m) of the sum, i its index in the group."""
        n = self.axis_size(axis)
        if n == 1:
            return x
        group = self.group(axis)
        m = x.shape[0] // n
        if dist.get_backend(group) == "gloo":   # a ring of sends on the host (`_ring`)
            i, n, nxt, prv = self._ring(group)
            parts = x.to("cpu", copy=True).contiguous().view(n, -1)
            got = torch.empty_like(parts[0])
            for step in range(n - 1):   # add the partial sum received to this rank's own
                _exchange(parts[(i - step - 1) % n], nxt, got, prv, group)
                parts[(i - step - 2) % n] += got
            return parts[i].view(m, *x.shape[1:]).to(x.device)
        y = x.contiguous()
        out = y.new_empty((m, *y.shape[1:]))
        dist.reduce_scatter_tensor(out, y, group=group)
        return out

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


def _exchange(send, to, recv, frm, group):
    """Send `send` to global rank `to` while receiving `recv` from `frm`."""
    ops = [dist.P2POp(dist.isend, send, to, group), dist.P2POp(dist.irecv, recv, frm, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()


class TPEntry(torch.autograd.Function):
    """A tensor-parallel block's input: the identity forward; the backward
    sums the ranks' partial gradients over tp (each rank's heads or
    features see all of x)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.float(), "tp").to(g.dtype), None


class TPExit(torch.autograd.Function):
    """A tensor-parallel block's output: the ranks' partial products summed
    over tp in fp32; the backward passes the gradient through (every rank
    holds the whole sum's gradient)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x.float(), "tp").to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class GatherLast(torch.autograd.Function):
    """The ranks' slices along `dim` gathered over `axis` (the vocab-split
    logits or head over tp); the backward keeps this rank's slice of the
    gradient (every rank computes the same function of the whole)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.n = mesh, axis, dim, x.shape[dim]
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        rank = ctx.mesh.tp_rank if ctx.axis == "tp" else ctx.mesh.shard_rank
        return g.narrow(ctx.dim, rank * ctx.n, ctx.n).contiguous(), None, None, None


def tp_enter(x, mesh):
    """`TPEntry` on a tp mesh, else x."""
    return x if mesh is None or mesh.tp == 1 else TPEntry.apply(x, mesh)


def tp_exit(x, mesh):
    """`TPExit` on a tp mesh, else x."""
    return x if mesh is None or mesh.tp == 1 else TPExit.apply(x, mesh)


def gather_tp(x, mesh, dim=-1):
    """`GatherLast` over tp along `dim` on a tp mesh, else x."""
    if mesh is None or mesh.tp == 1:
        return x
    return GatherLast.apply(x, mesh, "tp", dim % x.dim())


class GatherShards(torch.autograd.Function):
    """Whole (tp-local) weights from this rank's shards, gathered over the
    shard group in one flat all-gather: `shards` are this rank's slices,
    each of its leaf's dim `dims[i]`. The backward reduce-scatters the
    whole weights' gradients (a sum over the shard group) in one flat
    collective, so each shard's gradient is the shard group's."""

    @staticmethod
    def forward(ctx, mesh, dims, *shards):
        ctx.mesh, ctx.dims = mesh, dims
        ctx.shapes = [s.shape for s in shards]
        ctx.like = dict(dtype=shards[0].dtype, device=shards[0].device)
        n = mesh.shard
        flat = torch.cat([s.reshape(-1) for s in shards])
        whole = mesh.all_gather(flat[None], "shard", 0)   # [n, Σ numel]
        out, at = [], 0
        for s, dim in zip(shards, dims):
            part = whole[:, at:at + s.numel()].reshape(n, *s.shape)
            at += s.numel()
            out.append(torch.cat(part.unbind(0), dim) if dim else part.reshape(-1, *s.shape[1:]))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        n = ctx.mesh.shard
        parts = []
        for g, shape, dim in zip(grads, ctx.shapes, ctx.dims):
            if g is None:   # a weight this forward did not use
                parts.append(torch.zeros((n, math.prod(shape)), **ctx.like))
            else:
                parts.append(torch.stack(g.chunk(n, dim)).reshape(n, -1))
        summed = ctx.mesh.reduce_scatter(torch.cat(parts, 1), "shard")[0]   # this rank's row
        out, at = [], 0
        for shape in ctx.shapes:
            k = math.prod(shape)
            out.append(summed[at:at + k].view(shape))
            at += k
        return (None, None, *out)


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
    (`dp_node_size` 1, `mp_node_size` 1); the rank keeps its rows of the
    batch, split over dp × fsdp as JAX's `PS(("dp", "fsdp"), "sp")`, and
    its sp columns (`data.text.shard_batch`): `dp_size`/`dp_rank` (the
    batch shards and this rank's), `sp_size`/`sp_rank` and the
    `sp_layout`."""
    return dict(shard_on_batch=False, dp_node_size=1, dp_node_rank=0, mp_node_size=1,
                mp_node_rank=0, dp_size=mesh.batch, dp_rank=mesh.batch_rank, sp_size=mesh.sp,
                sp_rank=mesh.sp_rank, sp_layout=mesh.layout)
