"""Training attention with hand-written backwards: the single-device
`flash_attention` (the counterpart of `lwm_tpu/ops/ring.py:473-537`, the
mesh-less branch of the JAX model's `_ring_train`, `llama.py:708-733`) and
the sequence-parallel `ring_attention` (`lwm_tpu/ops/ring.py:191-465`); and
inference over a KV cache split across sp, `ring_attention_inference`
(`lwm_tpu/ops/ring.py:545-640`, at the end of this module).

`FlashAttention` is a `torch.autograd.Function`. Its forward runs K1
(`ops.flash.flash_attention_fwd`, seq-major kv) through the custom op
`lwm_tpu_torch::flash_fwd` and saves only (q, k, v, out, lse), as the JAX
custom VJP does. Its backward computes delta = Σ_d g·out in fp32 from the
rounded `out` (`ring.py:517-525`, `_chunked_delta` `:191-224`) in plain
torch, as JAX does outside any kernel, then one launch of the fused
backward kernel (`ops.flash.flash_attention_bwd`: dq, dk and dv together);
dk/dv come back at h_kv heads. The bias is not differentiated; segment ids
keep a logit only where the query's and the key's are equal. On CPU tensors
every wrapper runs its plain twin.

`RingAttention` is the same over the sp ranks of a mesh, each holding its
slice of the sequence (contiguous, or striped: `ops.striped`). Forward
(`_ring_attention_fwd` `:334-393`): sp steps; at step t the rank attends
over the kv block of rank (my − t) mod sp with K1 at that block's global
positions (`q_offset`, `kv_offset`, `pos_stride`), its slice of the segment
ids and of the per-key bias, while the block it holds goes on to rank my +
1 (the exchange is posted before the step's compute, as JAX's ppermute);
the contiguous layout's fully masked steps (a block after the rank's own)
are skipped; the blocks' (out, lse) merge by log-sum-exp. Backward
(`:395-465`): delta from the merged out, then the same sp steps, each one
launch of the fused backward with the global lse; dk and dv ride the ring
in fp32 with their block (each step's bf16 share summed in fp32) and are
home after sp hops. The exchange is point to point
(`torch.distributed.batch_isend_irecv`); gloo sends and receives CPU
tensors only, so under a gloo group the blocks are staged through host
memory (the backend decides, never as a fallback); under NCCL they go card
to card.

Both forwards are custom ops (`lwm_tpu_torch::flash_fwd`,
`lwm_tpu_torch::ring_fwd`) so that selective activation checkpointing can
keep their outputs: `save_flash_policy` marks them MUST_SAVE and everything
else PREFER_RECOMPUTE, which is JAX's `save_only_these_names("flash_out",
"flash_lse")` (`llama.py:1370-1376`, `ring.py:386-389`): a rematerialized
block replays its norms, projections, RoPE and MLP in the backward, but not
the attention, nor the ring's exchange.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.distributed_c10d import _resolve_process_group
from torch.utils.checkpoint import CheckpointPolicy

from lwm_tpu_torch.ops import flash
from lwm_tpu_torch.ops.decode import flash_decode
from lwm_tpu_torch.ops.reference import BIG_NEG, MASK_GUARD


@torch.library.custom_op("lwm_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: Optional[torch.Tensor],
    q_seg: Optional[torch.Tensor], kv_seg: Optional[torch.Tensor], causal: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 over seq-major kv: (out in q.dtype, lse [b, h, sq] fp32)."""
    return flash.flash_attention_fwd(q, k, v, bias, causal=causal, q_seg=q_seg, kv_seg=kv_seg)


@flash_fwd_op.register_fake
def _(q, k, v, bias, q_seg, kv_seg, causal):
    b, sq, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, sq), dtype=torch.float32)


def save_flash_policy(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of `remat_block="save_flash"`."""
    if op in (torch.ops.lwm_tpu_torch.flash_fwd.default, torch.ops.lwm_tpu_torch.ring_fwd.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _delta(g, out):
    """delta [b, h, sq] = Σ_d g·out in fp32."""
    return torch.einsum("bqhd,bqhd->bhq", g.float(), out.float()).contiguous()


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, segment_ids, causal):
        out, lse = flash_fwd_op(q, k, v, bias, segment_ids, segment_ids, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, bias, segment_ids, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, segs, out, lse = ctx.saved_tensors
        dq, dk, dv = flash.flash_attention_bwd(
            q, k, v, g.to(q.dtype).contiguous(), lse, _delta(g, out), bias, causal=ctx.causal,
            q_seg=segs, kv_seg=segs,
        )
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, bias=None, segment_ids=None, *, causal=True):
    """q [b, s, h, d]; k, v [b, s_kv, h_kv, d] (seq-major); bias additive,
    broadcastable as [b|1, 1, s|1, s_kv]; segment_ids [b, s] int (s_kv = s)
    or None. Returns out [b, s, h, d] in q.dtype, differentiable in q, k and
    v."""
    return FlashAttention.apply(q, k, v, bias, segment_ids, causal)


# ------------------------------------------------------------------ the ring


class RingExchange:
    """The ring's point-to-point exchange over an sp process group: send
    tensors to the next rank, receive the previous rank's, both posted
    together (`torch.distributed.batch_isend_irecv`). Under gloo, whose send
    and recv take CPU tensors only, card tensors are staged through host
    memory."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.next = dist.get_global_rank(group, (self.rank + 1) % self.size)
        self.prev = dist.get_global_rank(group, (self.rank - 1) % self.size)
        self.host = dist.get_backend(group) == "gloo"

    def start(self, tensors, tag=0):
        """Post the sends of `tensors` and the receives of the previous
        rank's, returned by `finish`. Tags from `tag` on tell apart exchanges
        in flight together."""
        device = tensors[0].device
        sends = [(x.cpu() if self.host else x).contiguous() for x in tensors]
        recvs = [torch.empty_like(x) for x in sends]
        ops = [dist.P2POp(dist.isend, x, self.next, self.group, tag + i)
               for i, x in enumerate(sends)]
        ops += [dist.P2POp(dist.irecv, x, self.prev, self.group, tag + i)
                for i, x in enumerate(recvs)]
        return dist.batch_isend_irecv(ops), recvs, device

    @staticmethod
    def finish(pending):
        works, recvs, device = pending
        for work in works:
            work.wait()
        return [x.to(device) for x in recvs]


def _combine(carry, out_t, lse_t):
    """Fold one block's (out, lse) into the running (num, m, denom)
    (`_combine_partials`, `lwm_tpu/ops/ring.py:227-240`)."""
    num, m_run, denom = carry
    m_new = torch.maximum(m_run, lse_t)
    c_old = torch.where(m_run > MASK_GUARD, torch.exp(m_run - m_new), 0.0)
    c_new = torch.where(lse_t > MASK_GUARD, torch.exp(lse_t - m_new), 0.0)
    num = num * c_old.transpose(1, 2)[..., None] + out_t.float() * c_new.transpose(1, 2)[..., None]
    return num, m_new, denom * c_old + c_new


def _finalize(num, m_run, denom):
    """(`_finalize_partials`, `:242-251`): rows with no visible key give
    out 0 and lse BIG_NEG."""
    d_t = denom.transpose(1, 2)[..., None]
    out = torch.where(d_t > 0.0, num / d_t.clamp_min(1e-30), 0.0)
    lse = torch.where(denom > 0.0, m_run + torch.log(denom.clamp_min(1e-30)), BIG_NEG)
    return out, lse


class _RingSteps:
    """The ring's steps as one rank sees them: its global positions, and
    each step's source rank, kv offset, bias and segment slices."""

    def __init__(self, exchange, sq, skv, striped, bias, segment_ids):
        self.exchange = exchange
        sp, my = exchange.size, exchange.rank
        self.sp, self.my, self.skv, self.striped = sp, my, skv, striped
        self.pos_stride = sp if striped else 1
        self.q_offset = my if striped else my * sq
        self.bias, self.segs = bias, segment_ids
        self.q_seg = None if segment_ids is None else segment_ids[:, my * sq:(my + 1) * sq]

    def step(self, t):
        """The kernel wrappers' kwargs at step t, whose block comes from rank
        (my − t) mod sp, or None when that block is wholly masked (the
        contiguous layout's blocks after the rank's own, `:375-381`)."""
        src = (self.my - t) % self.sp
        kv_offset = src if self.striped else src * self.skv
        if not self.striped and kv_offset > self.q_offset + (self.skv - 1):
            return None
        sl = slice(src * self.skv, (src + 1) * self.skv)
        return dict(
            bias=None if self.bias is None else self.bias[..., sl],
            causal=True, q_offset=self.q_offset, kv_offset=kv_offset, pos_stride=self.pos_stride,
            q_seg=self.q_seg, kv_seg=None if self.segs is None else self.segs[:, sl],
        )


def _ring_forward(q, k, v, bias, segment_ids, group, striped):
    b, sq, h, d = q.shape
    steps = _RingSteps(RingExchange(group), sq, k.shape[1], striped, bias, segment_ids)
    carry = (torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device),
             torch.full((b, h, sq), BIG_NEG, dtype=torch.float32, device=q.device),
             torch.zeros((b, h, sq), dtype=torch.float32, device=q.device))
    kv = (k, v)
    for t in range(steps.sp):
        # the next block is posted before this step's compute
        pending = steps.exchange.start(kv) if t + 1 < steps.sp else None
        kw = steps.step(t)
        if kw is not None:
            bias_t = kw.pop("bias")
            out_t, lse_t = flash.flash_attention_fwd(q, *kv, bias_t, **kw)
            carry = _combine(carry, out_t, lse_t)
        if pending is not None:
            kv = tuple(RingExchange.finish(pending))
    out, lse = _finalize(*carry)
    return out.to(q.dtype), lse


@torch.library.custom_op("lwm_tpu_torch::ring_fwd", mutates_args=())
def ring_fwd_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: Optional[torch.Tensor],
    segment_ids: Optional[torch.Tensor], group_name: str, striped: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The ring's forward over the process group named `group_name`: (out
    in q.dtype, lse [b, h, sq] fp32)."""
    return _ring_forward(q, k, v, bias, segment_ids, _resolve_process_group(group_name), striped)


@ring_fwd_op.register_fake
def _(q, k, v, bias, segment_ids, group_name, striped):
    b, sq, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, sq), dtype=torch.float32)


class RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, segment_ids, group, striped):
        out, lse = ring_fwd_op(q, k, v, bias, segment_ids, group.group_name, striped)
        ctx.group, ctx.striped = group, striped
        ctx.save_for_backward(q, k, v, bias, segment_ids, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, segs, out, lse = ctx.saved_tensors
        steps = _RingSteps(RingExchange(ctx.group), q.shape[1], k.shape[1], ctx.striped, bias,
                           segs)
        g = g.to(q.dtype).contiguous()
        delta = _delta(g, out)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkv = tuple(torch.zeros(x.shape, dtype=torch.float32, device=x.device) for x in (k, v))
        kv = (k, v)
        for t in range(steps.sp):
            pending = steps.exchange.start(kv) if t + 1 < steps.sp else None
            kw = steps.step(t)
            if kw is not None:
                bias_t = kw.pop("bias")
                ddq, ddk, ddv = flash.flash_attention_bwd(q, *kv, g, lse, delta, bias_t, **kw)
                dq += ddq.float()
                dkv = (dkv[0] + ddk.float(), dkv[1] + ddv.float())
            # dk and dv travel with their block: after sp hops they are home
            dkv = tuple(RingExchange.finish(steps.exchange.start(dkv, tag=2)))
            if pending is not None:
                kv = tuple(RingExchange.finish(pending))
        return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype), None, None, None, None


def ring_attention(q, k, v, bias=None, segment_ids=None, *, group, layout="contiguous"):
    """Causal attention over a sequence split across the ranks of the sp
    process group `group`: q [b, s_local, h, d], k, v [b, s_local, h_kv, d],
    this rank's slice (`layout` "contiguous" or "striped"); bias a per-key
    additive bias [b|1, 1, 1, sp·s_local] and segment_ids [b, sp·s_local]
    (int) over the whole sequence in slot order, or None. Returns out
    [b, s_local, h, d] in q.dtype, differentiable in q, k and v (`ring.py:
    254-330`: the JAX ring with per-key bias, token-level causal)."""
    if layout not in ("contiguous", "striped"):
        raise ValueError(f"sp layout {layout!r}: use 'contiguous' or 'striped'")
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"ring blocks must match: q {tuple(q.shape)}, k {tuple(k.shape)}")
    seq = q.shape[1] * dist.get_world_size(group)
    if bias is not None and (bias.ndim != 4 or bias.shape[1:3] != (1, 1) or bias.shape[3] != seq):
        raise ValueError(f"ring bias must be per key, [b|1, 1, 1, {seq}]: got {tuple(bias.shape)}")
    if segment_ids is not None and tuple(segment_ids.shape) != (q.shape[0], seq):
        raise ValueError(f"segment ids {tuple(segment_ids.shape)}: want [{q.shape[0]}, {seq}]")
    if segment_ids is not None:
        segment_ids = segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
    return RingAttention.apply(q, k, v, bias, segment_ids, group, layout == "striped")


# ------------------------------------------------------- inference over sp


def merge_partials(o, m, l, mesh, axis="sp"):
    """Flash partials of the ranks of `axis` merged into the whole range's
    (`lwm_tpu/ops/ring.py:621-632`): the max of m, then the sums of the
    corrected l and o. Raw-accumulator convention (o = Σ e^{s−m}·v, l =
    Σ e^{s−m}): o [b, sq, h, d], m and l [b, h, sq], fp32. A rank whose range
    holds no valid key (m at BIG_NEG) contributes nothing. Returns the
    merged (o, m, l) on every rank of `axis`: one max and one sum."""
    m_glob = mesh.all_reduce(m, axis, "max")
    c = torch.where(m > MASK_GUARD, torch.exp(m - m_glob), 0.0)
    ct = c.transpose(1, 2)[..., None]
    o = torch.where(ct > 0, o, 0.0) * ct
    b, sq, h, d = o.shape
    packed = mesh.all_reduce(torch.cat([o.reshape(b, -1), (l * c).reshape(b, -1)], 1), axis)
    return (packed[:, :sq * h * d].reshape(b, sq, h, d), m_glob,
            packed[:, sq * h * d:].reshape(b, h, sq))


def finalize_partials(o, l, dtype):
    """Raw partials → the normalized output in `dtype`; 0 where no key was
    valid."""
    lt = l.transpose(1, 2)[..., None]
    return torch.where(lt > 0, o / lt.clamp_min(1e-30), 0.0).to(dtype)


def lse_partials(out, lse):
    """K1's normalized (out, lse) as raw partials (o, m, l)."""
    l = (lse > MASK_GUARD).float()
    return out.float() * l.transpose(1, 2)[..., None], lse, l


def local_kv_len(mask):
    """Each row's bound on the valid keys of a per-key mask [b, T]: one past
    its last valid key, int32 [b] on the mask's device (computed there: no
    host read)."""
    pos = torch.arange(1, mask.shape[-1] + 1, device=mask.device, dtype=torch.int32)
    return torch.where(mask, pos, 0).amax(-1).to(torch.int32)


def ring_attention_inference(q, k, v, mask, *, mesh, kv_offset, q_offset=0, k_scale=None,
                             v_scale=None, q_sharded=False, kv_len=None):
    """Attention of a query block over a KV cache whose sequence is split
    across the sp ranks of `mesh` (`lwm_tpu/ops/ring.py:545-640`): each rank
    computes the partials of the whole block over its slice of the cache,
    and they merge over sp (`merge_partials`).

    q [b, sq, h, d]: the whole block on every sp rank, or with `q_sharded`
    this rank's contiguous 1/sp of it (gathered here; the output is this
    rank's rows again). k, v head-major [b, h_kv, T_loc, d]: this rank's
    slice of the cache, its key j at global position kv_offset + j (bf16 or
    fp32 as q, or int8 with k_scale, v_scale [b, h_kv, T_loc] fp32). mask
    bool over the local keys: [b, T_loc] per key, or [b, sq, T_loc] a full
    tile (the verify blocks' per-row frontiers).
    - One query (decode): K4 with `return_partials` over the local slice,
      its `kv_len` the local bound on the card (`kv_len`, [b] or a scalar,
      else `local_kv_len` of the mask), the mask per key: validity ∧
      frontier.
    - More (a prefill): K1 over the local keys, causal by global position
      (query i at q_offset + i, q_offset the cache index) plus the mask as
      K1's bias: per key (validity ∧ the last query's frontier) or the full
      tile. No mask over the whole cache is built.
    The fp32 routes of K1 and K4 serve fp32 q. Returns [b, sq, h, d] in
    q.dtype; a row with no valid key anywhere gives 0."""
    sq_local = q.shape[1]
    if q_sharded:
        q = mesh.all_gather(q, "sp", 1)
    b, sq, h, d = q.shape
    key_mask = mask if mask.ndim == 2 else mask[:, -1]
    if sq == 1:
        if kv_len is None:
            kv_len = local_kv_len(key_mask)
        o, m, l = flash_decode(q, k, v, key_mask.contiguous(), kv_len, k_scale, v_scale,
                               return_partials=True)
        o = o.float() * l.transpose(1, 2)[..., None]
    else:
        if k_scale is not None:   # the prefill reads a dequantized slice
            k = (k.float() * k_scale[..., None]).to(q.dtype)
            v = (v.float() * v_scale[..., None]).to(q.dtype)
        tile = mask[:, None] if mask.ndim == 3 else mask[:, None, None, :]
        bias = torch.where(tile, 0.0, BIG_NEG)
        out, lse = flash.flash_attention_fwd(q, k, v, bias, causal=True, q_offset=q_offset,
                                             kv_offset=kv_offset, kv_head_major=True)
        o, m, l = lse_partials(out, lse)
    o, _, l = merge_partials(o, m, l, mesh)
    out = finalize_partials(o, l, q.dtype)
    if q_sharded:
        out = out[:, mesh.sp_rank * sq_local:(mesh.sp_rank + 1) * sq_local]
    return out
