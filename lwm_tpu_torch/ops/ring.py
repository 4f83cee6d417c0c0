"""Single-device flash attention with a hand-written backward: the
counterpart of `flash_attention` in `lwm_tpu/ops/ring.py:473-537` (the
mesh-less branch of the JAX model's `_ring_train`, `llama.py:708-733`).

`FlashAttention` is a `torch.autograd.Function`. Its forward runs K1
(`ops.flash.flash_attention_fwd`, seq-major kv) through the custom op
`lwm_tpu_torch::flash_fwd` and saves only (q, k, v, out, lse), as the JAX
custom VJP does. Its backward computes delta = Σ_d g·out in fp32 from the
rounded `out` (`ring.py:517-525`, `_chunked_delta` `:191-224`) in plain
torch, as JAX does outside any kernel, then one launch of the fused
backward kernel (`ops.flash.flash_attention_bwd`: dq, dk and dv together);
dk/dv come back at h_kv heads. The bias
is not differentiated. On CPU tensors every wrapper runs its plain twin.

K1 is a custom op so that selective activation checkpointing can keep its
outputs: `save_flash_policy` marks it MUST_SAVE and everything else
PREFER_RECOMPUTE, which is JAX's `save_only_these_names("flash_out",
"flash_lse")` (`llama.py:1370-1376`): a rematerialized block replays its
norms, projections, RoPE and MLP in the backward, but not K1.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import CheckpointPolicy

from lwm_tpu_torch.ops import flash


@torch.library.custom_op("lwm_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: Optional[torch.Tensor],
    causal: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 over seq-major kv: (out in q.dtype, lse [b, h, sq] fp32)."""
    return flash.flash_attention_fwd(q, k, v, bias, causal=causal)


@flash_fwd_op.register_fake
def _(q, k, v, bias, causal):
    b, sq, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, sq), dtype=torch.float32)


def save_flash_policy(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of `remat_block="save_flash"`."""
    if op is torch.ops.lwm_tpu_torch.flash_fwd.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, causal):
        out, lse = flash_fwd_op(q, k, v, bias, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, bias, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        delta = torch.einsum("bqhd,bqhd->bhq", g.float(), out.float()).contiguous()
        dq, dk, dv = flash.flash_attention_bwd(
            q, k, v, g.to(q.dtype).contiguous(), lse, delta, bias, causal=ctx.causal
        )
        return dq, dk, dv, None, None


def flash_attention(q, k, v, bias=None, *, causal=True):
    """q [b, s, h, d]; k, v [b, s_kv, h_kv, d] (seq-major); bias additive,
    broadcastable as [b|1, 1, s|1, s_kv]. Returns out [b, s, h, d] in
    q.dtype, differentiable in q, k and v. Segment ids are not ported yet."""
    return FlashAttention.apply(q, k, v, bias, causal)
