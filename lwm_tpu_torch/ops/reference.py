"""Plain full-materialization attention: the numerical oracle of the port's
attention kernels and the `attn_impl="plain"` model path (O(sq·skv) memory).

Counterpart of `lwm_tpu/ops/reference.py:7-57`, plus the masking constants
of `lwm_tpu/ops/blockwise.py:26-27`. Beyond the JAX oracle it routes GQA
(query head qh reads kv head qh // g), accepts head-major kv and returns the
row log-sum-exp, so it is also the body of the K1 twin (ops/flash.py).
"""

import torch

BIG_NEG = -1e30     # masked logit
MASK_GUARD = -1e29  # logits at or below this count as masked: p = 0


def attention_mask(sq, skv, device, *, causal=True, q_offset=0, kv_offset=0, pos_stride=1,
                   q_seg=None, kv_seg=None):
    """The logits a query may keep, bool [b|1, 1, sq, skv], or None when
    every one is kept: causal by global position (query i at q_offset +
    i·pos_stride, key j at kv_offset + j·pos_stride) and, with segment ids
    (int [b, sq] and [b, skv]), only where q_seg == kv_seg
    (`lwm_tpu/ops/pallas_flash.py:72-87` `_mask_logits`)."""
    keep = None
    if causal:
        qpos = q_offset + pos_stride * torch.arange(sq, device=device)
        kpos = kv_offset + pos_stride * torch.arange(skv, device=device)
        keep = (kpos[None, :] <= qpos[:, None])[None, None]
    if q_seg is not None:
        same = (q_seg[:, :, None] == kv_seg[:, None, :])[:, None]
        keep = same if keep is None else keep & same
    return keep


def reference_attention(
    q, k, v, bias=None, *, causal=True, q_offset=0, kv_offset=0, pos_stride=1,
    q_seg=None, kv_seg=None, kv_head_major=False, scale=None, p_dtype=torch.float32,
):
    """q: [b, sq, h, d]; k, v: [b, skv, h_kv, d], or [b, h_kv, skv, d] with
    kv_head_major; h_kv divides h. bias: additive, broadcastable to
    [b, 1, sq, skv]. Causal masking is by global position: query i sits at
    q_offset + i·pos_stride, key j at kv_offset + j·pos_stride (pos_stride >
    1: the striped sequence layout). Segment ids q_seg [b, sq], kv_seg
    [b, skv] (int) keep a logit only where they are equal.

    p_dtype: the softmax weights are rounded to it before p·v (the
    kernels round p to the value dtype); fp32 by default.

    Returns (out [b, sq, h, d] in q.dtype, lse [b, h, sq] fp32). Rows with
    no valid key give out 0 and lse BIG_NEG."""
    b, sq, h, d = q.shape
    if kv_head_major:
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    skv, h_kv = k.shape[1], k.shape[2]
    if h % h_kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    g = h // h_kv
    scale = d ** -0.5 if scale is None else scale
    qf = q.float().reshape(b, sq, h_kv, g, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    logits = logits.reshape(b, h, sq, skv)
    if bias is not None:
        logits = logits + bias.float()
    keep = attention_mask(sq, skv, q.device, causal=causal, q_offset=q_offset,
                          kv_offset=kv_offset, pos_stride=pos_stride, q_seg=q_seg, kv_seg=kv_seg)
    if keep is not None:
        logits = logits.masked_fill(~keep, BIG_NEG)
    m = logits.amax(-1, keepdim=True)
    p = torch.where(logits > MASK_GUARD, torch.exp(logits - m), 0.0)
    l = p.sum(-1, keepdim=True)
    pv = torch.einsum(
        "bkgqs,bskd->bqkgd",
        p.to(p_dtype).float().reshape(b, h_kv, g, sq, skv),
        v.float(),
    ).reshape(b, sq, h, d)
    l_q = l[..., 0].transpose(1, 2)[..., None]             # [b, sq, h, 1]
    out = torch.where(l_q > 0, pv / l_q.clamp_min(1e-30), 0.0)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)), BIG_NEG)[..., 0]
    return out.to(q.dtype), lse
