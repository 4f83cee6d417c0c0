"""K1: flash-attention forward (admission prefill, training forward); K2 and
K3: its backward (training).

K1 replaces the TPU kernel `_fwd_kernel` (`lwm_tpu/ops/pallas_flash.py:199-285`)
reached through `flash_attention_fwd_pallas` (`:624-795`); K2 and K3 replace
`_bwd_dq_kernel` (`:288-353`) and `_bwd_dkv_kernel` (`:356-445`) reached
through `flash_attention_bwd_pallas` (`:798`). The CUDA kernels are
`lwm_tpu_torch/csrc/flash_fwd.cu` and `csrc/flash_bwd.cu`; their source notes
say what bounds them on the card (tensor-core flops at these widths) and how
they are laid out.

Ported: causal or not, `q_offset`/`kv_offset`, per-key and full-tile
additive bias, GQA, seq-major or head-major kv, lse. Not ported yet: segment
ids, `pos_stride` and dropout (training and multi-GPU), per-head bias.

Each wrapper (`flash_attention_fwd`, `flash_attention_bwd_dq`,
`flash_attention_bwd_dkv`) launches its kernel for CUDA tensors and raises
on what it does not take; for CPU tensors it runs the plain twin
(`flash_attention_fwd_plain`, `flash_attention_bwd_plain`), which the tests
and `chip_smoke.py` also hold the kernel against. The backward takes the
same features as K1 minus head-major kv (training keeps kv seq-major).
Unlike the TPU kernels, ragged sq and skv are masked in the kernels, so no
shape gate routes around them.
"""

from __future__ import annotations

import torch

from lwm_tpu_torch.ops import _build
from lwm_tpu_torch.ops.reference import BIG_NEG, MASK_GUARD, reference_attention

HEAD_DIMS = (64, 128)


def flash_attention_fwd_plain(
    q, k, v, bias=None, *, causal=True, q_offset=0, kv_offset=0, scale=None,
    kv_head_major=False,
):
    """The kernel's arithmetic in plain PyTorch: fp32 logits from the input
    dtype, p rounded to v.dtype before p·v. Returns (out, lse)."""
    return reference_attention(
        q, k, v, bias, causal=causal, q_offset=q_offset, kv_offset=kv_offset,
        kv_head_major=kv_head_major, scale=scale, p_dtype=v.dtype,
    )


def _normalize_bias(bias, b, sq, skv):
    """[b|1, 1, sq|1, skv] additive bias → (fp32 contiguous [bb, rows, skv],
    batch stride, row stride); strides are 0 on broadcast dims."""
    if bias.ndim != 4:
        raise ValueError(f"bias must be 4-D [b|1, 1, sq|1, skv], got {tuple(bias.shape)}")
    bb, bh, bsq, bskv = bias.shape
    if bskv != skv or bb not in (1, b) or bh != 1 or bsq not in (1, sq):
        raise ValueError(
            f"bias {tuple(bias.shape)} not broadcastable as [{b}|1, 1, {sq}|1, {skv}] "
            "(per-head bias is not supported)"
        )
    bias = bias.float().contiguous()
    return bias, (0 if bb == 1 else bsq * skv), (0 if bsq == 1 else skv)


def _kv_strides(x, head_major):
    """(batch, seq, head) element strides of a 4-D kv tensor."""
    sb, s1, s2 = x.stride()[:3]
    return (sb, s2, s1) if head_major else (sb, s1, s2)


def check_fwd_args(q, k, v, kv_head_major):
    """Raise on anything the CUDA kernel does not take. Returns (skv, h_kv)."""
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention_fwd kernel takes bf16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q/k/v on different devices: {q.device}, {k.device}, {v.device}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    b, sq, h, d = q.shape
    skv, h_kv = (k.shape[2], k.shape[1]) if kv_head_major else (k.shape[1], k.shape[2])
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if h % h_kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:-1]) or x.data_ptr() % 16:
            raise ValueError(
                f"{name}: head dim must be contiguous with 16-byte aligned rows "
                f"(strides {x.stride()})"
            )
    return skv, h_kv


def flash_attention_fwd(
    q, k, v, bias=None, *, causal=True, q_offset=0, kv_offset=0, scale=None,
    kv_head_major=False,
):
    """q: [b, sq, h, d]; k, v: [b, skv, h_kv, d], or [b, h_kv, skv, d] with
    kv_head_major (the cache layout, read in place); bias broadcastable as
    [b|1, 1, sq|1, skv]. Returns (out [b, sq, h, d] in q.dtype,
    lse [b, h, sq] fp32)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(
            q, k, v, bias, causal=causal, q_offset=q_offset, kv_offset=kv_offset,
            scale=scale, kv_head_major=kv_head_major,
        )
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention_fwd kernel for device {q.device}")
    skv, h_kv = check_fwd_args(q, k, v, kv_head_major)
    b, sq, h, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    bias_sb = bias_sr = 0
    bias_ptr = None
    if bias is not None:
        bias, bias_sb, bias_sr = _normalize_bias(bias.to(q.device), b, sq, skv)
        bias_ptr = bias.data_ptr()
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _build.load()
    rc = lib.lwm_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, out.data_ptr(),
        lse.data_ptr(), b, sq, skv, h, h_kv, d,
        q.stride(0), q.stride(1), q.stride(2),
        *_kv_strides(k, kv_head_major), *_kv_strides(v, kv_head_major),
        bias_sb, bias_sr, int(causal), int(q_offset), int(kv_offset), float(scale),
        _build.stream_handle(q.device),
    )
    _build.check(rc, "lwm_flash_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


# ------------------------------------------------------------------ backward


def flash_attention_bwd_plain(
    q, k, v, g, lse, delta, bias=None, *, causal=True, q_offset=0, kv_offset=0, scale=None,
):
    """K2/K3's arithmetic in plain PyTorch (`pallas_flash.py:314-349`,
    `:396-440`): fp32 logits from the input dtype plus bias, the causal mask
    by global position, p = exp(logits − lse) where logits > MASK_GUARD,
    dp = g·vᵀ, ds = p·(dp − delta)·scale; p is rounded to g.dtype before
    pᵀ·g and ds to k.dtype / q.dtype before ds·k / dsᵀ·q. q, g: [b, sq, h, d];
    k, v: [b, skv, h_kv, d]; lse, delta: [b, h, sq] fp32. Returns (dq, dk,
    dv) in the input dtypes, dk/dv at h_kv heads (each group summed)."""
    b, sq, h, d = q.shape
    skv, h_kv = k.shape[1], k.shape[2]
    grp = h // h_kv
    scale = d ** -0.5 if scale is None else scale
    qf = q.float().reshape(b, sq, h_kv, grp, d)
    gf = g.float().reshape(b, sq, h_kv, grp, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()[:, :, None]
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)
        kpos = kv_offset + torch.arange(skv, device=q.device)
        logits = logits.masked_fill(kpos[None, :] > qpos[:, None], BIG_NEG)
    lse = lse.float().reshape(b, h_kv, grp, sq, 1)
    delta = delta.float().reshape(b, h_kv, grp, sq, 1)
    p = torch.where(logits > MASK_GUARD, torch.exp(logits - lse), 0.0)
    del logits
    dp = torch.einsum("bqkgd,bskd->bkgqs", gf, v.float())
    ds = p * (dp - delta) * scale
    del dp
    dv = torch.einsum("bkgqs,bqkgd->bskd", p.to(g.dtype).float(), gf)
    del p
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds.to(q.dtype).float(), qf)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds.to(k.dtype).float(), k.float())
    return dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_launch(entry, outs, q, k, v, g, lse, delta, bias, causal, q_offset, kv_offset, scale):
    """Check the arguments and launch one backward kernel (`entry`) writing
    `outs`; the wrapper counts the launch."""
    skv, h_kv = check_fwd_args(q, k, v, kv_head_major=False)
    b, sq, h, d = q.shape
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} must match q {tuple(q.shape)} {q.dtype}")
    if g.stride(-1) != 1 or any(s % 8 for s in g.stride()[:-1]) or g.data_ptr() % 16:
        raise ValueError(f"g: head dim must be contiguous with 16-byte aligned rows ({g.stride()})")
    for name, x in (("lse", lse), ("delta", delta)):
        if (x.shape != (b, h, sq) or x.dtype != torch.float32 or not x.is_contiguous()
                or x.device != q.device):
            raise ValueError(f"{name} must be contiguous fp32 [{b}, {h}, {sq}] on {q.device}, "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    scale = d ** -0.5 if scale is None else scale
    bias_sb = bias_sr = 0
    bias_ptr = None
    if bias is not None:
        bias, bias_sb, bias_sr = _normalize_bias(bias.to(q.device), b, sq, skv)
        bias_ptr = bias.data_ptr()
    rc = getattr(_build.load(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), bias_ptr, *(o.data_ptr() for o in outs), b, sq, skv, h, h_kv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *g.stride()[:3],
        bias_sb, bias_sr, int(causal), int(q_offset), int(kv_offset), float(scale),
        _build.stream_handle(q.device),
    )
    _build.check(rc, entry)


def _require_cuda(name, q):
    if q.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {q.device}")


def flash_attention_bwd_dq(
    q, k, v, g, lse, delta, bias=None, *, causal=True, q_offset=0, kv_offset=0, scale=None,
):
    """K2: dq [b, sq, h, d] in q.dtype (arguments as `flash_attention_bwd`)."""
    kw = dict(causal=causal, q_offset=q_offset, kv_offset=kv_offset, scale=scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, g, lse, delta, bias, **kw)[0]
    _require_cuda("flash_attention_bwd_dq", q)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    _bwd_launch("lwm_flash_bwd_dq", (dq,), q, k, v, g, lse, delta, bias, **kw)
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(
    q, k, v, g, lse, delta, bias=None, *, causal=True, q_offset=0, kv_offset=0, scale=None,
):
    """K3: (dk, dv) [b, skv, h_kv, d] in k/v dtype, each kv head's group of
    query heads summed in fp32 (arguments as `flash_attention_bwd`)."""
    kw = dict(causal=causal, q_offset=q_offset, kv_offset=kv_offset, scale=scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, g, lse, delta, bias, **kw)[1:]
    _require_cuda("flash_attention_bwd_dkv", q)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _bwd_launch("lwm_flash_bwd_dkv", (dk, dv), q, k, v, g, lse, delta, bias, **kw)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd(
    q, k, v, g, lse, delta, bias=None, *, causal=True, q_offset=0, kv_offset=0, scale=None,
):
    """The backward of `flash_attention_fwd` with seq-major kv, the contract
    of `flash_attention_bwd_pallas` (`pallas_flash.py:798`): q, g [b, sq, h,
    d]; k, v [b, skv, h_kv, d]; lse (from the forward) and delta = Σ_d g·out
    [b, h, sq] fp32; bias broadcastable as [b|1, 1, sq|1, skv] (not
    differentiated). Returns (dq, dk, dv) in the input dtypes, dk/dv at
    h_kv heads. CUDA: K2 then K3; CPU: the plain twin, once."""
    kw = dict(causal=causal, q_offset=q_offset, kv_offset=kv_offset, scale=scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, g, lse, delta, bias, **kw)
    dq = flash_attention_bwd_dq(q, k, v, g, lse, delta, bias, **kw)
    return (dq, *flash_attention_bwd_dkv(q, k, v, g, lse, delta, bias, **kw))


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
