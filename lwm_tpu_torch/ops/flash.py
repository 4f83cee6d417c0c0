"""K1: flash-attention forward (admission prefill, training forward); the
fused backward (training).

K1 replaces the TPU kernel `_fwd_kernel` (`lwm_tpu/ops/pallas_flash.py:199-285`)
reached through `flash_attention_fwd_pallas` (`:624-795`); the backward
replaces `_bwd_dq_kernel` (`:288-353`) and `_bwd_dkv_kernel` (`:356-445`)
reached through `flash_attention_bwd_pallas` (`:798`) with one kernel that
writes dq, dk and dv. The CUDA kernels are `lwm_tpu_torch/csrc/flash_fwd.cu`
and `csrc/flash_bwd.cu`; their source notes say what bounds them on the card
(tensor-core flops at these widths) and how they are laid out. K1 has an
fp32 route too, `csrc/flash_fwd_f32.cu` (each product as three TF32
products on the tensor cores, hi·hi + hi·lo + lo·hi of each operand's
split, which holds the fp32 suite's 1e-5 where TF32 alone keeps ~3
digits), taken for fp32 q, k and v and
counted apart in `flash_attention_fwd.f32_launches`; so has the backward,
`csrc/flash_bwd_f32.cu` (all five products as three TF32 products on the
tensor cores, as K1's; the trainers' default `--dtype=fp32`), counted apart
in `flash_attention_bwd.f32_launches`.

Ported: causal or not, `q_offset`/`kv_offset` and `pos_stride` (query i
at q_offset + i·pos_stride, key j at kv_offset + j·pos_stride: the striped
layout of the ring's steps), segment ids (`q_seg` [b, sq], `kv_seg` [b,
skv]: a logit is kept only where they are equal), per-key and full-tile
additive bias, GQA, seq-major or head-major kv, lse, any head dim d ≤ 128
with d % 4 == 0 (`check_head_dim`: 64 and 128 on their own tiles, another
d on the tiles of the next of them). Not ported yet: dropout, per-head
bias, d > 128 and d % 4 ≠ 0.

Each wrapper (`flash_attention_fwd`, `flash_attention_bwd`) launches its
kernel for CUDA tensors and raises on what it does not take; for CPU
tensors it runs the plain twin (`flash_attention_fwd_plain`,
`flash_attention_bwd_plain`), which the tests and `chip_smoke.py` also hold
the kernel against. The backward takes the same features as K1 minus
head-major kv (training keeps kv seq-major). Unlike the TPU kernels, ragged
sq and skv are masked in the kernels, so no shape gate routes around them.
"""

from __future__ import annotations

import torch

from lwm_tpu_torch.ops import _build
from lwm_tpu_torch.ops.reference import BIG_NEG, MASK_GUARD, attention_mask, reference_attention

TILE_DIMS = (64, 128)   # the kernels' tile widths: each other head dim runs on the next of them
HEAD_DIM_MAX = 128


def check_head_dim(d):
    """Raise unless the attention kernels (K1, the backward, K4) take head
    dim d: d ≤ 128 with d % 4 == 0, as the JAX kernels take any d that their
    block shape holds (`pallas_flash.py:210`, `pallas_decode.py:66`). 64 and
    128 run on their own tiles, any other d (the 3b preset's 100) on the
    tiles of the next of them, the columns past d zero."""
    if not (0 < d <= HEAD_DIM_MAX and d % 4 == 0):
        raise ValueError(f"head_dim {d} not taken: the kernels take d <= {HEAD_DIM_MAX} "
                         "with d % 4 == 0")


def tile_dim(d):
    """The tile width the kernels run head dim d on: d itself at 64 and
    128, else the next of them (csrc/hopper.cuh `launch_head_dim`)."""
    check_head_dim(d)
    return d if d in TILE_DIMS else next(t for t in TILE_DIMS if t > d)


def check_rows(name, x, d):
    """Raise unless x's head dim is contiguous and its rows and data pointer
    are aligned as the kernels' copies need: to 16 bytes at d 64 and 128
    (TMA boxes, 16-byte copies), else to 4 elements (8 bytes in bf16, 4 in
    int8, 16 in fp32: a bf16 head of 100 is 200 bytes)."""
    align = 16 if d in TILE_DIMS else 4 * x.element_size()
    rows = (s * x.element_size() for s in x.stride()[:-1])
    if x.stride(-1) != 1 or any(s % align for s in rows) or x.data_ptr() % align:
        raise ValueError(f"{name}: head dim must be contiguous with {align}-byte aligned rows "
                         f"(strides {x.stride()})")


def flash_attention_fwd_plain(
    q, k, v, bias=None, *, causal=True, q_offset=0, kv_offset=0, pos_stride=1, q_seg=None,
    kv_seg=None, scale=None, kv_head_major=False,
):
    """The kernel's arithmetic in plain PyTorch: fp32 logits from the input
    dtype, p rounded to v.dtype before p·v. Returns (out, lse)."""
    return reference_attention(
        q, k, v, bias, causal=causal, q_offset=q_offset, kv_offset=kv_offset,
        pos_stride=pos_stride, q_seg=q_seg, kv_seg=kv_seg, kv_head_major=kv_head_major,
        scale=scale, p_dtype=v.dtype,
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


def _segments(q_seg, kv_seg, b, sq, skv, device):
    """Segment ids → (q_seg, kv_seg) contiguous int32 [b, sq] and [b, skv]
    on `device`, or (None, None); both or neither."""
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("segment ids need both q_seg and kv_seg")
    if q_seg is None:
        return None, None
    if tuple(q_seg.shape) != (b, sq) or tuple(kv_seg.shape) != (b, skv):
        raise ValueError(f"segment ids {tuple(q_seg.shape)}, {tuple(kv_seg.shape)}: want "
                         f"[{b}, {sq}] and [{b}, {skv}]")
    if q_seg.dtype.is_floating_point or kv_seg.dtype.is_floating_point:
        raise TypeError(f"segment ids must be integers, got {q_seg.dtype}, {kv_seg.dtype}")
    return (q_seg.to(device=device, dtype=torch.int32).contiguous(),
            kv_seg.to(device=device, dtype=torch.int32).contiguous())


def _stride(pos_stride):
    if int(pos_stride) != pos_stride or pos_stride < 1:
        raise ValueError(f"pos_stride must be a positive integer, got {pos_stride}")
    return int(pos_stride)


def _ptr(x):
    return None if x is None else x.data_ptr()


def _kv_strides(x, head_major):
    """(batch, seq, head) element strides of a 4-D kv tensor."""
    sb, s1, s2 = x.stride()[:3]
    return (sb, s2, s1) if head_major else (sb, s1, s2)


FWD_DTYPES = (torch.bfloat16, torch.float32)   # K1's routes: csrc/flash_fwd.cu, flash_fwd_f32.cu


def check_fwd_args(q, k, v, kv_head_major, dtypes=FWD_DTYPES, name="flash_attention_fwd"):
    """Raise on anything the CUDA kernel `name` does not take: q, k and v of
    one of `dtypes`. Returns (skv, h_kv)."""
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        kinds = " or ".join(str(t).removeprefix("torch.") for t in dtypes)
        raise TypeError(
            f"{name} kernel takes {kinds} q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q/k/v on different devices: {q.device}, {k.device}, {v.device}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    b, sq, h, d = q.shape
    skv, h_kv = (k.shape[2], k.shape[1]) if kv_head_major else (k.shape[1], k.shape[2])
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    check_head_dim(d)
    if h % h_kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_rows(name, x, d)
    return skv, h_kv


def flash_attention_fwd(
    q, k, v, bias=None, *, causal=True, q_offset=0, kv_offset=0, pos_stride=1, q_seg=None,
    kv_seg=None, scale=None, kv_head_major=False,
):
    """q: [b, sq, h, d]; k, v: [b, skv, h_kv, d], or [b, h_kv, skv, d] with
    kv_head_major (the cache layout, read in place); bias broadcastable as
    [b|1, 1, sq|1, skv]; query i sits at q_offset + i·pos_stride, key j at
    kv_offset + j·pos_stride; segment ids q_seg [b, sq], kv_seg [b, skv]
    (int, both or neither). Returns (out [b, sq, h, d] in q.dtype,
    lse [b, h, sq] fp32); rows with no visible key give out 0 and lse
    BIG_NEG. CUDA: bf16 operands launch `csrc/flash_fwd.cu`, fp32 ones
    `csrc/flash_fwd_f32.cu`; CPU: the plain twin."""
    pos_stride = _stride(pos_stride)
    skv = k.shape[2] if kv_head_major else k.shape[1]
    q_seg, kv_seg = _segments(q_seg, kv_seg, q.shape[0], q.shape[1], skv, q.device)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(
            q, k, v, bias, causal=causal, q_offset=q_offset, kv_offset=kv_offset,
            pos_stride=pos_stride, q_seg=q_seg, kv_seg=kv_seg, scale=scale,
            kv_head_major=kv_head_major,
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
    f32 = q.dtype == torch.float32
    lib = _build.load()
    entry = lib.lwm_flash_fwd_f32 if f32 else lib.lwm_flash_fwd
    rc = entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, out.data_ptr(),
        lse.data_ptr(), b, sq, skv, h, h_kv, d,
        q.stride(0), q.stride(1), q.stride(2),
        *_kv_strides(k, kv_head_major), *_kv_strides(v, kv_head_major),
        bias_sb, bias_sr, int(causal), int(q_offset), int(kv_offset), pos_stride, float(scale),
        _ptr(q_seg), _ptr(kv_seg), _build.stream_handle(q.device),
    )
    _build.check(rc, "lwm_flash_fwd_f32" if f32 else "lwm_flash_fwd")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.f32_launches += f32
    return out, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.f32_launches = 0   # of them, the fp32 route's


# ------------------------------------------------------------------ backward


def flash_attention_bwd_plain(
    q, k, v, g, lse, delta, bias=None, *, causal=True, q_offset=0, kv_offset=0, pos_stride=1,
    q_seg=None, kv_seg=None, scale=None,
):
    """The backward kernel's arithmetic in plain PyTorch (the TPU kernels'
    `pallas_flash.py:314-349`, `:396-440`): fp32 logits from the input dtype plus bias, the causal mask
    by global position (`pos_stride` apart) and the segment mask as K1's,
    p = exp(logits − lse) where logits > MASK_GUARD,
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
    keep = attention_mask(sq, skv, q.device, causal=causal, q_offset=q_offset,
                          kv_offset=kv_offset, pos_stride=pos_stride, q_seg=q_seg, kv_seg=kv_seg)
    if keep is not None:
        logits = logits.masked_fill(~keep[:, :, None], BIG_NEG)
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


def _bwd_launch(outs, q, k, v, g, lse, delta, bias, causal, q_offset, kv_offset, scale,
                pos_stride=1, q_seg=None, kv_seg=None):
    """Check the arguments and launch the backward kernel writing `outs` =
    (dq_accum fp32, zeroed; dk; dv); the wrapper counts the launch."""
    skv, h_kv = check_fwd_args(q, k, v, kv_head_major=False, name="flash_attention_bwd")
    b, sq, h, d = q.shape
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} must match q {tuple(q.shape)} {q.dtype}")
    check_rows("g", g, d)
    for name, x in (("lse", lse), ("delta", delta)):
        if (x.shape != (b, h, sq) or x.dtype != torch.float32 or not x.is_contiguous()
                or x.device != q.device):
            raise ValueError(f"{name} must be contiguous fp32 [{b}, {h}, {sq}] on {q.device}, "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    q_seg, kv_seg = _segments(q_seg, kv_seg, b, sq, skv, q.device)
    scale = d ** -0.5 if scale is None else scale
    bias_sb = bias_sr = 0
    bias_ptr = None
    if bias is not None:
        bias, bias_sb, bias_sr = _normalize_bias(bias.to(q.device), b, sq, skv)
        bias_ptr = bias.data_ptr()
    entry = "lwm_flash_bwd_f32" if q.dtype == torch.float32 else "lwm_flash_bwd"
    rc = getattr(_build.load(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), bias_ptr, *(o.data_ptr() for o in outs), b, sq, skv, h, h_kv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *g.stride()[:3],
        bias_sb, bias_sr, int(causal), int(q_offset), int(kv_offset), pos_stride, float(scale),
        _ptr(q_seg), _ptr(kv_seg), _build.stream_handle(q.device),
    )
    _build.check(rc, entry)


def flash_attention_bwd(
    q, k, v, g, lse, delta, bias=None, *, causal=True, q_offset=0, kv_offset=0, pos_stride=1,
    q_seg=None, kv_seg=None, scale=None,
):
    """The backward of `flash_attention_fwd` with seq-major kv, the contract
    of `flash_attention_bwd_pallas` (`pallas_flash.py:798`): q, g [b, sq, h,
    d]; k, v [b, skv, h_kv, d]; lse (from the forward) and delta = Σ_d g·out
    [b, h, sq] fp32; bias broadcastable as [b|1, 1, sq|1, skv] (not
    differentiated); positions and segment ids as `flash_attention_fwd`. Returns (dq, dk, dv) in the input dtypes, dk/dv at
    h_kv heads (each group summed in fp32). CUDA: one kernel launch, dq
    summed in an fp32 buffer by atomics (its order, and so its last bit,
    changes from run to run) and rounded once; bf16 operands launch
    `csrc/flash_bwd.cu`, fp32 ones `csrc/flash_bwd_f32.cu`; CPU: the plain
    twin."""
    q_seg, kv_seg = _segments(q_seg, kv_seg, q.shape[0], q.shape[1], k.shape[1], q.device)
    kw = dict(causal=causal, q_offset=q_offset, kv_offset=kv_offset,
              pos_stride=_stride(pos_stride), q_seg=q_seg, kv_seg=kv_seg, scale=scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, g, lse, delta, bias, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention_bwd kernel for device {q.device}")
    dq_accum = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _bwd_launch((dq_accum, dk, dv), q, k, v, g, lse, delta, bias, **kw)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.f32_launches += q.dtype == torch.float32
    return dq_accum.to(q.dtype), dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.f32_launches = 0   # of them, the fp32 route's
