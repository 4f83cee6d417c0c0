"""K1: flash-attention forward (admission prefill over the slot cache).

Replaces the TPU kernel `_fwd_kernel` (`lwm_tpu/ops/pallas_flash.py:199-285`)
reached through `flash_attention_fwd_pallas` (`:624-795`). The CUDA kernel is
`lwm_tpu_torch/csrc/flash_fwd.cu`; its source note says what bounds it on the
card (tensor-core flops at admission widths) and how it is laid out.

Ported: causal or not, `q_offset`/`kv_offset`, per-key and full-tile
additive bias, GQA, seq-major or head-major kv, lse. Not ported yet: segment
ids, `pos_stride` and dropout (training and multi-GPU), per-head bias.

`flash_attention_fwd` launches the kernel for CUDA tensors and raises on what
it does not take; for CPU tensors it runs the plain twin
`flash_attention_fwd_plain`, which the tests and `chip_smoke.py` also hold
the kernel against. Unlike the TPU kernel, ragged sq and skv are masked in
the kernel, so no shape gate routes around it.
"""

from __future__ import annotations

import torch

from lwm_tpu_torch.ops import _build
from lwm_tpu_torch.ops.reference import reference_attention

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
