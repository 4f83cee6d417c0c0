"""K4: one-token flash decoding over the head-major KV cache (every decode
round of the serving loop).

Replaces the TPU kernel `_decode_kernel` (`lwm_tpu/ops/pallas_decode.py:66-140`)
reached through `flash_decode_pallas` (`:143-247`). The CUDA kernel is
`lwm_tpu_torch/csrc/flash_decode.cu`; its source note says what bounds it on
the card (HBM bytes of the cache) and how it is laid out.

Ported: bf16 and int8 caches (k scales folded into the logits, v scales into
p before p is rounded for p·v), per-key masks, the `kv_len` scan bound, GQA
with the g query heads of a kv head sharing one cache read. Not ported yet:
`return_partials` (the shared-prefix and sequence-sharded combines).

`flash_decode` launches the kernel for CUDA tensors and raises on what it
does not take; for CPU tensors it runs the plain twin `flash_decode_plain`,
which the tests and `chip_smoke.py` also hold the kernel against.
"""

from __future__ import annotations

import torch

from lwm_tpu_torch.ops import _build
from lwm_tpu_torch.ops.reference import BIG_NEG

HEAD_DIMS = (64, 128)
GROUP_SIZES = (1, 2, 4, 8)  # query heads per kv head the kernel is built for


def flash_decode_plain(q, k, v, mask, kv_len, k_scale=None, v_scale=None, *, scale=None):
    """The kernel's arithmetic in plain PyTorch (same argument contract as
    `flash_decode`): keys at or past kv_len are ignored, like the kernel."""
    b, _, h, d = q.shape
    h_kv, T = k.shape[1], k.shape[2]
    g = h // h_kv
    scale = d ** -0.5 if scale is None else scale
    qf = q.float().reshape(b, h_kv, g, d)
    logits = torch.einsum("bkgd,bktd->bkgt", qf, k.to(q.dtype).float()) * scale
    if k_scale is not None:
        logits = logits * k_scale.float()[:, :, None, :]
    valid = mask.bool() & (torch.arange(T, device=q.device) < kv_len)[None, :]
    valid = valid[:, None, None, :]
    logits = torch.where(valid, logits, BIG_NEG)
    m = logits.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(logits - m), 0.0)
    l = p.sum(-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale.float()[:, :, None, :]
    pv = torch.einsum("bkgt,bktd->bkgd", p.to(q.dtype).float(), v.to(q.dtype).float())
    out = torch.where(l > 0, pv / l.clamp_min(1e-30), 0.0)
    return out.reshape(b, 1, h, d).to(q.dtype)


def check_decode_args(q, k, v, mask, k_scale, v_scale):
    """Raise on anything the CUDA kernel does not take."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash_decode kernel takes bf16 q, got {q.dtype}")
    if k.dtype not in (torch.bfloat16, torch.int8) or v.dtype != k.dtype:
        raise TypeError(f"flash_decode kernel takes a bf16 or int8 cache, got {k.dtype}/{v.dtype}")
    quant = k.dtype == torch.int8
    if quant != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale are given exactly when the cache is int8")
    for x in (k, v, mask) + ((k_scale, v_scale) if quant else ()):
        if x.device != q.device:
            raise ValueError(f"tensors on different devices: {q.device}, {x.device}")
    if q.ndim != 4 or q.shape[1] != 1 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    b, _, h, d = q.shape
    _, h_kv, T, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"cache {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if h % h_kv or h // h_kv not in GROUP_SIZES:
        raise ValueError(f"{h} query heads over {h_kv} kv heads: group not in {GROUP_SIZES}")
    if k.stride() != v.stride():
        raise ValueError("k and v caches must share strides")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:-1]) or x.data_ptr() % 16:
            raise ValueError(
                f"{name}: head dim must be contiguous with 16-byte aligned rows "
                f"(strides {x.stride()})"
            )
    if mask.shape != (b, T) or not mask.is_contiguous():
        raise ValueError(f"mask must be contiguous [{b}, {T}], got {tuple(mask.shape)}")
    if quant:
        for x in (k_scale, v_scale):
            if x.shape != (b, h_kv, T) or x.dtype != torch.float32 or not x.is_contiguous():
                raise ValueError(f"scales must be contiguous fp32 [{b}, {h_kv}, {T}]")


def flash_decode(q, k, v, mask, kv_len, k_scale=None, v_scale=None, *, scale=None):
    """q: [b, 1, h, d]; k, v: head-major [b, h_kv, T, d] (bf16, or int8 with
    k_scale/v_scale [b, h_kv, T] fp32); mask: bool [b, T], True = attend;
    kv_len: int, keys at or past it are not read (an upper bound on every
    row's frontier). Returns [b, 1, h, d] in q.dtype; a row with no valid
    key gives 0."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, mask, kv_len, k_scale, v_scale, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_decode kernel for device {q.device}")
    if mask.dtype != torch.bool:
        mask = mask != 0
    check_decode_args(q, k, v, mask, k_scale, v_scale)
    b, _, h, d = q.shape
    _, h_kv, T, _ = k.shape
    quant = k.dtype == torch.int8
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    lib = _build.load()
    rc = lib.lwm_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
        mask.data_ptr(), out.data_ptr(),
        b, h, h_kv, T, d, int(kv_len), int(quant),
        q.stride(0), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        float(scale), _build.stream_handle(q.device),
    )
    _build.check(rc, "lwm_flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
