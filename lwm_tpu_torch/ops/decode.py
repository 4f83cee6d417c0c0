"""K4: one-token flash decoding over the head-major KV cache (every decode
round of the serving loop).

Replaces the TPU kernel `_decode_kernel` (`lwm_tpu/ops/pallas_decode.py:66-140`)
reached through `flash_decode_pallas` (`:143-247`). The CUDA kernel is
`lwm_tpu_torch/csrc/flash_decode.cu`; its source note says what bounds it on
the card (HBM bytes of the cache) and how it is laid out: the keys are split
across blocks (`SPLIT_KEYS` a block), each block writes its split's partial
(o, m, l) to fp32 scratch, and a merge kernel combines them.

Ported: bf16 and int8 caches (k scales folded into the logits, v scales into
p before p is rounded for p·v), per-key masks, the `kv_len` scan bound, GQA
at any group g = h / h_kv (the g query heads of a kv head share one cache
read; a group other than 1/2/4/8 runs in chunks of 8 heads, as the
shared-prefix fold of `ops.prefix` gives slots·g), and `return_partials` (o
l-normalized, with the row's m and l, for the shared-prefix and
sequence-sharded combines).

`flash_decode` launches the kernel for CUDA tensors and raises on what it
does not take; for CPU tensors it runs the plain twin `flash_decode_plain`,
which the tests and `chip_smoke.py` also hold the kernel against.
`flash_decode_split_plain` is the kernel's split-and-merge algorithm in
plain PyTorch (`split_partials_plain`, then `merge_partials_plain`).
"""

from __future__ import annotations

import torch

from lwm_tpu_torch.ops import _build
from lwm_tpu_torch.ops.reference import BIG_NEG, MASK_GUARD

HEAD_DIMS = (64, 128)
SPLIT_KEYS = 512            # keys a block of the kernel's first pass (a multiple of 256, ≤ 2048)


def _masked_logits(q, k, mask, kv_len, k_scale, scale):
    """Scaled logits [b, h_kv, g, T] fp32 with BIG_NEG at masked keys and
    at keys at or past kv_len, and the validity [b, 1, 1, T]."""
    b, _, h, d = q.shape
    h_kv, T = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, h_kv, h // h_kv, d)
    logits = torch.einsum("bkgd,bktd->bkgt", qf, k.to(q.dtype).float()) * scale
    if k_scale is not None:
        logits = logits * k_scale.float()[:, :, None, :]
    valid = mask.bool() & (torch.arange(T, device=q.device) < kv_len)[None, :]
    valid = valid[:, None, None, :]
    return torch.where(valid, logits, BIG_NEG), valid


def flash_decode_plain(q, k, v, mask, kv_len, k_scale=None, v_scale=None, *, scale=None,
                       return_partials=False):
    """The kernel's arithmetic in plain PyTorch (same argument contract as
    `flash_decode`): keys at or past kv_len are ignored, like the kernel."""
    b, _, h, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    logits, valid = _masked_logits(q, k, mask, kv_len, k_scale, scale)
    m = logits.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(logits - m), 0.0)
    l = p.sum(-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale.float()[:, :, None, :]
    pv = torch.einsum("bkgt,bktd->bkgd", p.to(q.dtype).float(), v.to(q.dtype).float())
    out = torch.where(l > 0, pv / l.clamp_min(1e-30), 0.0)
    out = out.reshape(b, 1, h, d).to(q.dtype)
    if not return_partials:
        return out
    return out, m.reshape(b, h, 1), l.reshape(b, h, 1)


def split_partials_plain(q, k, v, mask, kv_len, k_scale=None, v_scale=None, *, scale=None,
                         split=SPLIT_KEYS):
    """The kernel's first pass in plain PyTorch: for each run of `split`
    keys, its max scaled logit m_i, l_i = Σ exp(s − m_i) and the
    unnormalized o_i = Σ round(p·v_scale)·v, p rounded to q.dtype against the
    split's own max. Returns [b, h, n_split, d + 2] fp32 (o, m, l); a split
    with no valid key gives (0, BIG_NEG, 0)."""
    b, _, h, d = q.shape
    h_kv, T = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    n_split = -(-T // split)
    pad = n_split * split - T
    logits, valid = _masked_logits(q, k, mask, kv_len, k_scale, scale)
    logits = torch.nn.functional.pad(logits, (0, pad), value=BIG_NEG)
    logits = logits.reshape(*logits.shape[:3], n_split, split)
    valid = torch.nn.functional.pad(valid, (0, pad)).reshape(b, 1, 1, n_split, split)
    m = logits.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(logits - m), 0.0)
    l = p.sum(-1, keepdim=True)
    if v_scale is not None:
        vsc = torch.nn.functional.pad(v_scale.float(), (0, pad))
        p = p * vsc.reshape(b, h_kv, 1, n_split, split)
    vv = torch.nn.functional.pad(v.to(q.dtype).float(), (0, 0, 0, pad))
    o = torch.einsum("bkgns,bknsd->bkgnd", p.to(q.dtype).float(),
                     vv.reshape(b, h_kv, n_split, split, d))
    return torch.cat([o, m, l], -1).reshape(b, h, n_split, d + 2)


def merge_partials_plain(parts, dtype, return_partials=False):
    """The merge kernel in plain PyTorch: parts [b, h, n_split, d + 2] (o, m,
    l) → o = Σ w_i o_i / Σ w_i l_i over the splits with a valid key, w_i =
    exp(m_i − max m), as [b, 1, h, d] in `dtype`; with `return_partials` also
    m and l = Σ w_i l_i as [b, h, 1] fp32. A row with no valid key gives
    (0, BIG_NEG, 0)."""
    b, h, _, d2 = parts.shape
    o, m, l = parts[..., :-2], parts[..., -2], parts[..., -1]
    live = m > MASK_GUARD
    mx = m.amax(-1, keepdim=True)
    w = torch.where(live, torch.exp(m - mx), 0.0)
    l_sum = (w * l).sum(-1, keepdim=True)
    o_sum = torch.einsum("bhn,bhnd->bhd", w, torch.where(live[..., None], o, 0.0))
    out = torch.where(l_sum > 0, o_sum / l_sum.clamp_min(1e-30), 0.0)
    out = out.reshape(b, 1, h, d2 - 2).to(dtype)
    if not return_partials:
        return out
    return out, torch.where(l_sum > 0, mx, BIG_NEG), l_sum


def flash_decode_split_plain(q, k, v, mask, kv_len, k_scale=None, v_scale=None, *, scale=None,
                             split=SPLIT_KEYS, return_partials=False):
    """The kernel's algorithm in plain PyTorch: `split_partials_plain`, then
    `merge_partials_plain`. Same contract as `flash_decode`."""
    parts = split_partials_plain(q, k, v, mask, kv_len, k_scale, v_scale, scale=scale,
                                 split=split)
    return merge_partials_plain(parts, q.dtype, return_partials)


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
    if h % h_kv:
        raise ValueError(f"{h} query heads do not group over {h_kv} kv heads")
    if b * h_kv > 65535:  # the kernel's grid.y
        raise ValueError(f"{b} rows x {h_kv} kv heads exceed the kernel's 65535 (b, kv head) blocks")
    if k.stride() != v.stride():
        raise ValueError("k and v caches must share strides")
    for name, x in (("q", q), ("k", k), ("v", v)):
        rows = (s * x.element_size() for s in x.stride()[:-1])
        if x.stride(-1) != 1 or any(s % 16 for s in rows) or x.data_ptr() % 16:
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


def flash_decode(q, k, v, mask, kv_len, k_scale=None, v_scale=None, *, scale=None,
                 return_partials=False):
    """q: [b, 1, h, d]; k, v: head-major [b, h_kv, T, d] (bf16, or int8 with
    k_scale/v_scale [b, h_kv, T] fp32); mask: bool [b, T], True = attend;
    kv_len: int, keys at or past it are not read (an upper bound on every
    row's frontier). Returns [b, 1, h, d] in q.dtype; a row with no valid
    key gives 0. With `return_partials`, returns (o, m, l) as the JAX kernel
    does: o as above (l-normalized), m the row's max scaled logit and l =
    Σ exp(s − m), both [b, h, 1] fp32; a row with no valid key gives
    (0, BIG_NEG, 0)."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, mask, kv_len, k_scale, v_scale, scale=scale,
                                  return_partials=return_partials)
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
    part = torch.empty((b, h, -(-T // SPLIT_KEYS), d + 2), dtype=torch.float32, device=q.device)
    m = l = None
    if return_partials:
        m = torch.empty((b, h, 1), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    lib = _build.load()
    rc = lib.lwm_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
        mask.data_ptr(), out.data_ptr(),
        None if m is None else m.data_ptr(), None if l is None else l.data_ptr(),
        part.data_ptr(),
        b, h, h_kv, T, d, max(min(int(kv_len), T), 0), int(quant), SPLIT_KEYS,
        q.stride(0), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        float(scale), _build.stream_handle(q.device),
    )
    _build.check(rc, "lwm_flash_decode")
    flash_decode.launches += 1
    return out if m is None else (out, m, l)


flash_decode.launches = 0
