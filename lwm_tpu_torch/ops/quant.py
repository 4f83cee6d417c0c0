"""Int8 weights for serving: K5 (W8A16 dequant matmul) and K6 (W8A8 int8
matmul), the quantizers and the state-dict converter.

Counterpart of `lwm_tpu/ops/quant.py`. Dense weights are stored as int8 with
one fp32 scale per OUTPUT channel; the scale commutes past the contraction,
so `x @ (q * s)ᵀ == (x @ qᵀ) * s` and dequantization is one multiply on the
product, never a bf16 copy of the weight. The port keeps torch's [out, in]
layout: a weight is int8 [f, d], its scale fp32 [f] (the flax kernel is
[d, f]; `utils/convert.py` transposes it).

- `int8_matmul` (K5, replaces `_int8_matmul_kernel`, `quant.py:107-122`):
  y = (x · bf16(w)ᵀ accumulated in fp32) · scale, rounded to x's type once.
  CUDA: `csrc/int8_matmul.cu` (a GEMV for decode, m ≤ the library's
  `lwm_int8_gemv_max_m()`, and a `wgmma` GEMM for admission above it; the
  latter's launches are also counted in `.gemm_launches`); twin
  `int8_matmul_plain`.
- `w8a8_matmul_quantized` (K6, replaces `_w8a8_matmul_kernel`,
  `quant.py:182-202`): int8 x_q · int8 wᵀ summed exactly in int32, then
  (float(acc) · x_scale) · w_scale. CUDA: `csrc/w8a8_matmul.cu` (a GEMV for
  decode, m ≤ `lwm_w8a8_gemv_max_m()`, and an int8 `wgmma` GEMM above it,
  counted also in `.gemm_launches`); twin `w8a8_matmul_plain` (fp64 sums,
  exact since d·127² < 2⁵³), bit-identical.
  `w8a8_matmul` quantizes the activations per row (plain PyTorch, as the
  JAX package leaves it to XLA outside the kernel) and launches K6.
- `int8_matmul_dequant`: the JAX `int8_matmul_xla` math, the explicit
  `int8_xla` spelling; never chosen by default (JAX's `auto → xla` was a
  TPU measurement and is not carried over).

Each kernel wrapper runs its twin for CPU tensors, launches its kernel for
CUDA tensors (counting the launch in `.launches`) or raises. The TPU block
picks (`_block`, `_gemv_blocks`) are not ported: each CUDA kernel picks its
own tiles and masks ragged edges.
"""

from __future__ import annotations

import functools

import torch

from lwm_tpu_torch.ops import _build

# dense-weight names eligible for weight-only quantization (`quant.py:73-75`)
QUANT_TARGETS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "lm_head", "vision_head")
# logits heads keep full-precision activations under w8a8 (`quant.py:81`)
W8A8_EXCLUDE = ("lm_head", "vision_head")
# the int32 sum of K6 is exact for d·127² < 2³¹
W8A8_MAX_D = (2**31 - 1) // (127 * 127)


def quantize_weight(w):
    """Symmetric per-output-channel int8 of an [out, in] (or stacked
    [..., out, in]) weight: (q int8, scale fp32 [..., out]) with
    w ≈ q · scale[..., None]. `quantize_weight` of `lwm_tpu/ops/quant.py:84-90`
    on the transposed layout: amax over the input dim, round half to even."""
    w32 = w.float()
    scale = torch.clamp_min(w32.abs().amax(-1) / 127.0, 1e-12)
    q = torch.round(w32 / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def quantize_activations(x):
    """Dynamic symmetric per-row int8 in fp32 (`quant.py:247-253`): x [m, d]
    → (x_q int8 [m, d], scale fp32 [m, 1])."""
    x32 = x.float()
    scale = torch.clamp_min(x32.abs().amax(-1, keepdim=True) / 127.0, 1e-12)
    x_q = torch.round(x32 / scale).clamp(-127, 127).to(torch.int8)
    return x_q, scale


def int8_matmul_plain(x, w, scale):
    """K5's arithmetic in plain PyTorch: x [m, d] (bf16 or fp32), w int8
    [f, d], scale fp32 [f] → [m, f] in x.dtype; fp32 product, fp32 scale,
    one rounding."""
    return ((x.float() @ w.float().T) * scale.float()).to(x.dtype)


def w8a8_matmul_plain(x_q, x_scale, w, w_scale, *, out_dtype):
    """K6's arithmetic in plain PyTorch: int8 x_q [m, d] (row scale fp32
    [m, 1]) · int8 w [f, d] (column scale fp32 [f]) → [m, f] out_dtype. The
    sums are exact in fp64, so this equals the int32 kernel bit for bit."""
    acc = (x_q.double() @ w.double().T).float()
    return (acc * x_scale.float() * w_scale.float()[None, :]).to(out_dtype)


def int8_matmul_dequant(x, w, scale):
    """`int8_matmul_xla` (`quant.py:177-179`): (x @ w.to(x.dtype)ᵀ) ·
    scale.to(x.dtype), over any leading dims of x."""
    return torch.nn.functional.linear(x, w.to(x.dtype)) * scale.to(x.dtype)


def _check_weight(name, x, w, scale):
    """Raise on what the kernels do not take (x is [m, d])."""
    for t in (w, scale):
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on different devices: {x.device}, {t.device}")
    if x.ndim != 2 or w.ndim != 2 or w.shape[1] != x.shape[1] or scale.shape != (w.shape[0],):
        raise ValueError(
            f"{name}: bad shapes x {tuple(x.shape)} w {tuple(w.shape)} scale {tuple(scale.shape)}"
        )
    if w.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"{name}: takes int8 w and fp32 scale, got {w.dtype}/{scale.dtype}")
    if x.shape[1] % 16:
        raise ValueError(f"{name}: d = {x.shape[1]} must be a multiple of 16 (16-byte rows)")
    for t in (x, w, scale):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous and 16-byte aligned")


def _on_cuda(name, x):
    if x.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {x.device}")


@functools.cache
def _gemv_max_m(entry):
    """The largest m a kernel's C dispatch gives its decode GEMV (the
    admission GEMM takes every larger m): one constant, read from the
    library's `entry`."""
    return getattr(_build.load(), entry)()


def int8_matmul(x, w, scale):
    """K5: x [m, d] @ int8 w [f, d]ᵀ, × per-output-channel fp32 scale [f]
    → [m, f] in x.dtype (the kernel takes bf16 x; the CPU twin also fp32).
    Counts every launch in `.launches`, and those of the admission GEMM
    (m above the GEMV's range) also in `.gemm_launches`."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w, scale)
    _on_cuda("int8_matmul", x)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"int8_matmul kernel takes bf16 x, got {x.dtype}")
    _check_weight("int8_matmul", x, w, scale)
    (m, d), f = x.shape, w.shape[0]
    out = torch.empty((m, f), dtype=x.dtype, device=x.device)
    if m == 0 or f == 0:
        return out
    rc = _build.load().lwm_int8_matmul(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(), m, f, d,
        _build.stream_handle(x.device),
    )
    _build.check(rc, "lwm_int8_matmul")
    int8_matmul.launches += 1
    if m > _gemv_max_m("lwm_int8_gemv_max_m"):
        int8_matmul.gemm_launches += 1
    return out


def w8a8_matmul_quantized(x_q, x_scale, w, w_scale, *, out_dtype):
    """K6: int8 x_q [m, d] (fp32 row scale [m, 1]) @ int8 w [f, d]ᵀ (fp32
    column scale [f]) → [m, f] out_dtype (bf16 for the kernel). Counts every
    launch in `.launches`, and those of the admission GEMM (m above the
    GEMV's range) also in `.gemm_launches`."""
    if x_q.device.type == "cpu":
        return w8a8_matmul_plain(x_q, x_scale, w, w_scale, out_dtype=out_dtype)
    _on_cuda("w8a8_matmul", x_q)
    if x_q.dtype != torch.int8 or out_dtype != torch.bfloat16:
        raise TypeError(f"w8a8_matmul kernel takes int8 x_q into bf16, got {x_q.dtype}/{out_dtype}")
    _check_weight("w8a8_matmul", x_q, w, w_scale)
    (m, d), f = x_q.shape, w.shape[0]
    if d > W8A8_MAX_D:
        raise ValueError(f"w8a8_matmul: d = {d} would overflow the int32 sum")
    if (x_scale.shape != (m, 1) or x_scale.dtype != torch.float32
            or not x_scale.is_contiguous() or x_scale.device != x_q.device):
        raise ValueError(f"w8a8_matmul: x_scale must be contiguous fp32 [{m}, 1] beside x_q")
    out = torch.empty((m, f), dtype=out_dtype, device=x_q.device)
    if m == 0 or f == 0:
        return out
    rc = _build.load().lwm_w8a8_matmul(
        x_q.data_ptr(), x_scale.data_ptr(), w.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
        m, f, d, _build.stream_handle(x_q.device),
    )
    _build.check(rc, "lwm_w8a8_matmul")
    w8a8_matmul_quantized.launches += 1
    if m > _gemv_max_m("lwm_w8a8_gemv_max_m"):
        w8a8_matmul_quantized.gemm_launches += 1
    return out


def w8a8_matmul(x, w, w_scale):
    """x [..., d] @ int8 w [f, d]ᵀ with dynamic per-row activation quant
    (`quant.py:256-265`): quantize x, run K6, dequantize by row scale ×
    column scale. Returns [..., f] in x.dtype."""
    lead, d = x.shape[:-1], x.shape[-1]
    x_q, x_scale = quantize_activations(x.reshape(-1, d))
    y = w8a8_matmul_quantized(x_q, x_scale, w, w_scale, out_dtype=x.dtype)
    return y.reshape(*lead, w.shape[0])


int8_matmul.launches = 0
int8_matmul.gemm_launches = 0
w8a8_matmul_quantized.launches = 0
w8a8_matmul_quantized.gemm_launches = 0


def quantize_params_int8(state_dict, targets=QUANT_TARGETS):
    """The port's state dict with every `<name>.weight` whose module name is
    in `targets` replaced by its int8 weight plus a sibling `<name>.scale`
    (`quantize_params_int8`, `quant.py:340-362`). The result loads into a
    model built with `quant_dense` set. Tensors stay on their device."""
    out = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        if len(parts) >= 2 and parts[-1] == "weight" and parts[-2] in targets:
            prefix = key[: -len("weight")]
            out[key], out[prefix + "scale"] = quantize_weight(value)
        else:
            out[key] = value
    return out
