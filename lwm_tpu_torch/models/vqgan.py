"""VQGAN, the image and video tokenizer, in PyTorch.

Counterpart of `lwm_tpu/models/vqgan.py`: 256 x 256 RGB frames in [-1, 1]
encode to 16 x 16 grids of codebook indices (8192 codes of dim 64) and
decode back; a 5-D input [b, t, ...] folds time into the batch. The API is
the JAX one's, channels last: pixels [.., 256, 256, 3] in, (quantized
[.., 16, 16, 64], indices [.., 16, 16]) out. Inside, the convolutions run
on NCHW (`nn.Conv2d`, cuDNN on the card).

The submodules carry the flax auto-names (`Conv_0`, `GroupNorm_1`,
`ResnetBlock_2`, ...) in the flax creation order, so that the released
param tree (`tests/fixtures/vqgan_released_tree.json`) maps onto the state
dict name for name (`utils.convert.vqgan_params_from_flax`). Two names are
not where a reader expects them: a ResnetBlock's channel-changing shortcut
is `Conv_2`, created after its two 3 x 3 convs (`:269-276`), and the
decoder's `UpsamplingBlock_0` is the deepest level, created first by the
reversed loop (`:214-215`).

What the reference computes and the port copies:
- flax `nn.Conv` pads a 3 x 3 conv SAME (1 each side); `Downsample` pads
  the bottom and right by 1 only and runs a VALID 3 x 3 stride-2 conv
  (`:302-303`), or a 2 x 2 average pool without the conv;
- `Upsample` is a nearest 2x resize (`jax.image.resize`), which at an
  exact 2x is `F.interpolate(mode="nearest")`;
- flax `nn.GroupNorm`: 32 groups, eps 1e-6, the variance as E[x²] −
  E[x]² (`GroupNorm`; torch's two-pass variance moved the objective's
  gradients by ~1e-5 of their largest element);
- the quantizer takes argmin ||z||^2 + ||e||^2 - 2<z, e> over the codebook
  (the first index on a tie) and returns the straight-through z + sg(e -
  z); `return_raw` also returns the lookup e itself (the codebook loss needs
  it, `:249-254`); decode clips to [-1, 1].

Precision: the reference computes at fp32, and the codes' argmin turns on
the last digits of the distances. cuDNN runs fp32 convolutions as TF32 by
default, so every forward here runs under `full_fp32()`: TF32 off for
cuDNN and for matmuls, set for the call and restored after it, never
flipped globally.

`VQGAN` is the JAX wrapper's counterpart (`:29-82`): it reads the released
pickle (`utils.convert.load_vqgan_pickle`) onto the card unless the caller
names another device. `replicate=True` (the JAX wrapper's pmap over local
devices) raises: multi-GPU is ROADMAP A4.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

GROUPS, GROUP_EPS = 32, 1e-6   # flax nn.GroupNorm's defaults


@dataclass
class VQGANConfig:
    """`lwm_tpu/models/vqgan.py:85-130`: the defaults are the released
    architecture (256 x 256, hidden 128, channel_mult (1, 2, 2, 4, 6), 2 res
    blocks, no attention, z 64, 8192 codes of dim 64)."""

    resolution: int = 256
    num_channels: int = 3
    hidden_channels: int = 128
    channel_mult: tuple = (1, 2, 2, 4, 6)
    num_res_blocks: int = 2
    attn_resolutions: tuple = ()
    no_attn_mid_block: bool = True
    z_channels: int = 64
    num_embeddings: int = 8192
    quantized_embed_dim: int = 64
    dropout: float = 0.0
    resample_with_conv: bool = True
    commitment_cost: float = 0.25

    def __post_init__(self):
        self.channel_mult = tuple(self.channel_mult)
        self.attn_resolutions = tuple(self.attn_resolutions)

    @property
    def num_resolutions(self):
        return len(self.channel_mult)

    @classmethod
    def get_default_config(cls, updates=None):
        """The released config with `updates` (a dict) over it."""
        config = cls()
        return dataclasses.replace(config, **(updates or {}))


@contextlib.contextmanager
def full_fp32():
    """fp32 convolutions and matmuls without TF32 for the duration (cuDNN's
    flag through its own context, the matmul flag saved and restored)."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


def _conv(cin, cout, k, device, stride=1, same=True):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2 if same else 0, device=device)


class GroupNorm(nn.Module):
    """flax `nn.GroupNorm` as 0.12.3 computes it (`normalization.py`
    `_compute_stats`, `_normalize`): 32 groups, var = max(0, E[x²] −
    E[x]²) (its `use_fast_variance`), y = (x − mean) · (rsqrt(var + 1e-6) ·
    scale) + bias; `weight` is flax's `scale`. On NCHW."""

    def __init__(self, c, device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))

    def forward(self, x):
        b, c = x.shape[:2]
        g = x.reshape(b, GROUPS, -1)
        mean = g.mean(-1, keepdim=True)
        var = ((g * g).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + GROUP_EPS).repeat_interleave(c // GROUPS, 1)
        mean = mean.repeat_interleave(c // GROUPS, 1)
        shape = (b, c) + (1,) * (x.dim() - 2)
        mul = mul.reshape(shape) * self.weight.reshape(1, c, *shape[2:])
        return (x - mean.reshape(shape)) * mul + self.bias.reshape(1, c, *shape[2:])


def _norm(c, device):
    return GroupNorm(c, device)


class ResnetBlock(nn.Module):
    """`:258-277`; the shortcut is a 1 x 1 `Conv_2` where the width changes."""

    def __init__(self, cin, cout, device):
        super().__init__()
        self.GroupNorm_0 = _norm(cin, device)
        self.Conv_0 = _conv(cin, cout, 3, device)
        self.GroupNorm_1 = _norm(cout, device)
        self.Conv_1 = _conv(cout, cout, 3, device)
        self.Conv_2 = _conv(cin, cout, 1, device) if cin != cout else None

    def forward(self, x):
        h = self.Conv_0(F.silu(self.GroupNorm_0(x)))
        h = self.Conv_1(F.silu(self.GroupNorm_1(h)))   # dropout 0: deterministic
        return h + (x if self.Conv_2 is None else self.Conv_2(x))


class AttnBlock(nn.Module):
    """`:280-293`: one head over the h x w positions, 1 x 1 q/k/v/out convs."""

    def __init__(self, c, device):
        super().__init__()
        self.GroupNorm_0 = _norm(c, device)
        self.Conv_0, self.Conv_1, self.Conv_2, self.Conv_3 = (
            _conv(c, c, 1, device) for _ in range(4))

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.GroupNorm_0(x)
        q, k, v = (conv(h).reshape(b, c, hh * ww) for conv in (self.Conv_0, self.Conv_1,
                                                                 self.Conv_2))
        w = torch.softmax(torch.einsum("bdq,bdk->bqk", q, k) * c ** -0.5, -1)
        out = torch.einsum("bqk,bdk->bdq", w, v).reshape(b, c, hh, ww)
        return self.Conv_3(out) + x


class Downsample(nn.Module):
    """`:296-306`: pad bottom/right by 1 and a VALID 3 x 3 stride-2 conv, or
    a 2 x 2 average pool."""

    def __init__(self, c, with_conv, device):
        super().__init__()
        self.Conv_0 = _conv(c, c, 3, device, stride=2, same=False) if with_conv else None

    def forward(self, x):
        if self.Conv_0 is None:
            return F.avg_pool2d(x, 2, 2)
        return self.Conv_0(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """`:309-318`: nearest 2x, then a 3 x 3 conv."""

    def __init__(self, c, with_conv, device):
        super().__init__()
        self.Conv_0 = _conv(c, c, 3, device) if with_conv else None

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return x if self.Conv_0 is None else self.Conv_0(x)


def _level(block, cfg, idx, cin, n_res, device):
    """A Down/UpsamplingBlock's res blocks and attention blocks, named in
    the flax order; returns the level's width."""
    cout = cfg.hidden_channels * cfg.channel_mult[idx]
    attn = cfg.resolution // 2 ** idx in cfg.attn_resolutions
    for i in range(n_res):
        setattr(block, f"ResnetBlock_{i}", ResnetBlock(cin, cout, device))
        if attn:
            setattr(block, f"AttnBlock_{i}", AttnBlock(cout, device))
        cin = cout
    block.n_res, block.attn = n_res, attn
    return cout


def _run_level(block, x):
    for i in range(block.n_res):
        x = getattr(block, f"ResnetBlock_{i}")(x)
        if block.attn:
            x = getattr(block, f"AttnBlock_{i}")(x)
    return x


class DownsamplingBlock(nn.Module):
    """`:321-335`."""

    def __init__(self, cfg, idx, cin, device):
        super().__init__()
        self.cout = _level(self, cfg, idx, cin, cfg.num_res_blocks, device)
        self.Downsample_0 = (Downsample(self.cout, cfg.resample_with_conv, device)
                             if idx != cfg.num_resolutions - 1 else None)

    def forward(self, x):
        x = _run_level(self, x)
        return x if self.Downsample_0 is None else self.Downsample_0(x)


class UpsamplingBlock(nn.Module):
    """`:338-352`: one res block more than a downsampling level."""

    def __init__(self, cfg, idx, cin, device):
        super().__init__()
        self.cout = _level(self, cfg, idx, cin, cfg.num_res_blocks + 1, device)
        self.Upsample_0 = Upsample(self.cout, cfg.resample_with_conv, device) if idx else None

    def forward(self, x):
        x = _run_level(self, x)
        return x if self.Upsample_0 is None else self.Upsample_0(x)


class MidBlock(nn.Module):
    """`:355-365`."""

    def __init__(self, c, no_attn, device):
        super().__init__()
        self.ResnetBlock_0 = ResnetBlock(c, c, device)
        self.AttnBlock_0 = None if no_attn else AttnBlock(c, device)
        self.ResnetBlock_1 = ResnetBlock(c, c, device)

    def forward(self, x):
        x = self.ResnetBlock_0(x)
        if self.AttnBlock_0 is not None:
            x = self.AttnBlock_0(x)
        return self.ResnetBlock_1(x)


class Encoder(nn.Module):
    """`:186-201`: NCHW pixels → NCHW z."""

    def __init__(self, cfg, device):
        super().__init__()
        self.resolution = cfg.resolution
        self.Conv_0 = _conv(cfg.num_channels, cfg.hidden_channels, 3, device)
        c = cfg.hidden_channels
        for i in range(cfg.num_resolutions):
            block = DownsamplingBlock(cfg, i, c, device)
            setattr(self, f"DownsamplingBlock_{i}", block)
            c = block.cout
        self.MidBlock_0 = MidBlock(c, cfg.no_attn_mid_block, device)
        self.GroupNorm_0 = _norm(c, device)
        self.Conv_1 = _conv(c, cfg.z_channels, 3, device)
        self.levels = cfg.num_resolutions

    def forward(self, x):
        if x.shape[2] != self.resolution or x.shape[3] != self.resolution:
            raise ValueError(f"pixels {tuple(x.shape)}: want {self.resolution} x "
                             f"{self.resolution} frames")
        h = self.Conv_0(x)
        for i in range(self.levels):
            h = getattr(self, f"DownsamplingBlock_{i}")(h)
        h = self.MidBlock_0(h)
        return self.Conv_1(F.silu(self.GroupNorm_0(h)))


class Decoder(nn.Module):
    """`:204-218`; `UpsamplingBlock_k` is level num_resolutions - 1 - k."""

    def __init__(self, cfg, device):
        super().__init__()
        c = cfg.hidden_channels * cfg.channel_mult[-1]
        self.Conv_0 = _conv(cfg.z_channels, c, 3, device)
        self.MidBlock_0 = MidBlock(c, cfg.no_attn_mid_block, device)
        for k, idx in enumerate(reversed(range(cfg.num_resolutions))):
            block = UpsamplingBlock(cfg, idx, c, device)
            setattr(self, f"UpsamplingBlock_{k}", block)
            c = block.cout
        self.GroupNorm_0 = _norm(c, device)
        self.Conv_1 = _conv(c, cfg.num_channels, 3, device)
        self.levels = cfg.num_resolutions

    def forward(self, h):
        h = self.MidBlock_0(self.Conv_0(h))
        for k in range(self.levels):
            h = getattr(self, f"UpsamplingBlock_{k}")(h)
        return self.Conv_1(F.silu(self.GroupNorm_0(h)))


class VectorQuantizer(nn.Module):
    """`:221-255`, channels last: z [..., e_dim]."""

    def __init__(self, n_e, e_dim, device):
        super().__init__()
        self.embeddings = nn.Parameter(torch.empty(n_e, e_dim, device=device))

    def lookup(self, indices):
        """The codebook rows of `indices`; an index past the codebook (a
        vision special the sampler drew, 8192-8447) reads the last row, as
        JAX's gather clamps it (`embeddings[(indices,)]`, `:235-236`)."""
        return F.embedding(indices.long().clamp(0, self.embeddings.shape[0] - 1),
                           self.embeddings)

    def forward(self, z, return_raw=False):
        """(z_q = z + sg(e - z), indices [...]) and with `return_raw` also
        the lookup e, all channels last."""
        e = self.embeddings
        flat = z.reshape(-1, z.shape[-1])
        d = ((flat ** 2).sum(1, keepdim=True) + (e ** 2).sum(1)[None, :]
             - 2.0 * torch.einsum("bd,nd->bn", flat, e))
        indices = d.argmin(1)   # the first index of equal distances
        z_q_raw = F.embedding(indices, e).reshape(z.shape)
        z_q = z + (z_q_raw - z).detach()
        indices = indices.reshape(z.shape[:-1])
        return (z_q, indices, z_q_raw) if return_raw else (z_q, indices)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _fold_time(x, frame_dims):
    """[b, t, *frame] → ([b·t, *frame], t); a frame batch passes as (x, None)."""
    if x.dim() == frame_dims + 2:
        return x.reshape(-1, *x.shape[2:]), x.shape[1]
    return x, None


def _unfold(x, t):
    return x if t is None else x.reshape(-1, t, *x.shape[1:])


class VQGANModel(nn.Module):
    """`lwm_tpu/models/vqgan.py:133-183` on `device`: the card unless the
    caller names another ("cpu", or "meta" to load a state dict onto)."""

    def __init__(self, config=None, device="cuda"):
        super().__init__()
        if device is not None and torch.device(device).type == "cuda" and \
                not torch.cuda.is_available():
            raise RuntimeError("VQGANModel is built on the card by default and CUDA is not "
                               "available: pass device='cpu' (or 'meta')")
        cfg = self.config = config or VQGANConfig()
        self.encoder = Encoder(cfg, device)
        self.decoder = Decoder(cfg, device)
        self.quantize = VectorQuantizer(cfg.num_embeddings, cfg.quantized_embed_dim, device)
        self.quant_conv = _conv(cfg.z_channels, cfg.quantized_embed_dim, 1, device)
        self.post_quant_conv = _conv(cfg.quantized_embed_dim, cfg.z_channels, 1, device)

    @torch.no_grad()
    def init_weights(self, generator):
        """Random weights from `generator` in the released layout: conv
        kernels lecun-normal (flax's default), biases 0, norm scales 1, the
        codebook uniform in ±1/n_e (`:227-234`)."""
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.weight[0].numel()
                mod.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
                mod.bias.zero_()
            elif isinstance(mod, GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        n_e = self.config.num_embeddings
        self.quantize.embeddings.uniform_(-1.0 / n_e, 1.0 / n_e, generator=generator)

    def _z(self, pixels):
        """Frames [n, H, W, C] → z [n, h, w, e_dim] before quantizing."""
        return _nhwc(self.quant_conv(self.encoder(_nchw(pixels))))

    def _pixels(self, z_q):
        """z_q [n, h, w, e_dim] → pixels [n, H, W, C], not clipped."""
        return _nhwc(self.decoder(self.post_quant_conv(_nchw(z_q))))

    def encode(self, pixel_values):
        """pixels [b, H, W, C] or [b, t, H, W, C] → (quantized [.., h, w,
        e_dim], indices [.., h, w])."""
        with full_fp32():
            x, t = _fold_time(pixel_values, 3)
            z_q, indices = self.quantize(self._z(x))
            return _unfold(z_q, t), _unfold(indices, t)

    def decode(self, encoding, is_codebook_indices=True):
        """indices [b, h, w] or [b, t, h, w] (or quantized vectors with
        `is_codebook_indices=False`) → pixels [.., H, W, C] in [-1, 1]."""
        with full_fp32():
            if is_codebook_indices:
                encoding = self.quantize.lookup(encoding)
            z_q, t = _fold_time(encoding, 3)
            return _unfold(self._pixels(z_q), t).clamp(-1, 1)

    def train_forward(self, pixel_values):
        """`:170-180`: (recon before the clip, z, z_q_raw, indices), time
        folded into the batch, for the objective recon + ||sg(z) - e||^2 +
        beta ||z - sg(e)||^2."""
        with full_fp32():
            x, _ = _fold_time(pixel_values, 3)
            z = self._z(x)
            z_q, indices, z_q_raw = self.quantize(z, return_raw=True)
            return self._pixels(z_q), z, z_q_raw, indices

    def forward(self, pixel_values):
        return self.decode(self.encode(pixel_values)[1])


class VQGAN:
    """The JAX `VQGAN` wrapper (`:29-82`): the released pickle's params on
    `device` (the card by default), `encode` and `decode` without autograd.
    Inputs may be numpy arrays or tensors; outputs are tensors on `device`."""

    def __init__(self, vqgan_checkpoint, replicate=False, config_updates=None, device="cuda"):
        from lwm_tpu_torch.utils.convert import load_vqgan_pickle, vqgan_params_from_flax

        if not vqgan_checkpoint:
            raise ValueError("VQGAN needs a checkpoint: --vqgan_checkpoint=PATH")
        if replicate:
            raise NotImplementedError("VQGAN(replicate=True) maps encode/decode over every local "
                                      "device; the port runs on one (multi-GPU is ROADMAP A4)")
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("VQGAN runs on the card by default and CUDA is not available: "
                               "pass device='cpu'")
        self.config = VQGANConfig.get_default_config(config_updates)
        self.device = torch.device(device)
        self.model = VQGANModel(self.config, device="meta")
        sd = vqgan_params_from_flax(load_vqgan_pickle(vqgan_checkpoint), self.config)
        self.model.load_state_dict({k: v.to(self.device) for k, v in sd.items()}, assign=True)
        self.model.eval()

    @classmethod
    def from_model(cls, model):
        """The wrapper around a `VQGANModel` already built, on its device."""
        self = cls.__new__(cls)
        self.config, self.model = model.config, model.eval()
        self.device = next(model.parameters()).device
        return self

    def _in(self, x, dtype):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               device=self.device).to(dtype)

    @torch.no_grad()
    def encode(self, pixel_values):
        """pixels [b, 256, 256, 3] or [b, t, 256, 256, 3] in [-1, 1] →
        (quantized [.., 16, 16, 64], indices [.., 16, 16])."""
        return self.model.encode(self._in(pixel_values, torch.float32))

    @torch.no_grad()
    def decode(self, encoding):
        """codebook indices [.., 16, 16] → pixels [.., 256, 256, 3]."""
        return self.model.decode(self._in(encoding, torch.long))
