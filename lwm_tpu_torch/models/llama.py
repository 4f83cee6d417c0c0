"""LWM-Text (LLaMA architecture) in PyTorch: the serving and training
forwards, on one device or a mesh.

Counterpart of `lwm_tpu/models/llama.py`; each piece names its JAX source.
Parameter names mirror the flax tree (`wte`, `h.{i}.attention.wq/wk/wv/wo`,
`h.{i}.feed_forward.w1/w2/w3`, `attention_norm`, `ffn_norm`, `ln_f`,
`lm_head`); dense weights are stored in torch's [out, in] layout
(`utils/convert.py` transposes flax's [in, out] kernels).

Weights live in `param_dtype` and every product runs in `dtype`, as flax
`nn.Dense(dtype, param_dtype)` casts: the JAX train step keeps fp32 params
and computes in bf16 (`lwm_tpu/train.py:187-189`), so each weight is cast
to bf16 at use, the residual stream and the logits are bf16. The serving
CLI casts params to the model dtype at load (`lwm_tpu/apps/serve.py:
140-144`): there `param_dtype` defaults to `dtype` and the casts are no-ops.

Attention (`attn_impl`):
- "auto": the port's kernels. Decode (q = 1 over a cache) → K4
  `ops.decode.flash_decode`; a forward over a cache → K1
  `ops.flash.flash_attention_fwd` (causal, q_offset = kv_len − q); a forward
  without a cache (training, `_ring_train`'s single-device branch) →
  `ops.ring.flash_attention`, K1 forward and the fused backward, with the JAX
  per-key bias (`finfo(dtype).min` on padded keys, `llama.py:1114-1119`).
  On CPU tensors those wrappers run their plain twins.
- "plain": full-materialization attention (`ops.reference`), the twin of
  the JAX `"xla"` path (`llama.py:948-988`); differentiable by autograd.
The JAX config's spellings load as the port's (`JAX_ATTN_IMPL`): "xla" →
"plain", "pallas" (its kernels, `llama.py:837`) → "auto".

Training: `forward` and `forward_hidden` build an autograd graph when called
without a cache (with a cache they run under `torch.no_grad()`). Blocks are
rematerialized by `torch.utils.checkpoint` per `remat_block`
(`llama.py:1362-1394`): "none"; "nothing_saveable" (the backward replays the
whole block, K1 included); "save_flash" (selective checkpointing keeps K1's
(out, lse): `ops.ring.save_flash_policy`). With `scan_mlp` the feed-forward
runs in rematerialized sequence chunks (`llama.py:1308-1329`).

Int8 weights (`quant_dense`, serving only; `lwm_tpu/models/llama.py:376-399`):
every dense product becomes an `Int8Dense` holding an int8 [out, in] weight
and an fp32 per-output-channel scale (`ops.quant.quantize_params_int8` makes
them from a bf16/fp32 state dict). "int8" → K5 `ops.quant.int8_matmul`;
"int8_w8a8" → K6 `ops.quant.w8a8_matmul` (per-row activation quant), with
the logits head on K5 (`W8A8_EXCLUDE`); "int8_xla" → the dequant matmul
`int8_matmul_dequant`, never chosen by default. A tied head stays the
embedding's product.

The model is built on the card unless the caller names another device
(`device="cpu"` in the tests); `on_tensors` builds one on given tensors.

Shared-prefix serving (`prefix_len`, `prefix_tokens`): a cache from
`init_cache` carries a frozen batch-1 prefix block a layer; decode reads it
through `ops.prefix.decode_with_prefix` (two K4 calls a layer), a forward of
q > 1 tokens through K1 without causality, merged by `combine_lse`, and
"plain" concatenates [prefix ++ suffix] (the JAX oracle).

Subclasses supply the embeddings and the logits through `_embed` and
`_head` (`models/vision_llama.py`: the vision embedding mix and its heads);
the blocks, caches and prefix machinery are shared.

Segment ids (`segment_ids` [b, s], packed documents) keep a logit only
where the query's and the key's ids are equal, in K1 and the fused backward
(JAX: `flash_attention(segment_ids=)`, `llama.py:725-733`).

On a mesh (`model.mesh`, a `parallel.mesh.Mesh` the trainer sets) the
training forward takes this rank's rows and its slice of the sequence
(`input_ids` [b_local, s_local]) and, when sp > 1, runs attention through
`ops.ring.ring_attention` over the mesh's sp group (`_ring_train`,
`llama.py:687-776`): position ids are global (rank i's slot r holds
position i·s_local + r contiguous, i + r·sp striped), the per-key bias comes
from the whole sequence's attention mask and the segment ids from the
whole sequence's (each gathered over sp when given). On a tp mesh (the
model built with `mesh=`) the blocks run on the rank's heads and features
between `parallel.mesh.TPEntry` and `TPExit`, and the vocab-split head's
logits are gathered (`GatherLast`); `parallel.fsdp.shard_model` (the
trainer's `create_train_state`) splits the weights over fsdp × sp, each
block gathering its own as its forward starts.

Inference on a mesh (`LLaMAForCausalLM(config, mesh=mesh)`, or `on_tensors`
with this rank's slices from `parallel.partition`): each rank holds its tp
slice of the weights, so attention runs on its h/tp query and h_kv/tp kv
heads and the MLP on its f/tp features, one all-reduce after wo and one
after w2 (in fp32), and the vocab-split logits are gathered over tp. Rows
(the server's slots, generate's batch) are split over dp × fsdp by the
caller: every [b, ...] argument is this rank's rows, every other argument
whole. The cache a rank holds is [b_local, h_kv/tp, T/sp, d] (int8 scales
[b_local, h_kv/tp, T/sp]) when its sequence is split over sp: the shared
index's cache (`generate`), and the server's slots under `sp_slot_caches`;
a shared-prefix model keeps its slots' caches whole and splits its prefix
block over sp instead (`ops.prefix`). Over a split cache:
- writes are routed: a token lands on the rank whose slice holds its
  position, on the shared index and per row (a verify block of q ≤ 64
  tokens unrolled a token at a time, so that a block across a shard
  boundary lands exactly: `lwm_tpu/models/llama.py:590-620`);
- attention is `ops.ring.ring_attention_inference`: K4's partials (decode)
  or K1's (out, lse) over the local keys (a prefill: causal by global
  position, the mask as K1's per-key or full-tile bias), merged over sp;
- the query block is split over sp when its length divides (each rank runs
  its rows through the layers and attention gathers them), else every rank
  runs all of it (`lwm_tpu/models/llama.py:985-1018`); the final hidden
  states are gathered over sp, so every rank returns the whole block's
  logits.

Not in this slice: dropout (`*_pdrop` > 0 raise in training).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from lwm_tpu_torch.ops.decode import flash_decode
from lwm_tpu_torch.ops.flash import flash_attention_fwd
from lwm_tpu_torch.ops.prefix import combine_lse, combine_raw_partials, decode_with_prefix
from lwm_tpu_torch.ops.quant import (
    W8A8_EXCLUDE, int8_matmul, int8_matmul_dequant, w8a8_matmul,
)
from lwm_tpu_torch.ops.reference import BIG_NEG, reference_attention
from lwm_tpu_torch.ops.ring import (
    flash_attention, local_kv_len, lse_partials, merge_partials, ring_attention,
    ring_attention_inference, save_flash_policy,
)
from lwm_tpu_torch.parallel.fsdp import full_weight, gather_weights, placements
from lwm_tpu_torch.parallel.mesh import gather_tp, mesh_of, tp_enter, tp_exit
from lwm_tpu_torch.parallel.partition import check_tp

REMAT_BLOCKS = ("none", "nothing_saveable", "save_flash")
# quant_dense spelling → Int8Dense impl (`lwm_tpu/models/llama.py:385-396`)
QUANT_DENSE = {"int8": "auto", "int8_xla": "xla", "int8_w8a8": "w8a8"}

# Public LLaMA/LWM model dimensions (lwm_tpu/models/llama.py:52-85).
LLAMA_STANDARD_CONFIGS = {
    "200m": dict(vocab_size=32000, hidden_size=1024, intermediate_size=2048,
                 num_hidden_layers=14, num_attention_heads=8,
                 max_sequence_length=2048, initializer_range=0.02,
                 rms_norm_eps=1e-6, use_cache=True, tie_word_embeddings=False),
    "1b": dict(vocab_size=32000, hidden_size=2048, intermediate_size=5504,
               num_hidden_layers=22, num_attention_heads=16,
               max_sequence_length=2048, initializer_range=0.02,
               rms_norm_eps=1e-6, use_cache=True, tie_word_embeddings=False),
    "3b": dict(vocab_size=32000, hidden_size=3200, intermediate_size=8640,
               num_hidden_layers=26, num_attention_heads=32,
               max_sequence_length=2048, initializer_range=0.02,
               rms_norm_eps=1e-6, use_cache=True, tie_word_embeddings=False),
    "7b": dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
               num_hidden_layers=32, num_attention_heads=32,
               max_sequence_length=4096, initializer_range=0.02,
               rms_norm_eps=1e-6, use_cache=True, tie_word_embeddings=False),
    "13b": dict(vocab_size=32000, hidden_size=5120, intermediate_size=13824,
                num_hidden_layers=40, num_attention_heads=40,
                max_sequence_length=2048, initializer_range=0.02,
                rms_norm_eps=1e-6, use_cache=True, tie_word_embeddings=False),
    "30b": dict(vocab_size=32000, hidden_size=6656, intermediate_size=17920,
                num_hidden_layers=60, num_attention_heads=52,
                max_sequence_length=2048, initializer_range=0.02,
                rms_norm_eps=1e-6, use_cache=True, tie_word_embeddings=False),
    "65b": dict(vocab_size=32000, hidden_size=8192, intermediate_size=22016,
                num_hidden_layers=80, num_attention_heads=64,
                max_sequence_length=2048, initializer_range=0.02,
                rms_norm_eps=1e-6, use_cache=True, tie_word_embeddings=False),
    "debug": dict(vocab_size=32000, hidden_size=256, intermediate_size=256,
                  num_hidden_layers=2, num_attention_heads=2,
                  max_sequence_length=2048, initializer_range=0.02,
                  rms_norm_eps=1e-6, use_cache=True, tie_word_embeddings=False),
}


# the JAX config's attn_impl spellings → the port's
JAX_ATTN_IMPL = {"xla": "plain", "pallas": "auto"}


@dataclass
class LLaMAConfig:
    """`lwm_tpu/models/llama.py:93-302` without `PretrainedConfig` and
    without the mesh fields `mesh_dim` and `sp_layout` (the mesh is the
    model's `mesh`): same field names and defaults, so a JAX config dict or
    json loads unchanged. `sp_slot_caches` splits a per_row cache's
    sequence over sp on a mesh, as the JAX field does.

    The port's forward reads the model shape, `rms_norm_eps`, `theta`,
    `tie_word_embeddings`, `kv_cache_dtype`, `quant_dense`, `attn_impl`, `decode_index`,
    `logits_tail`, `remat_block`, `scan_mlp` and `scan_mlp_chunk_size`, and
    the dropouts (only to refuse them in training). `scan_attention` and the
    query/key chunk sizes only tune the JAX kernels' blocking (every
    forward without a cache takes the flash path here); `scan_layers` and
    `param_scan_axis` tell `utils/convert.py` how a scanned tree is
    stacked."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None
    max_sequence_length: int = 4096
    rms_norm_eps: float = 1e-6
    initializer_range: float = 0.02
    use_cache: bool = True
    bos_token_id: int = 0
    eos_token_id: int = 1
    resid_pdrop: float = 0.0
    embd_pdrop: float = 0.0
    attn_pdrop: float = 0.0
    tie_word_embeddings: bool = False
    scan_attention: bool = True
    scan_mlp: bool = True
    scan_query_chunk_size: int = 1024
    scan_key_chunk_size: int = 1024
    scan_mlp_chunk_size: int = 1024
    scan_layers: bool = True
    param_scan_axis: int = 0
    remat_block: str = "save_flash"
    kv_cache_dtype: str = "auto"   # "int8": quantized cache, fp32 scales
    quant_dense: str = "none"
    attn_impl: str = "auto"        # "auto" (kernels) | "plain"; JAX_ATTN_IMPL map to them
    decode_index: str = "shared"   # "shared" (generate's cache) | "per_row" (the server's)
    sp_slot_caches: bool = False   # per_row caches split over sp (the server's slot pool)
    prefix_len: int = 0
    prefix_tokens: int = 0
    logits_tail: int = 0
    theta: float = 10000

    def __post_init__(self):
        if self.num_key_value_heads is not None and (
            self.num_attention_heads % self.num_key_value_heads
        ):
            raise ValueError(
                f"num_key_value_heads={self.num_key_value_heads} must divide "
                f"num_attention_heads={self.num_attention_heads}"
            )
        self.attn_impl = JAX_ATTN_IMPL.get(self.attn_impl, self.attn_impl)
        if self.attn_impl not in ("auto", "plain"):
            raise ValueError(
                f"attn_impl {self.attn_impl!r}: the port has 'auto' and 'plain' (and takes "
                f"the JAX spellings {sorted(JAX_ATTN_IMPL)})"
            )
        if self.kv_cache_dtype not in ("auto", "int8"):
            raise ValueError(f"kv_cache_dtype {self.kv_cache_dtype!r}: use 'auto' or 'int8'")
        if self.quant_dense not in ("none", *QUANT_DENSE):
            raise ValueError(
                f"unknown quant_dense {self.quant_dense!r}; expected 'none' or one of "
                f"{sorted(QUANT_DENSE)}"
            )
        if self.remat_block not in REMAT_BLOCKS:
            raise NotImplementedError(
                f"remat_block {self.remat_block!r}: the port has {REMAT_BLOCKS}"
            )

    @classmethod
    def from_dict(cls, d):
        """Build from a JAX config dict; keys the port has no field for
        (mesh fields, HF bookkeeping) are dropped."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @classmethod
    def load_config(cls, path):
        """'7b' preset | 'json::/path.json' (lwm_tpu/models/llama.py:290-302)."""
        if path in LLAMA_STANDARD_CONFIGS:
            return cls.from_dict(LLAMA_STANDARD_CONFIGS[path])
        load_type, _, load_path = path.partition("::")
        if load_type == "json" and load_path:
            with open(load_path) as fin:
                return cls.from_dict(json.load(fin))
        raise ValueError(f"unsupported config load type: {path}")

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @staticmethod
    def get_weight_decay_exclusions():
        """Regexes of the flax param paths weight decay skips
        (`lwm_tpu/models/llama.py:279-280`): none."""
        return ()

    @staticmethod
    def get_frozen_param_exclusions(freeze_base):
        """Regexes of the flax param paths that still train under
        `--freeze_base` (`lwm_tpu/models/llama.py:282-284`): a VideoLLaMA's
        vision embedding and head; every other param is frozen."""
        return ("vte", "vision_head") if freeze_base else ()

    @property
    def kv_heads(self):
        return self.num_key_value_heads or self.num_attention_heads

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def round_cache_length(config, max_length, sp=None):
    """`lwm_tpu/models/llama.py:1787-1808`: on one device (`sp` None) caches
    longer than 1024 round up to a 1024 multiple; on a mesh the cache is
    split over `sp`, so it rounds to a multiple of sp·1024 from sp·1024 on,
    else of sp (the padding is never written and stays masked)."""
    del config
    if sp is None:
        if max_length > 1024:
            return int(-(-max_length // 1024) * 1024)
        return max_length
    if max_length >= sp * 1024:
        return int(-(-max_length // (sp * 1024)) * (sp * 1024))
    return int(-(-max_length // sp) * sp)


class RMSNorm(nn.Module):
    """RMS norm computed in fp32, the weight held in `param_dtype`, the
    output in `dtype` (`lwm_tpu/models/llama.py:305-321`)."""

    def __init__(self, dim, eps=1e-6, *, dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, dtype=param_dtype or dtype, device=device))

    def forward(self, x):
        x32 = x.float()
        x32 = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + self.eps)
        return (x32 * self.weight.float()).to(self.dtype)


class Dense(nn.Linear):
    """Bias-free `nn.Linear` holding its weight in `param_dtype` and
    multiplying in `dtype` (flax `nn.Dense(dtype, param_dtype)`). `weight`
    is the whole weight when the block gathered it from its shards
    (`parallel.fsdp`); a head gathers its own."""

    def __init__(self, d_in, d_out, *, dtype, param_dtype=None, device=None):
        super().__init__(d_in, d_out, bias=False, dtype=param_dtype or dtype, device=device)
        self.dtype = dtype

    def forward(self, x, weight=None):
        weight = full_weight(self) if weight is None else weight
        return F.linear(x.to(self.dtype), weight.to(self.dtype))


class Int8Dense(nn.Module):
    """Serving dense layer over an int8 weight [out, in] and an fp32 scale
    per output channel [out], both buffers (the flax `kernel`/`scale` of
    `Int8Dense`, `lwm_tpu/ops/quant.py:281-337`; filled by
    `quantize_params_int8` or the converter). `impl`: "auto" → K5, "xla" →
    the dequant matmul, "w8a8" → K6; a logits head (`W8A8_EXCLUDE`) takes
    "auto" under "w8a8", as the JAX layer does by its name."""

    def __init__(self, d_in, d_out, *, impl="auto", name=None, dtype, param_dtype=None,
                 device=None):
        super().__init__()
        del param_dtype  # the weight is int8 and the scale fp32 whatever the params are
        self.impl = "auto" if impl == "w8a8" and name in W8A8_EXCLUDE else impl
        self.dtype = dtype
        self.register_buffer("weight", torch.zeros(d_out, d_in, dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(d_out, dtype=torch.float32, device=device))

    def forward(self, x, weight=None):
        if weight is not None:
            raise NotImplementedError("int8 weights are not sharded (ROADMAP A4)")
        x = x.to(self.dtype)
        if self.impl == "xla":
            return int8_matmul_dequant(x, self.weight, self.scale)
        if self.impl == "w8a8":
            return w8a8_matmul(x, self.weight, self.scale)
        lead = x.shape[:-1]
        y = int8_matmul(x.reshape(-1, x.shape[-1]).contiguous(), self.weight, self.scale)
        return y.reshape(*lead, self.weight.shape[0])


def _dense_cls(config, name):
    """The dense layer for `name` under `config.quant_dense`
    (`lwm_tpu/models/llama.py:376-399`)."""
    if config.quant_dense == "none":
        return Dense
    return functools.partial(Int8Dense, impl=QUANT_DENSE[config.quant_dense], name=name)


class Embed(nn.Embedding):
    """`nn.Embedding` holding its table in `param_dtype`, looked up in
    `dtype` (`embed_lookup`, `lwm_tpu/models/llama.py:1444-1460`)."""

    def __init__(self, n, dim, *, dtype, param_dtype=None, device=None):
        super().__init__(n, dim, dtype=param_dtype or dtype, device=device)
        self.dtype = dtype

    def forward(self, ids):
        return F.embedding(ids, full_weight(self).to(self.dtype))


FREQS_FACTOR = 4096  # fine-table period of the factored RoPE table


def precompute_freqs(dim, end, theta=10000.0):
    """Factored RoPE table (`lwm_tpu/models/llama.py:327-349`):
    e^{i·t·f} = coarse[t // F] · fine[t % F], both factors computed in fp64
    on the host and stored as fp32 (re, im) — the components of the JAX
    complex64 table. Returns (coarse [n, dim/2, 2], fine [F, dim/2, 2])."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2)[: dim // 2].astype(np.float64) / dim))
    f = min(FREQS_FACTOR, end)
    n_coarse = (end + f - 1) // f
    coarse = np.outer(np.arange(n_coarse, dtype=np.float64) * f, freqs)
    fine = np.outer(np.arange(f, dtype=np.float64), freqs)

    def to_re_im(angle):
        z = np.exp(1j * angle).astype(np.complex64)
        return torch.from_numpy(np.stack([z.real, z.imag], -1).astype(np.float32))

    return to_re_im(coarse), to_re_im(fine)


def take_freqs(freqs, position_ids):
    """[b, s] positions → (cos, sin) [b, s, dim/2] fp32: the complex product
    coarse[t // F] · fine[t % F] in real arithmetic
    (`lwm_tpu/models/llama.py:352-359`)."""
    coarse, fine = freqs
    f = fine.shape[0]
    position_ids = position_ids.long()
    c = coarse[position_ids // f]
    w = fine[position_ids % f]
    re = c[..., 0] * w[..., 0] - c[..., 1] * w[..., 1]
    im = c[..., 0] * w[..., 1] + c[..., 1] * w[..., 0]
    return re, im


def apply_rotary(x, cos, sin):
    """Rotate interleaved pairs (x[2i], x[2i+1]) by the position's angle in
    fp32 (`lwm_tpu/models/llama.py:362-373`). x: [b, s, h, d]."""
    xr = x.float().reshape(*x.shape[:-1], -1, 2)
    x0, x1 = xr[..., 0], xr[..., 1]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def quantize_kv(x):
    """Per-(token, head) symmetric int8, scale = amax/127
    (`lwm_tpu/models/llama.py:464-472`). x [..., d] → (int8 [..., d],
    fp32 scale [...])."""
    x32 = x.float()
    scale = (x32.abs().amax(-1) / 127.0).clamp_min(1e-8)
    q = torch.round(x32 / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype):
    """`lwm_tpu/models/llama.py:474-476`."""
    return (q.float() * scale[..., None]).to(dtype)


@dataclass
class LayerCache:
    """One layer's head-major cache: k, v [S, h_kv, T, d] (model dtype, or
    int8 with k_scale/v_scale [S, h_kv, T] fp32). `prefix`: the frozen
    batch-1 shared-prefix block of a `prefix_len` model (a LayerCache of
    [1, h_kv, prefix_len, d], the JAX `prefix_key`/`prefix_value`/`*_scale`
    of `lwm_tpu/models/llama.py:507-523`), never written by a forward."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    prefix: Optional["LayerCache"] = None


@dataclass
class KVCache:
    """The KV cache: per-layer head-major tensors plus `index`, the twin of
    the JAX `cache_index` (the causal frontier bound: a forward of q tokens
    reads keys below index + q; it advances by q per forward).

    Forwards write into the tensors IN PLACE. Under decode_index="per_row"
    (the server's slots) each row's q new tokens land at positions
    position_ids[row, 0] ... + q − 1, less the config's `prefix_tokens` (the
    per-row write of `lwm_tpu/models/llama.py:576-641`, non-sharded branch:
    with a shared prefix the positions are global for RoPE and the cache is
    suffix-local). Under "shared" (`generate`'s left-padded batch) every
    row writes at index ... index + q − 1 (`:642-646`), whatever its
    position ids."""

    layers: list
    index: int = 0
    sp: int = 1     # the ranks its sequence is split over (a mesh's sp, else 1)

    @property
    def length(self):
        """The whole cache's positions (a rank holds length / sp of them)."""
        return self.layers[0].k.shape[2] * self.sp

    def slot(self, s):
        """Batch-1 view of row s (writes through to this cache), index 0."""
        return KVCache(
            [
                LayerCache(
                    c.k[s:s + 1], c.v[s:s + 1],
                    None if c.k_scale is None else c.k_scale[s:s + 1],
                    None if c.v_scale is None else c.v_scale[s:s + 1],
                    c.prefix,
                )
                for c in self.layers
            ],
            sp=self.sp,
        )


@dataclass
class ShardStep:
    """One forward over a cache whose sequence is split over sp, as every
    layer sees it (made once a forward by `LLaMAForCausalLM._shard_step`):
    the local keys' mask (per key [b, T_loc], or the full tile [b, s, T_loc]
    of a block of s ≤ 64 queries), the decode's local K4 bound `kv_len` ([b]
    on the card), the global positions of the first local key (`kv_offset`)
    and of the first query (`q_offset`), whether the queries are split over
    sp (`q_sharded`), and the routed write (`writes`: host slices
    (row or None, dst_lo, dst_hi, src_lo, src_hi), or per-token local
    positions [b, s] and their hits on the card)."""

    mask: torch.Tensor
    kv_len: Optional[torch.Tensor]
    kv_offset: int
    q_offset: int
    q_sharded: bool
    writes: object


def _write_shard(cache, k, v, step):
    """Write k, v [b, s, h_kv, d] (the whole block) into this rank's slice
    of the cache, each token on the rank that owns its position."""
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)   # [b, h_kv, s, d]
    quant = cache.k_scale is not None
    if quant:
        kt, k_sc = quantize_kv(kt)
        vt, v_sc = quantize_kv(vt)
    pairs = [(cache.k, kt), (cache.v, vt)] + ([(cache.k_scale, k_sc), (cache.v_scale, v_sc)]
                                               if quant else [])
    if isinstance(step.writes, list):   # host slices: contiguous runs of the block
        for row, dst_lo, dst_hi, src_lo, src_hi in step.writes:
            rows = slice(None) if row is None else slice(row, row + 1)
            for dst, src in pairs:
                dst[rows, :, dst_lo:dst_hi] = src[rows, :, src_lo:src_hi].to(dst.dtype)
        return
    # a token a time (`lwm_tpu/models/llama.py:590-620`), in one scatter: a
    # token this rank does not own is sent where the row's first owned token
    # goes, with that token's value (or, in a row with none, to position 0
    # with the value already there), so every write to an index is the same
    local, hit = step.writes   # [b, s]
    b, s = local.shape
    rows = torch.arange(b, device=k.device)[:, None]
    some = hit.any(1, keepdim=True)
    first = hit.int().argmax(1, keepdim=True)
    src = torch.where(hit, torch.arange(s, device=k.device)[None], first)
    dest = torch.where(hit, local, torch.where(some, local.gather(1, first), 0))
    for dst, new in pairs:
        vals = new.transpose(1, 2)[rows, src].to(dst.dtype)           # [b, s, h_kv, ...]
        keep = some.reshape((b, 1) + (1,) * (vals.ndim - 2))
        dst[rows, :, dest] = torch.where(keep, vals, dst[rows, :, dest])


class LLaMAAttention(nn.Module):
    """`FlaxLLaMAAttention` (`lwm_tpu/models/llama.py:402-1223`), the
    inference branches of `_inference_attn` (`:803-1018`), on this rank's
    1/tp of the heads."""

    def __init__(self, config, tp=1, **kw):
        super().__init__()
        self.config = config
        h, hkv, d = config.num_attention_heads, config.kv_heads, config.head_dim
        self.wq = _dense_cls(config, "wq")(config.hidden_size, h * d // tp, **kw)
        self.wk = _dense_cls(config, "wk")(config.hidden_size, hkv * d // tp, **kw)
        self.wv = _dense_cls(config, "wv")(config.hidden_size, hkv * d // tp, **kw)
        self.wo = _dense_cls(config, "wo")(h * d // tp, config.hidden_size, **kw)

    def _write_cache(self, cache, k, v, write_pos):
        """Write k, v [b, q, h_kv, d]: every row at write_pos + j when it is
        an int (the shared index), else row r at write_pos[r, 0] + j."""
        b, q = k.shape[:2]
        if isinstance(write_pos, int):
            idx = slice(write_pos, write_pos + q)
            k, v = k.transpose(1, 2), v.transpose(1, 2)
            if cache.k_scale is not None:
                k, cache.k_scale[:, :, idx] = quantize_kv(k)
                v, cache.v_scale[:, :, idx] = quantize_kv(v)
            cache.k[:, :, idx] = k.to(cache.k.dtype)
            cache.v[:, :, idx] = v.to(cache.v.dtype)
            return
        idx = write_pos[:, :1] + torch.arange(q, device=k.device)[None]
        rows = torch.arange(b, device=k.device)[:, None]
        if cache.k_scale is not None:
            k, k_sc = quantize_kv(k)
            v, v_sc = quantize_kv(v)
            cache.k_scale[rows, :, idx] = k_sc
            cache.v_scale[rows, :, idx] = v_sc
        cache.k[rows, :, idx] = k.to(cache.k.dtype)
        cache.v[rows, :, idx] = v.to(cache.v.dtype)

    def forward(self, x, mask, write_pos, rope, layer_cache=None, kv_len=None, prefix_mask=None,
                segment_ids=None, mesh=None, shard=None, weights=None):
        """x [b, q, hidden]; rope (cos, sin) [b, q, d/2]; `weights` the
        block's gathered whole weights by path (`parallel.fsdp`), or None.
        With layer_cache:
        mask bool [b, q, kv] (key validity ∧ causal), write_pos [b, q] the
        rows' cache positions (an int: every row's first, the shared
        index), kv_len bounds the keys any row reads, and
        prefix_mask bool [P] the valid keys of a shared-prefix block (this
        rank's slice of it when the mesh splits it over sp). Over a cache
        split over sp, `shard` (a ShardStep) stands for mask, write_pos and
        kv_len. Without a cache: mask is the additive per-key bias
        [b, 1, 1, kv] and attention is causal self-attention, within
        `segment_ids` [b, kv] when given, over the ring of `mesh`'s sp ranks
        when it has more than one (mask and segment ids then over the whole
        sequence). Returns this rank's share of the output projection (a
        partial sum over tp)."""
        cfg = self.config
        b, q, _ = x.shape
        d = cfg.head_dim
        w = weights or {}
        xq = apply_rotary(self.wq(x, w.get("attention.wq")).view(b, q, -1, d), *rope)
        xk = apply_rotary(self.wk(x, w.get("attention.wk")).view(b, q, -1, d), *rope)
        xv = self.wv(x, w.get("attention.wv")).view(b, q, -1, d)
        if layer_cache is None:
            out = self._self_attend(xq, xk, xv, mask, segment_ids, mesh)
        elif shard is not None:
            if shard.q_sharded:   # the cache takes the whole block's keys
                xk, xv = mesh.all_gather(xk, "sp", 1), mesh.all_gather(xv, "sp", 1)
            _write_shard(layer_cache, xk, xv, shard)
            out = ring_attention_inference(
                xq, layer_cache.k, layer_cache.v, shard.mask, mesh=mesh,
                kv_offset=shard.kv_offset, q_offset=shard.q_offset, k_scale=layer_cache.k_scale,
                v_scale=layer_cache.v_scale, q_sharded=shard.q_sharded, kv_len=shard.kv_len)
        else:
            self._write_cache(layer_cache, xk, xv, write_pos)
            out = self._attend(xq, layer_cache, mask, kv_len, prefix_mask, mesh)
        return self.wo(out.reshape(b, q, -1), w.get("attention.wo"))

    def _self_attend(self, xq, xk, xv, bias, segment_ids=None, mesh=None):
        """Causal self-attention, seq-major kv [b, s, h_kv, d] (the JAX
        training branch, `llama.py:1083-1122`)."""
        if mesh is not None and mesh.sp > 1:
            if self.config.attn_impl == "plain":
                raise NotImplementedError("attn_impl='plain' has no ring: an sp mesh trains on "
                                          "the kernels (attn_impl='auto')")
            return ring_attention(xq, xk, xv, bias, segment_ids, group=mesh.group("sp"),
                                  layout=mesh.layout)
        if self.config.attn_impl == "plain":
            return reference_attention(xq, xk, xv, bias, causal=True, q_seg=segment_ids,
                                       kv_seg=segment_ids)[0]
        return flash_attention(xq, xk, xv, bias, segment_ids, causal=True)

    def _attend(self, xq, layer_cache, mask, kv_len, prefix_mask=None, mesh=None):
        """xq [b, q, h, d] over the head-major cache [b, h_kv, kv, d], and
        over its shared-prefix block when it has one
        (`lwm_tpu/models/llama.py:803-988`); on a mesh with sp > 1 the
        block is this rank's slice of the prefix, whose partials merge over
        sp (`decode_with_prefix_sharded`, `lwm_tpu/ops/prefix.py:150-247`)."""
        keys, values = layer_cache.k, layer_cache.v
        k_sc, v_sc = layer_cache.k_scale, layer_cache.v_scale
        pre = layer_cache.prefix
        sharded_prefix = pre is not None and mesh is not None and mesh.sp > 1
        if sharded_prefix and self.config.attn_impl == "plain":
            raise NotImplementedError("a prefix split over sp merges the kernels' partials: "
                                      "attn_impl='auto'")
        dtype = xq.dtype
        q = xq.shape[1]
        if self.config.attn_impl != "plain" and q == 1:
            if pre is not None:
                # two K4 calls: the slots' suffixes, then every slot's query
                # folded over the prefix block (`:840-851`)
                p_len = self.config.prefix_tokens
                if sharded_prefix:   # the bound on this rank's slice of the prefix
                    n = pre.k.shape[2]
                    p_len = max(0, min(n, p_len - mesh.sp_rank * n))
                return decode_with_prefix(
                    xq, keys, values, mask[:, 0], kv_len, pre.k, pre.v, prefix_mask, p_len,
                    k_scale=k_sc, v_scale=v_sc, pk_scale=pre.k_scale, pv_scale=pre.v_scale,
                    mesh=mesh if sharded_prefix else None,
                )
            return flash_decode(xq, keys, values, mask[:, 0], kv_len, k_sc, v_sc)
        if k_sc is not None:
            keys = dequantize_kv(keys, k_sc, dtype)
            values = dequantize_kv(values, v_sc, dtype)
        pk = pv = None
        if pre is not None:
            pk, pv = pre.k, pre.v
            if pre.k_scale is not None:   # an int8 prefix: dequantized first (`:881-885`)
                pk = dequantize_kv(pk, pre.k_scale, dtype)
                pv = dequantize_kv(pv, pre.v_scale, dtype)
        if self.config.attn_impl == "plain":
            if pk is not None:
                # the concat oracle over [prefix ++ suffix] (`:955-970`)
                b = xq.shape[0]
                keys = torch.cat([pk.expand(b, -1, -1, -1), keys], 2)
                values = torch.cat([pv.expand(b, -1, -1, -1), values], 2)
                mask = torch.cat([prefix_mask.expand(b, q, -1), mask], -1)
            bias = torch.where(mask, 0.0, BIG_NEG)[:, None]
            return reference_attention(
                xq, keys, values, bias, causal=False, kv_head_major=True
            )[0]
        if q <= 64:
            # short blocks may carry per-row frontiers: exactness from the
            # full-tile bias (`lwm_tpu/models/llama.py:905-914`)
            bias = torch.where(mask, 0.0, BIG_NEG)[:, None]
        else:
            # the last row's mask = key validity ∧ (kpos ≤ frontier); with
            # the kernel's causal mask it is exact when rows share the
            # frontier, as admission prefills do (`:915-920`)
            bias = torch.where(mask[:, -1], 0.0, BIG_NEG)[:, None, None, :]
        out, lse = flash_attention_fwd(
            xq, keys, values, bias, causal=True, q_offset=kv_len - q, kv_head_major=True
        )
        if pk is None:
            return out
        # every query sees the whole valid prefix: K1 without causality over
        # the prefix block, merged by lse (`:930-946`). The rows of a batch
        # share the block and its bias, so they fold into one batch-1 call
        b, _, h, d = xq.shape
        p_bias = torch.where(prefix_mask, 0.0, BIG_NEG)[None, None, None, :]
        out_p, lse_p = flash_attention_fwd(
            xq.reshape(1, b * q, h, d), pk, pv, p_bias, causal=False, kv_head_major=True
        )
        out_p = out_p.reshape(b, q, h, d)
        lse_p = lse_p.reshape(h, b, q).transpose(0, 1)
        if not sharded_prefix:
            return combine_lse(out, lse, out_p, lse_p).to(dtype)
        # this rank's slice of the prefix: its partials merge over sp first
        o_p, m_p, l_p = merge_partials(*lse_partials(out_p, lse_p), mesh)
        return combine_raw_partials(*lse_partials(out, lse), o_p, m_p, l_p).to(dtype)


class LLaMAMLP(nn.Module):
    """SwiGLU (`lwm_tpu/models/llama.py:1226-1251`), on this rank's 1/tp of
    the features (w2's output is then a partial sum over tp)."""

    def __init__(self, config, tp=1, **kw):
        super().__init__()
        f = config.intermediate_size // tp
        self.w1 = _dense_cls(config, "w1")(config.hidden_size, f, **kw)
        self.w2 = _dense_cls(config, "w2")(f, config.hidden_size, **kw)
        self.w3 = _dense_cls(config, "w3")(config.hidden_size, f, **kw)

    def forward(self, x, weights=None):
        w = weights or {}
        return self.w2(F.silu(self.w1(x, w.get("feed_forward.w1")))
                       * self.w3(x, w.get("feed_forward.w3")), w.get("feed_forward.w2"))


class LLaMABlock(nn.Module):
    """`lwm_tpu/models/llama.py:1254-1336` (no dropout). On a tp mesh its
    attention and MLP run on the rank's heads and features between
    `TPEntry` (the backward's all-reduce) and `TPExit` (the forward's, in
    fp32); sharded over fsdp × sp, it gathers its weights as its forward
    starts (`parallel.fsdp.gather_weights`)."""

    def __init__(self, config, tp=1, **kw):
        super().__init__()
        self.config = config
        self.attention = LLaMAAttention(config, tp, **kw)
        self.feed_forward = LLaMAMLP(config, tp, **kw)
        self.attention_norm = RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)
        self.ffn_norm = RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)

    def forward(self, x, mask, write_pos, rope, layer_cache=None, kv_len=None, prefix_mask=None,
                segment_ids=None, mesh=None, shard=None):
        weights = gather_weights(self)
        x = x + tp_exit(self.attention(
            tp_enter(self.attention_norm(x), mesh), mask, write_pos, rope, layer_cache, kv_len,
            prefix_mask, segment_ids, mesh, shard, weights,
        ), mesh)
        h = tp_enter(self.ffn_norm(x), mesh)
        chunk = self.config.scan_mlp_chunk_size
        if (self.config.scan_mlp and torch.is_grad_enabled() and h.shape[1] >= chunk
                and h.shape[1] % chunk == 0):
            # sequence chunks, each rematerialized (`llama.py:1308-1327`);
            # the same values, only fewer MLP activations kept at a time
            return x + tp_exit(torch.cat(
                [checkpoint(self.feed_forward, c, weights, use_reentrant=False)
                 for c in h.split(chunk, 1)], dim=1,
            ), mesh)
        return x + tp_exit(self.feed_forward(h, weights), mesh)


class LLaMAForCausalLM(nn.Module):
    """Embedding → blocks → ln_f → lm_head (`lwm_tpu/models/llama.py:1463-1634`),
    built on `device`: the card unless the caller names another."""

    takes_vision_masks = False   # whether `_embed` reads vision masks

    def __init__(self, config, *, dtype=torch.float32, param_dtype=None, device="cuda",
                 mesh=None):
        super().__init__()
        if device is not None and torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "LLaMAForCausalLM is built on the card by default and CUDA is not "
                "available: pass device='cpu' (or 'meta') to build it elsewhere"
            )
        self.config = config
        self.dtype = dtype
        tp = 1 if mesh is None else mesh.tp
        check_tp(config, tp)
        if mesh is not None and mesh.size > 1 and config.quant_dense != "none":
            raise NotImplementedError("int8 weights on a mesh come with a later multi-GPU slice "
                                      "(ROADMAP A4): serve int8 weights on one device")
        kw = dict(dtype=dtype, param_dtype=param_dtype or dtype, device=device)
        self.wte = Embed(config.vocab_size, config.hidden_size, **kw)
        self.h = nn.ModuleList(
            LLaMABlock(config, tp, **kw) for _ in range(config.num_hidden_layers)
        )
        self.ln_f = RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)
        # a tied head is the embedding's product and is never quantized
        self.lm_head = (
            None if config.tie_word_embeddings
            else _dense_cls(config, "lm_head")(config.hidden_size, config.vocab_size // tp, **kw)
        )
        self._rope = {}  # device → factored RoPE table, built at first use
        # a parallel.mesh.Mesh: the training forward's dp and sp ranks, or
        # the inference forward's (the weights are then this rank's tp slices)
        self.mesh = mesh

    @classmethod
    def on_tensors(cls, config, state_dict, dtype, mesh=None):
        """A model of `config` whose parameters are the tensors of
        `state_dict` (not copies), in eval mode; on `mesh`, `state_dict`
        holds this rank's slices (`parallel.partition.shard_state_dict`)."""
        kw = {} if mesh is None else dict(mesh=mesh)
        model = cls(config, dtype=dtype, device="meta", **kw)
        model.load_state_dict(state_dict, assign=True)
        return model.eval()

    @property
    def _mesh(self):
        return mesh_of(self)

    @property
    def cache_sp(self):
        """The ranks a cache's sequence is split over: the mesh's sp for the
        shared index and for `sp_slot_caches` slots, 1 for a shared-prefix
        model's slots (its prefix block is split instead) and off a mesh."""
        mesh, cfg = self._mesh, self.config
        if mesh is None or cfg.prefix_len or not (cfg.decode_index == "shared"
                                                  or cfg.sp_slot_caches):
            return 1
        return mesh.sp

    @torch.no_grad()
    def init_weights(self, generator):
        """Random weights as the JAX init draws them: every dense kernel and
        the embedding ~ N(0, initializer_range), norm scales 1. On a mesh
        each leaf is drawn whole from `generator` in the one-device order,
        this rank keeps its part (its tp slice, its shard: `parallel.fsdp`)
        and the rest is freed, so a mesh run and a one-device run from one
        seed start equal and no rank holds the whole model."""
        std = self.config.initializer_range
        places = placements(self)
        for name, mod in self.named_modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                pl = places[f"{name}.weight"]
                if tuple(mod.weight.shape) == pl.shape:
                    mod.weight.normal_(0.0, std, generator=generator)
                else:
                    whole = torch.empty(pl.shape, dtype=mod.weight.dtype,
                                        device=mod.weight.device)
                    mod.weight.copy_(pl.local_part(whole.normal_(0.0, std, generator=generator)))
                    del whole
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)

    def init_cache(self, batch, length, prefix=None):
        """Zeroed head-major cache for `batch` rows of `length` positions.
        A `prefix_len` model's layers also hold the frozen batch-1 prefix
        block: `prefix` (one LayerCache a layer, adopted as it is, not
        copied), else zeros of [1, h_kv, prefix_len, d]. On a mesh `batch`
        is this rank's rows and `length` the whole cache's: the rank holds
        its h_kv/tp heads and, when `cache_sp` splits it, length/sp
        positions (a prefix block: prefix_len/sp positions when sp > 1)."""
        cfg = self.config
        mesh = self._mesh
        tp = 1 if mesh is None else mesh.tp
        sp = self.cache_sp
        if length % sp:
            raise ValueError(f"cache length {length} must be a multiple of sp={sp}")
        length //= sp
        p_len = cfg.prefix_len // (mesh.sp if mesh is not None and cfg.prefix_len else 1)

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.wte.weight.device)

        def layer(rows, n):
            shape = (rows, cfg.kv_heads // tp, n, cfg.head_dim)
            if cfg.kv_cache_dtype == "int8":
                return LayerCache(
                    zeros(shape, torch.int8), zeros(shape, torch.int8),
                    zeros(shape[:3], torch.float32), zeros(shape[:3], torch.float32),
                )
            return LayerCache(zeros(shape, self.dtype), zeros(shape, self.dtype))

        layers = [layer(batch, length) for _ in range(cfg.num_hidden_layers)]
        if cfg.prefix_len:
            if prefix is None:
                prefix = [layer(1, p_len) for _ in layers]
            if len(prefix) != len(layers) or prefix[0].k.shape[2] != p_len:
                raise ValueError(f"prefix blocks do not match prefix_len {cfg.prefix_len} "
                                 f"({p_len} positions a rank)")
            for c, p in zip(layers, prefix):
                c.prefix = p
        elif prefix is not None:
            raise ValueError("a prefix block needs a model with prefix_len set")
        return KVCache(layers, sp=sp)

    def prepare_inputs_for_generation(self, input_ids, max_length, attention_mask=None):
        """`generate`'s first inputs (`lwm_tpu/models/llama.py:1814-1834`): a
        shared-index cache of round_cache_length(max_length) slots, the
        left-padded prompt mask written over ones to that length, and
        position ids that advance over real tokens only (cumsum − 1: a
        row's pads sit at −1 and below, never seen by a real query).
        Returns dict(cache, attention_mask [b, T] bool, position_ids)."""
        if self.config.decode_index != "shared":
            raise ValueError("generate runs on a shared-index cache: decode_index='shared'")
        b, s = input_ids.shape
        dev = input_ids.device
        mesh = self._mesh
        cache_length = round_cache_length(self.config, max_length,
                                          None if mesh is None else mesh.sp)
        extended = torch.ones((b, cache_length), dtype=torch.bool, device=dev)
        if attention_mask is not None:
            position_ids = attention_mask.long().cumsum(-1) - 1
            extended[:, :s] = attention_mask.bool()
        else:
            position_ids = torch.arange(s, device=dev).expand(b, s)
        return dict(cache=self.init_cache(b, cache_length), attention_mask=extended,
                    position_ids=position_ids)

    @staticmethod
    def update_inputs_for_generation(model_kwargs):
        """The next step's inputs (`lwm_tpu/models/llama.py:1836-1839`): the
        cache advanced in place, the position one past the last."""
        model_kwargs["position_ids"] = model_kwargs["position_ids"][:, -1:] + 1
        return model_kwargs

    def _rope_table(self, device):
        if device not in self._rope:
            cfg = self.config
            self._rope[device] = tuple(
                t.to(device)
                for t in precompute_freqs(cfg.head_dim, cfg.max_sequence_length, cfg.theta)
            )
        return self._rope[device]

    def forward(self, input_ids, attention_mask=None, position_ids=None, cache=None,
                segment_ids=None, vision_masks=None, logits_tail=None):
        """input_ids [b, s]. Without a cache: attention_mask [b, s] (1 =
        real token), causal self-attention, differentiable. With a cache
        (`init_cache`; no autograd): attention_mask [b, T] key validity over
        the cache, position_ids [b, s] the rows' positions (RoPE's); the new
        keys are written in place, under config.decode_index "per_row" at
        position_ids − config.prefix_tokens, under "shared" at cache.index
        for every row (`generate`'s left-padded batch), then every query i
        of row r sees the valid keys at cache positions ≤ that of its own,
        and the whole valid shared prefix when the cache has one.
        `vision_masks` [b, s] is for a model that embeds vision tokens
        (`_embed`); `segment_ids` [b, s] (int, no cache) mark packed
        documents. On a mesh (`self.mesh`) every [b, s] argument is this
        rank's rows and slice of the sequence. Returns logits [b, s |
        logits_tail, vocab] in the model dtype (`lwm_tpu/models/llama.py:
        1583-1634`); `logits_tail` (the config's when None) keeps only the
        last positions' logits."""
        with torch.no_grad() if cache is not None else contextlib.nullcontext():
            x = self._hidden(input_ids, attention_mask, position_ids, cache, segment_ids,
                             vision_masks)
            tail = self.config.logits_tail if logits_tail is None else logits_tail
            if tail and x.shape[1] > tail:
                x = x[:, -tail:]
            return self._head(x)

    def forward_hidden(self, input_ids, attention_mask=None, position_ids=None, cache=None,
                       segment_ids=None, vision_masks=None):
        """The final (ln_f) hidden states [b, s, hidden] in the model dtype,
        without the lm_head (`lwm_tpu/models/llama.py:1539-1562`); arguments
        as `forward`."""
        with torch.no_grad() if cache is not None else contextlib.nullcontext():
            return self._hidden(input_ids, attention_mask, position_ids, cache, segment_ids,
                                vision_masks)

    def _embed(self, input_ids, vision_masks):
        """The block stack's input for `input_ids`."""
        if vision_masks is not None:
            raise ValueError("vision_masks need a model with a vision embedding (VideoLLaMA)")
        return self.wte(input_ids)

    def _head(self, x):
        """The logits of the final hidden states x (on a tp mesh the rank's
        vocabulary slices, gathered: `GatherLast`)."""
        if self.lm_head is None:
            return F.linear(x, full_weight(self.wte).to(self.dtype))
        mesh = self._mesh
        return gather_tp(self.lm_head(tp_enter(x, mesh)), mesh)

    def head_weight(self):
        """The logits head's whole weight [vocab, hidden] (the embedding's
        when tied), differentiable: gathered over the shard group when
        sharded, and over tp when its vocab is split (`--fused_lm_loss`)."""
        if self.lm_head is None:
            return full_weight(self.wte)
        return gather_tp(full_weight(self.lm_head), self._mesh, 0)

    def _hidden(self, input_ids, attention_mask, position_ids, cache, segment_ids,
                vision_masks=None):
        cfg = self.config
        mesh = self._mesh
        if segment_ids is not None and cache is not None:
            raise ValueError("segment ids are for forwards without a cache")
        if self.training and torch.is_grad_enabled() and max(
            cfg.attn_pdrop, cfg.embd_pdrop, cfg.resid_pdrop
        ) > 0:
            raise NotImplementedError("dropout in training is not ported yet: K1 has no dropout "
                                      "(ROADMAP A3, A4: in-kernel dropout)")
        b, s = input_ids.shape
        dev = input_ids.device
        sp = 1 if mesh is None or cache is not None else mesh.sp   # the training ring's
        if s * sp > cfg.max_sequence_length:
            raise ValueError(f"input length {s * sp} > max_sequence_length "
                             f"{cfg.max_sequence_length}")
        if position_ids is None:
            if cache is not None:
                raise ValueError("position_ids required with a cache")
            r = torch.arange(s, device=dev)
            if sp > 1:   # the global positions of this rank's slots (`ops.striped`)
                r = mesh.sp_rank + r * sp if mesh.layout == "striped" else mesh.sp_rank * s + r
            position_ids = r.expand(b, s)
        if sp > 1 and attention_mask is not None:
            attention_mask = mesh.gather_sequence(attention_mask)
        if sp > 1 and segment_ids is not None:
            segment_ids = mesh.gather_sequence(segment_ids)
        kv = s * sp if cache is None else cache.length
        if attention_mask is None:
            attention_mask = torch.ones(b, kv, dtype=torch.bool, device=dev)
        write_pos, prefix_mask, shard = position_ids, None, None
        if cache is not None:
            # mask construction (`lwm_tpu/models/llama.py:1124-1173`): global
            # positions for RoPE, suffix-local ones for the cache (`:581-586`)
            if cfg.decode_index == "per_row":
                write_pos = position_ids - cfg.prefix_tokens
                frontier = write_pos[:, :, None]
            elif cfg.decode_index == "shared":
                # every row writes at the shared index, and its frontier
                # comes from it (`:642-646`, `:1146-1150`)
                if cache.index + s > kv:
                    raise ValueError(f"{s} tokens at index {cache.index} overrun the "
                                     f"{kv}-slot cache")
                write_pos = cache.index
                frontier = (cache.index + torch.arange(s, device=dev))[None, :, None]
            else:
                raise ValueError(f"decode_index {cfg.decode_index!r}: use 'shared' or 'per_row'")
            kv_len = cache.index + s
            if cache.sp > 1:
                shard = self._shard_step(cache, attention_mask, write_pos, frontier, kv_len, s)
                mask = None
            else:
                causal = torch.arange(kv, device=dev)[None, None, :] <= frontier
                mask = attention_mask.bool()[:, None, :] & causal          # [b, s, kv]
            pre = cache.layers[0].prefix
            if pre is not None:
                n = pre.k.shape[2]
                first = 0 if mesh is None else mesh.sp_rank * n   # this rank's slice of it
                prefix_mask = torch.arange(first, first + n, device=dev) < cfg.prefix_tokens
        else:
            # the training branch's per-key bias (`llama.py:1114-1119`)
            mask = torch.where(
                attention_mask.bool(), 0.0, torch.finfo(self.dtype).min
            )[:, None, None, :]
            kv_len = None

        if shard is not None and shard.q_sharded:   # this rank's rows of the block
            rows = slice(mesh.sp_rank * (s // mesh.sp), (mesh.sp_rank + 1) * (s // mesh.sp))
            input_ids, position_ids = input_ids[:, rows], position_ids[:, rows]
            vision_masks = None if vision_masks is None else vision_masks[:, rows]
        rope = take_freqs(self._rope_table(dev), position_ids)
        x = self._embed(input_ids, vision_masks)
        remat = cfg.remat_block != "none" and cache is None and torch.is_grad_enabled()
        for i, block in enumerate(self.h):
            args = (x, mask, write_pos, rope, None if cache is None else cache.layers[i], kv_len,
                    prefix_mask, segment_ids, mesh, shard)
            if remat:
                x = checkpoint(block, *args, use_reentrant=False, context_fn=self._remat_context)
            else:
                x = block(*args)
        if cache is not None:
            cache.index += s
        if shard is not None and shard.q_sharded:
            x = mesh.gather_sequence(x)
        return self.ln_f(x)

    def _shard_step(self, cache, attention_mask, write_pos, frontier, kv_len, s):
        """The ShardStep of a forward of s tokens over a cache split over sp:
        this rank's keys are positions [kv_offset, kv_offset + T_loc) of the
        whole cache; `attention_mask` [b, T] is over the whole cache."""
        mesh = self._mesh
        n = cache.layers[0].k.shape[2]
        off = mesh.sp_rank * n
        dev = attention_mask.device
        valid = attention_mask[:, off:off + n].bool()
        kpos = torch.arange(off, off + n, device=dev)
        kv_len_loc = None
        if s == 1:
            mask = valid & (kpos[None] <= frontier[:, 0])
            kv_len_loc = local_kv_len(mask)
        elif s <= 64:   # short blocks may carry per-row frontiers: the full tile
            mask = valid[:, None] & (kpos[None, None] <= frontier)
        else:           # rows share the frontier: the last one's per key
            mask = valid & (kpos[None] <= frontier[:, -1])
        if not isinstance(write_pos, int) and s <= 64:   # a token at a time, on the card
            local = write_pos[:, :1] - off + torch.arange(s, device=dev)[None]
            writes = (local.clamp(0, n - 1), (local >= 0) & (local < n))
        else:   # runs: the shared index, or an admission's rows (their starts read once)
            starts = ([(None, write_pos)] if isinstance(write_pos, int)
                      else list(enumerate(write_pos[:, 0].tolist())))
            writes = []
            for row, p in starts:
                lo, hi = max(p, off), min(p + s, off + n)
                if lo < hi:
                    writes.append((row, lo - off, hi - off, lo - p, hi - p))
        return ShardStep(mask, kv_len_loc, off, kv_len - s, s > 1 and s % mesh.sp == 0, writes)

    def _remat_context(self):
        """Checkpoint contexts of `remat_block` (`llama.py:1369-1394`)."""
        if self.config.remat_block == "save_flash":
            return create_selective_checkpoint_contexts(save_flash_policy)
        return contextlib.nullcontext(), contextlib.nullcontext()
