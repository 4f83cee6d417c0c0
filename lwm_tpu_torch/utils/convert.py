"""JAX (flax) LLaMA param tree → the port's state dict.

Counterpart of `lwm_tpu/utils/checkpoint_convert.py:21-33` (`unscan_params`)
and of the name map in `flax_to_torch_llama` (`:77-124`), for the port's own
module names rather than HF's. The tree may be scanned (layers stacked under
`transformer/h/scan_decoder` on `config.param_scan_axis`, 0 or 1) or
unscanned (`transformer/h/{i}`), with or without a top-level "params" key;
leaves are numpy arrays (anything `np.asarray` takes) or tensors (the
bfloat16 leaves of `lwm_tpu_torch.checkpoint.load_stream`).

Flax dense kernels are [in, out]; they are TRANSPOSED here to torch's
[out, in] `nn.Linear` layout. RoPE stays on interleaved pairs in both
packages, so no q/k row permutation is applied (`_permute_rotary` is for
HF's rotate-half layout only).

A tree from `quantize_params_int8` (`lwm_tpu/ops/quant.py:340-362`) converts
as it is: each quantized int8 kernel [d, f] becomes an int8 [f, d] `weight`
and its fp32 `scale` [f] (one layer's slice of a stacked scale) is kept, for
a model built with `quant_dense` set. `dtype=` casts neither.

Any tree shaped like the params converts the same way: a gradient tree
from `jax.grad`, optax's moments. `convert_optax_state` maps the state of
the JAX train step's optimizer (`lwm_tpu/optim.py`: clip + adamw, possibly
inside `optax.MultiSteps`) onto `lwm_tpu_torch.optim.AdamW.named_state`.
"""

from __future__ import annotations

import numpy as np
import torch


def _layer_tree(h, layer, scan_axis):
    """Layer `layer`'s subtree of transformer/h, scanned or not."""
    if "scan_decoder" in h:
        def take(node):
            if isinstance(node, dict):
                return {k: take(v) for k, v in node.items()}
            if isinstance(node, torch.Tensor):
                return node.select(scan_axis, layer)
            return np.take(np.asarray(node), layer, axis=scan_axis)

        return take(h["scan_decoder"])
    return h[str(layer)]


def convert_flax_params(params, config, dtype=None):
    """Returns {name: tensor} for `LLaMAForCausalLM.load_state_dict`
    (float weights cast to `dtype` when given; int8 weights and their
    scales keep their types)."""
    if "params" in params:
        params = params["params"]
    tr = params["transformer"]

    def t(x, transpose=False, cast=True):
        if isinstance(x, torch.Tensor):   # a bfloat16 leaf of `checkpoint.load_stream`
            x = (x.T if transpose else x).contiguous().clone()
            return x.to(dtype) if dtype is not None and cast and x.dtype != torch.int8 else x
        x = np.asarray(x)
        bf16 = x.dtype.name == "bfloat16"   # numpy's bfloat16 has no torch counterpart
        x = np.array(x.T if transpose else x, dtype=np.float32 if bf16 else None, order="C")
        x = torch.from_numpy(x)  # a writable copy
        if dtype is not None and cast and x.dtype != torch.int8:
            return x.to(dtype)
        return x.to(torch.bfloat16) if bf16 else x

    def dense(sd, name, node):
        sd[name + ".weight"] = t(node["kernel"], transpose=True)
        if "scale" in node:  # int8 kernel from quantize_params_int8
            sd[name + ".scale"] = t(node["scale"], cast=False).float()

    sd = {
        "wte.weight": t(tr["wte"]["embedding"]),
        "ln_f.weight": t(tr["ln_f"]["kernel"]),
    }
    if not config.tie_word_embeddings:
        dense(sd, "lm_head", params["lm_head"])
    for i in range(config.num_hidden_layers):
        blk = _layer_tree(tr["h"], i, config.param_scan_axis)
        pre = f"h.{i}."
        for mod, names in (("attention", "wq wk wv wo"), ("feed_forward", "w1 w2 w3")):
            for n in names.split():
                dense(sd, f"{pre}{mod}.{n}", blk[mod][n])
        sd[pre + "attention_norm.weight"] = t(blk["attention_norm"]["kernel"])
        sd[pre + "ffn_norm.weight"] = t(blk["ffn_norm"]["kernel"])
    return sd


def _find(node, fields):
    """The first namedtuple in an optax state tree that has all `fields`."""
    if all(hasattr(node, f) for f in fields):
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _find(child, fields)
            if found is not None:
                return found
    return None


def convert_optax_state(opt_state, config):
    """optax state of clip_by_global_norm + adamw (optionally inside
    MultiSteps) → {"count", "mini_step", "gradient_step", "mu", "nu", "acc"}
    as `AdamW.named_state` gives it: counts as ints, moments as state dicts
    (mu keeps its dtype: bf16 with `bf16_momentum`)."""
    adam = _find(opt_state, ("count", "mu", "nu"))
    if adam is None:
        raise ValueError("no ScaleByAdamState in the optax state")
    multi = _find(opt_state, ("mini_step", "gradient_step", "acc_grads"))
    out = dict(
        count=int(np.asarray(adam.count)),
        mini_step=0 if multi is None else int(np.asarray(multi.mini_step)),
        gradient_step=0 if multi is None else int(np.asarray(multi.gradient_step)),
        mu=convert_flax_params(adam.mu, config),
        nu=convert_flax_params(adam.nu, config),
        acc={} if multi is None else convert_flax_params(multi.acc_grads, config),
    )
    return out
