"""JAX (flax) LLaMA or VideoLLaMA param tree → the port's state dict.

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
HF's rotate-half layout only). A VideoLLaMA's `transformer/vte/embedding`
↔ `vte.weight` and `vision_head/kernel` ↔ `vision_head.weight` (transposed;
absent when `tie_vision_embeddings`) map both ways, wherever the tree or
the state dict holds them.

A tree from `quantize_params_int8` (`lwm_tpu/ops/quant.py:340-362`) converts
as it is: each quantized int8 kernel [d, f] becomes an int8 [f, d] `weight`
and its fp32 `scale` [f] (one layer's slice of a stacked scale) is kept, for
a model built with `quant_dense` set. `dtype=` casts neither.

Any tree shaped like the params converts the same way: a gradient tree
from `jax.grad`, optax's moments. `convert_optax_state` maps the state of
the JAX train step's optimizer (`lwm_tpu/optim.py`: clip + adamw, possibly
inside `optax.MultiSteps`) onto `lwm_tpu_torch.optim.AdamW.named_state`,
from optax's own namedtuples or from the state-dict form a checkpoint
stream holds (nested dicts keyed "0", "1", "count", "mu", ...).

The inverse maps write what the JAX trainer saves: `flax_params_tree` (the
state dict as the flax param tree, stacked under `scan_decoder` when
`config.scan_layers`, kernels transposed back to [in, out]) and
`optax_state_tree` (`AdamW.named_state` as flax's `to_state_dict` of the
optax state). Dict keys come sorted, as a tree that went through `jax.jit`
has them, so that a stream of the port's tree is the JAX writer's bytes.
"""

from __future__ import annotations

import functools

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


def convert_flax_params(params, config, dtype=None, device=None):
    """Returns {name: tensor} for `LLaMAForCausalLM.load_state_dict`
    (float weights cast to `dtype` when given; int8 weights and their
    scales keep their types). With `device`, each leaf is copied there as
    it is and transposed there: a card transposes a 7b's kernels in
    milliseconds, a host in seconds."""
    if "params" in params:
        params = params["params"]
    tr = params["transformer"]

    def t(x, transpose=False, cast=True):
        if device is not None and not isinstance(x, torch.Tensor):
            x = np.asarray(x)
            if x.dtype.name != "bfloat16":   # numpy's bfloat16 takes the host path below
                x = torch.from_numpy(np.require(x, requirements="W")).to(device)
        if isinstance(x, torch.Tensor):   # a bfloat16 leaf of `checkpoint.load_stream`
            if device is not None:
                x = x.to(device)
            x = (x.T if transpose else x).contiguous().clone()
            return x.to(dtype) if dtype is not None and cast and x.dtype != torch.int8 else x
        x = np.asarray(x)
        bf16 = x.dtype.name == "bfloat16"   # numpy's bfloat16 has no torch counterpart
        x = np.array(x.T if transpose else x, dtype=np.float32 if bf16 else None, order="C")
        x = torch.from_numpy(x)  # a writable copy
        if dtype is not None and cast and x.dtype != torch.int8:
            x = x.to(dtype)
        elif bf16:
            x = x.to(torch.bfloat16)
        return x if device is None else x.to(device)

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
    if "vte" in tr:   # a VideoLLaMA's
        sd["vte.weight"] = t(tr["vte"]["embedding"])
    if "vision_head" in params:   # absent when tie_vision_embeddings
        dense(sd, "vision_head", params["vision_head"])
    for i in range(config.num_hidden_layers):
        blk = _layer_tree(tr["h"], i, config.param_scan_axis)
        pre = f"h.{i}."
        for mod, names in (("attention", "wq wk wv wo"), ("feed_forward", "w1 w2 w3")):
            for n in names.split():
                dense(sd, f"{pre}{mod}.{n}", blk[mod][n])
        sd[pre + "attention_norm.weight"] = t(blk["attention_norm"]["kernel"])
        sd[pre + "ffn_norm.weight"] = t(blk["ffn_norm"]["kernel"])
    return sd


def _field(node, name):
    return node[name] if isinstance(node, dict) else getattr(node, name)


def _find(node, fields):
    """The first node of an optax state tree that has all `fields`: a
    namedtuple, or a dict of the state-dict form."""
    if isinstance(node, dict):
        if all(f in node for f in fields):
            return node
        children = node.values()
    elif all(hasattr(node, f) for f in fields):
        return node
    elif isinstance(node, (tuple, list)):
        children = node
    else:
        return None
    for child in children:
        found = _find(child, fields)
        if found is not None:
            return found
    return None


def convert_optax_state(opt_state, config, device=None):
    """optax state of clip_by_global_norm + adamw (optionally inside
    MultiSteps) → {"count", "mini_step", "gradient_step", "mu", "nu", "acc"}
    as `AdamW.named_state` gives it: counts as ints, moments as state dicts
    (mu keeps its dtype: bf16 with `bf16_momentum`), on `device` when
    given."""
    adam = _find(opt_state, ("count", "mu", "nu"))
    if adam is None:
        raise ValueError("no ScaleByAdamState in the optax state")
    multi = _find(opt_state, ("mini_step", "gradient_step", "acc_grads"))

    def count(node, name):
        return 0 if node is None else int(np.asarray(_field(node, name)))

    return dict(
        count=count(adam, "count"),
        mini_step=count(multi, "mini_step"),
        gradient_step=count(multi, "gradient_step"),
        mu=convert_flax_params(_field(adam, "mu"), config, device=device),
        nu=convert_flax_params(_field(adam, "nu"), config, device=device),
        acc={} if multi is None else convert_flax_params(_field(multi, "acc_grads"), config,
                                                         device=device),
    )


def _t(x):
    return (lambda: materialize(x).t()) if callable(x) else x.t()


def _sorted(tree):
    return {k: _sorted(tree[k]) if isinstance(tree[k], dict) else tree[k] for k in sorted(tree)}


_LAYER_DENSE = {"attention": ("wq", "wk", "wv", "wo"), "feed_forward": ("w1", "w2", "w3")}


def materialize(leaf):
    """A leaf of `flax_params_tree` as a tensor (a lazy leaf is called)."""
    return leaf() if callable(leaf) else leaf


def _stack(parts, axis):
    return torch.stack([materialize(p) for p in parts], dim=axis)


def flax_params_tree(sd, config):
    """The inverse of `convert_flax_params` for float weights: a state dict
    ({name: tensor or a zero-argument callable making one}, any device) →
    the flax param tree (without the top-level "params" key), dense weights
    as [in, out] kernels (transposed views), the layers stacked on
    `config.param_scan_axis` under `transformer/h/scan_decoder` when
    `config.scan_layers`, else under `transformer/h/{i}`; keys sorted. A
    stacked leaf is lazy, a callable that stacks when called (see
    `materialize`): the checkpoint writer makes one at a time, so a 7b
    train state never holds two stacked copies of itself."""
    def layer(i):
        pre = f"h.{i}."
        tree = {mod: {n: {"kernel": _t(sd[f"{pre}{mod}.{n}.weight"])} for n in names}
                for mod, names in _LAYER_DENSE.items()}
        tree["attention_norm"] = {"kernel": sd[pre + "attention_norm.weight"]}
        tree["ffn_norm"] = {"kernel": sd[pre + "ffn_norm.weight"]}
        return tree

    layers = [layer(i) for i in range(config.num_hidden_layers)]
    if config.scan_layers:
        def stack(nodes):
            if isinstance(nodes[0], dict):
                return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
            return functools.partial(_stack, nodes, config.param_scan_axis)

        h = {"scan_decoder": stack(layers)}
    else:
        h = {str(i): blk for i, blk in enumerate(layers)}
    tree = {"transformer": {"wte": {"embedding": sd["wte.weight"]},
                            "ln_f": {"kernel": sd["ln_f.weight"]}, "h": h}}
    if not config.tie_word_embeddings:
        tree["lm_head"] = {"kernel": _t(sd["lm_head.weight"])}
    if "vte.weight" in sd:
        tree["transformer"]["vte"] = {"embedding": sd["vte.weight"]}
    if "vision_head.weight" in sd:
        tree["vision_head"] = {"kernel": _t(sd["vision_head.weight"])}
    return _sorted(tree)


def optax_state_tree(named, params, config, mu_dtype=torch.float32,
                     accumulate_gradient_steps=1):
    """`AdamW.named_state()` → flax's `to_state_dict` of the JAX trainer's
    optax state (`lwm_tpu/optim.py:37-92`): clip_by_global_norm + adamw, its
    empty states dropped as `flatten_dict` drops them,

        {"1": {"0": {"count", "mu": {"params": ...}, "nu": {"params": ...}},
               "2": {"count"}}}

    inside {"mini_step", "gradient_step", "inner_opt_state", "acc_grads"}
    when `accumulate_gradient_steps` > 1 (`optax.MultiSteps`). Counts are
    int32 scalars; a moment not made yet (no update so far) is zeros shaped
    like `params` ({name: tensor}), mu in `mu_dtype`, made lazily as the
    stacked leaves are."""
    def moments(key, dtype):
        got = named.get(key, {})
        return {"params": flax_params_tree(
            {n: got[n] if n in got else functools.partial(torch.zeros_like, p, dtype=dtype)
             for n, p in params.items()}, config)}

    count = np.int32(named["count"])
    adamw = {"1": {"0": {"count": count, "mu": moments("mu", mu_dtype),
                         "nu": moments("nu", None)},
                   "2": {"count": count}}}
    if accumulate_gradient_steps <= 1:
        return adamw
    return {"mini_step": np.int32(named["mini_step"]),
            "gradient_step": np.int32(named["gradient_step"]),
            "inner_opt_state": adamw, "acc_grads": moments("acc", None)}
