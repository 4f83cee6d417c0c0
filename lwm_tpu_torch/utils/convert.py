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

Any tree shaped like the params converts the same way, whole or in part:
a gradient tree from `jax.grad`, optax's moments (of the trainable params
alone under a frozen mask). Both directions go by name (`_flax_key`: a
port parameter name → its flax path), and `flax_param_path` gives the
path string the JAX masks match. `convert_optax_state` maps the state of
the JAX train step's optimizer (`lwm_tpu/optim.py`: clip + adamw, or the
PaLM chain, possibly inside `optax.MultiSteps` and `multi_transform`)
onto the `named_state` of `lwm_tpu_torch.optim.AdamW` or `.Palm`, from
optax's own namedtuples or from the state-dict form a checkpoint stream
holds (nested dicts keyed "0", "1", "count", "mu", ...).

The inverse maps write what the JAX trainer saves: `flax_params_tree` (the
state dict as the flax param tree, stacked under `scan_decoder` when
`config.scan_layers`, kernels transposed back to [in, out]) and
`optax_state_tree` (a `named_state` as flax's `to_state_dict` of the
optax state). Dict keys come sorted, as a tree that went through `jax.jit`
has them, so that a stream of the port's tree is the JAX writer's bytes.
"""

from __future__ import annotations

import functools
import pickle
from collections.abc import Mapping

import numpy as np
import torch

from lwm_tpu_torch.parallel.partition import local_slice

from lwm_tpu_torch.utils.io import open_file


_LAYER_DENSE = {"attention": ("wq", "wk", "wv", "wo"), "feed_forward": ("w1", "w2", "w3")}


def _flax_key(name):
    """A parameter name of the port → (its path in the flax tree under
    "params", the layer as an int; whether it is a dense kernel, stored
    transposed). `.scale` names the fp32 scale of an int8 kernel."""
    parts = name.split(".")
    leaf = "kernel" if parts[-1] == "weight" else "scale"
    if parts[0] == "h":
        i, mod = int(parts[1]), parts[2]
        if mod in _LAYER_DENSE:
            return ("transformer", "h", i, mod, parts[3], leaf), leaf == "kernel"
        return ("transformer", "h", i, mod, "kernel"), False   # the two norms
    if parts[0] in ("wte", "vte"):
        return ("transformer", parts[0], "embedding"), False
    if parts[0] == "ln_f":
        return ("transformer", "ln_f", "kernel"), False
    return (parts[0], leaf), leaf == "kernel"   # lm_head, vision_head


def flax_param_path(name, config):
    """The '/'-joined flax path of parameter `name` in the JAX trainer's
    param tree ("params/transformer/h/scan_decoder/attention/wq/kernel"),
    the string the JAX masks match their regexes against
    (`lwm_tpu/parallel/partition.py:37-44`)."""
    path, _ = _flax_key(name)
    if len(path) > 2 and path[1] == "h":
        path = (*path[:2], "scan_decoder" if config.scan_layers else str(path[2]), *path[3:])
    return "/".join(("params", *path))


def _candidate_names(config):
    """Every parameter name a model of `config` may have, int8 scales too."""
    names = ["wte.weight", "vte.weight", "ln_f.weight"]
    heads = [] if config.tie_word_embeddings else ["lm_head"]
    if not getattr(config, "tie_vision_embeddings", True):
        heads.append("vision_head")
    for head in heads:
        names += [head + ".weight", head + ".scale"]
    for i in range(config.num_hidden_layers):
        for mod, dense in _LAYER_DENSE.items():
            for n in dense:
                names += [f"h.{i}.{mod}.{n}.weight", f"h.{i}.{mod}.{n}.scale"]
        names += [f"h.{i}.attention_norm.weight", f"h.{i}.ffn_norm.weight"]
    return names


def _lookup(tree, path, scan_axis):
    """The leaf at `path` (a layer as an int) of a scanned or unscanned
    tree, or None where the tree has no such leaf."""
    node = tree
    for j, key in enumerate(path):
        if isinstance(key, int):
            if "scan_decoder" in node:
                leaf = _lookup(node["scan_decoder"], path[j + 1:], scan_axis)
                if leaf is None:
                    return None
                if isinstance(leaf, torch.Tensor):
                    return leaf.select(scan_axis, key)
                return np.take(np.asarray(leaf), key, axis=scan_axis)
            key = str(key)
        if not isinstance(node, Mapping) or key not in node:
            return None
        node = node[key]
    return node


def convert_flax_params(params, config, dtype=None, device=None, mesh=None):
    """Returns {name: tensor} for `LLaMAForCausalLM.load_state_dict`
    (float weights cast to `dtype` when given; int8 weights and their
    scales keep their types). With `device`, each leaf is copied there as
    it is and transposed there: a card transposes a 7b's kernels in
    milliseconds, a host in seconds. On `mesh`, a leaf that is split over
    tp is converted on the host and only this rank's slice
    (`parallel.partition`) goes to `device`. A tree that holds only some
    params (optax's moments of a frozen-base finetune) gives only those."""
    if "params" in params:
        params = params["params"]
    if mesh is not None and mesh.tp > 1:   # a leaf at a time: converted, cut, placed
        return {k: local_slice(k, v, mesh).to(device)
                for k, v in _converted(params, config, dtype, None)}
    return dict(_converted(params, config, dtype, device))


def leaf_params(path, leaf, config, dtype=None, device=None):
    """(name, tensor) of the port's parameters in ONE leaf of a flax param
    tree: `path` its keys under "params" (scanned or not: a scanned leaf
    gives one tensor a layer), converted as `convert_flax_params` converts
    (the checkpoint's leaf-by-leaf load)."""
    tree = {}
    _insert(tree, tuple(path), leaf)
    return _converted(tree, config, dtype, device)


def _converted(params, config, dtype, device):
    """(name, tensor) of `convert_flax_params`, one leaf at a time."""

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

    for name in _candidate_names(config):
        path, dense = _flax_key(name)
        leaf = _lookup(params, path, config.param_scan_axis)
        if leaf is None:
            continue
        if path[-1] == "scale":   # of an int8 kernel from quantize_params_int8
            yield name, t(leaf, cast=False).float()
        else:
            yield name, t(leaf, transpose=dense)


def _state_dict(node):
    """An optax state (namedtuples, tuples, dicts) in flax's `to_state_dict`
    form: nested dicts keyed by field name or index, empty states and
    `MaskedNode`s dropped, as `flatten_dict` drops them. A dict of that
    form (a checkpoint's) comes back as it is."""
    if isinstance(node, Mapping):
        items = ((str(k), v) for k, v in node.items())
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        items = ((f, getattr(node, f)) for f in node._fields)
    elif isinstance(node, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(node))
    else:
        return node
    out = {}
    for k, v in items:
        v = _state_dict(v)
        if not (isinstance(v, dict) and not v):
            out[k] = v
    return out


def convert_optax_state(opt_state, config, device=None):
    """The JAX trainer's optax state (`lwm_tpu/optim.py`: clip + adamw, or
    the PaLM chain, optionally inside MultiSteps, and inside
    multi_transform under a frozen mask), as optax's namedtuples or a
    checkpoint's state-dict form → the `named_state` of the port's
    optimizer: {"count", "mini_step", "gradient_step", "acc"} plus AdamW's
    "mu" and "nu" or PaLM's "v" and "ema", per-param state dicts (the
    momentum keeps its dtype: bf16 with `bf16_momentum`) on `device` when
    given. Counts are ints."""
    state = _state_dict(opt_state)
    if "inner_states" in state:   # multi_transform: the trainable group
        state = state["inner_states"]["False"]["inner_state"]
    multi = None
    if "inner_opt_state" in state:   # MultiSteps
        multi, state = state, state["inner_opt_state"]
    chain = state["1"]

    def moments(node, key):
        return convert_flax_params(node.get(key, {}), config, device=device)

    out = dict(count=int(np.asarray(chain["0"]["count"])),
               mini_step=0 if multi is None else int(np.asarray(multi["mini_step"])),
               gradient_step=0 if multi is None else int(np.asarray(multi["gradient_step"])),
               acc={} if multi is None else moments(multi, "acc_grads"))
    if "v" in chain["0"]:   # adafactor's FactoredState, then its EMA
        out.update(v=moments(chain["0"], "v"), ema=moments(chain["3"], "ema"))
    elif "mu" in chain["0"]:
        out.update(mu=moments(chain["0"], "mu"), nu=moments(chain["0"], "nu"))
    else:
        raise ValueError(f"no adamw or adafactor state in the optax state: {sorted(chain['0'])}")
    return out


def _t(x):
    return (lambda: materialize(x).t()) if callable(x) else x.t()


def _sorted(tree):
    return {k: _sorted(tree[k]) if isinstance(tree[k], dict) else tree[k] for k in sorted(tree)}


def materialize(leaf):
    """A leaf of `flax_params_tree` as a tensor (a lazy leaf is called)."""
    return leaf() if callable(leaf) else leaf


def _stack(parts, axis):
    return torch.stack([materialize(p) for p in parts], dim=axis)


def _insert(tree, path, leaf):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def flax_params_tree(sd, config):
    """The inverse of `convert_flax_params`: a state dict ({name: tensor or
    a zero-argument callable making one}, any device; all of a model's
    params or some of them) → the flax param tree (without the top-level
    "params" key), dense weights as [in, out] kernels (transposed views),
    the layers stacked on `config.param_scan_axis` under
    `transformer/h/scan_decoder` when `config.scan_layers`, else under
    `transformer/h/{i}`; keys sorted. A stacked leaf is lazy, a callable
    that stacks when called (see `materialize`): the checkpoint writer
    makes one at a time, so a 7b train state never holds two stacked
    copies of itself."""
    tree, stacked = {}, {}
    for name, x in sd.items():
        path, dense = _flax_key(name)
        leaf = _t(x) if dense else x
        if len(path) > 2 and path[1] == "h":
            if config.scan_layers:
                stacked.setdefault(path[3:], {})[path[2]] = leaf
                continue
            path = (*path[:2], str(path[2]), *path[3:])
        _insert(tree, path, leaf)
    layers = range(config.num_hidden_layers)
    for sub, got in stacked.items():
        if sorted(got) != list(layers):
            raise ValueError(f"a scanned tree needs {'/'.join(sub)} of every layer, "
                             f"got layers {sorted(got)}")
        _insert(tree, ("transformer", "h", "scan_decoder", *sub),
                functools.partial(_stack, [got[i] for i in layers], config.param_scan_axis))
    return _sorted(tree)


def _map_leaves(tree, fn):
    return {k: _map_leaves(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def optax_state_tree(named, params, config, kind="adamw", mu_dtype=torch.float32,
                     accumulate_gradient_steps=1, multi_transform=False):
    """The `named_state()` of the port's optimizer → flax's `to_state_dict`
    of the JAX trainer's optax state (`lwm_tpu/optim.py`), its empty states
    dropped as `flatten_dict` drops them. AdamW (clip_by_global_norm +
    adamw):

        {"1": {"0": {"count", "mu": {"params": ...}, "nu": {"params": ...}},
               "2": {"count"}}}

    PaLM (clip + adafactor's FactoredState, its schedule's count and EMA +
    the scheduled weight decay's count; `v_row` and `v_col` are
    adafactor's one-element placeholders of an unfactored moment, one a
    leaf, scanned leaves included):

        {"1": {"0": {"count", "v_row", "v_col", "v"}, "1": {"count"},
               "3": {"count", "ema"}}, "2": {"count"}}

    inside {"mini_step", "gradient_step", "inner_opt_state", "acc_grads"}
    when `accumulate_gradient_steps` > 1 (`optax.MultiSteps`), and that
    inside {"inner_states": {"False": {"inner_state": ...}}} with
    `multi_transform` (a frozen mask: `params` then holds only the
    trainable params, the only leaves its trees have). Counts are int32
    scalars; a moment not made yet (no update so far) is zeros shaped like
    `params` ({name: tensor}), the momentum in `mu_dtype`, made lazily as
    the stacked leaves are."""
    def moments(key, dtype=None):
        got = named.get(key, {})
        return {"params": flax_params_tree(
            {n: got[n] if n in got else functools.partial(torch.zeros_like, p, dtype=dtype)
             for n, p in params.items()}, config)}

    count = np.int32(named["count"])
    if kind == "adamw":
        state = {"1": {"0": {"count": count, "mu": moments("mu", mu_dtype), "nu": moments("nu")},
                       "2": {"count": count}}}
    elif kind == "palm":
        dtype = next(iter(params.values())).dtype if params else torch.float32
        placeholder = {"params": _map_leaves(flax_params_tree(params, config),
                                             lambda _: torch.zeros(1, dtype=dtype))}
        factored = {"count": count, "v_row": placeholder, "v_col": placeholder,
                    "v": moments("v")}
        ema = {"count": count, "ema": moments("ema", mu_dtype)}
        state = {"1": {"0": factored, "1": {"count": count}, "3": ema}, "2": {"count": count}}
    else:
        raise ValueError(f"unknown optimizer kind: {kind}")
    if accumulate_gradient_steps > 1:
        state = {"mini_step": np.int32(named["mini_step"]),
                 "gradient_step": np.int32(named["gradient_step"]),
                 "inner_opt_state": state, "acc_grads": moments("acc")}
    if multi_transform:
        state = {"inner_states": {"False": {"inner_state": state}}}
    return state


# VQGAN (`lwm_tpu/models/vqgan.py`): the port's modules carry the flax
# auto-names, so a leaf's path is its module path; conv kernels [kh, kw,
# in, out] become [out, in, kh, kw], a GroupNorm's `scale` is its `weight`.
_VQGAN_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
               "embeddings": "embeddings"}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flat(v, (*prefix, k))
        else:
            yield (*prefix, k), v


def vqgan_param_name(path, shape):
    """A flax VQGAN leaf (its path as a tuple of keys, its shape) → (the
    port's parameter name, its shape there)."""
    if path[-1] not in _VQGAN_LEAF:
        raise ValueError(f"VQGAN leaf {'/'.join(path)}: not a kernel, bias, scale or codebook")
    shape = tuple(shape)
    if path[-1] == "kernel":
        shape = (shape[3], shape[2], shape[0], shape[1])
    return ".".join((*path[:-1], _VQGAN_LEAF[path[-1]])), shape


def vqgan_params_from_flax(tree, config=None):
    """The flax VQGAN param tree (nested dicts of arrays, with or without a
    top-level "params" key) → the state dict of `models.vqgan.VQGANModel(
    config)` (the released architecture when None) as fp32 CPU tensors.
    Every leaf maps to exactly one parameter of the right shape, and every
    parameter has its leaf; anything else raises."""
    from lwm_tpu_torch.models.vqgan import VQGANModel

    if "params" in tree and len(tree) == 1:
        tree = tree["params"]
    want = {k: tuple(v.shape) for k, v in VQGANModel(config, device="meta").state_dict().items()}
    sd = {}
    for path, leaf in _flat(tree):
        x = torch.from_numpy(np.array(leaf, dtype=np.float32))
        name, shape = vqgan_param_name(path, x.shape)
        if want.get(name) != shape:
            raise ValueError(f"VQGAN leaf {'/'.join(path)} {tuple(x.shape)}: the model has "
                             f"{name} {want.get(name)}")
        sd[name] = x.permute(3, 2, 0, 1).contiguous() if path[-1] == "kernel" else x
    missing = sorted(set(want) - set(sd))
    if missing:
        raise ValueError(f"VQGAN tree lacks {len(missing)} params: {missing[:5]}")
    return sd


def vqgan_params_to_flax(sd):
    """The inverse: a VQGANModel state dict → the flax param tree (no
    "params" key) of fp32 numpy arrays, keys sorted, as the released pickle
    holds it."""
    to_leaf = {"weight": "kernel", "bias": "bias", "embeddings": "embeddings"}
    tree = {}
    for name, x in sd.items():
        parts = name.split(".")
        x = x.detach().float().cpu()
        leaf = to_leaf[parts[-1]]
        if leaf == "kernel" and x.dim() == 1:
            leaf = "scale"   # a GroupNorm's
        elif leaf == "kernel":
            x = x.permute(2, 3, 1, 0)
        _insert(tree, (*parts[:-1], leaf), np.ascontiguousarray(x.numpy()))
    return _sorted(tree)


# the globals a pickle of numpy arrays in nested dicts needs
_PICKLE_BUILTINS = frozenset(("dict", "list", "tuple", "set", "frozenset", "int", "float",
                              "complex", "bool", "str", "bytes", "bytearray"))
_PICKLE_NUMPY = frozenset(("_reconstruct", "ndarray", "dtype", "scalar", "_frombuffer"))


class _VQGANUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        top = module.split(".")[0]
        if module == "builtins" and name in _PICKLE_BUILTINS:
            return super().find_class(module, name)
        if top == "numpy" and name in _PICKLE_NUMPY:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"the VQGAN pickle holds {module}.{name}: only builtins and numpy arrays are "
            "read (a flax or jax object must be saved as numpy, e.g. jax.device_get)")


def load_vqgan_pickle(path):
    """The released VQGAN params (`lwm_tpu/models/vqgan.py:44-45`: a pickle
    of the flax param tree) through a restricted unpickler that admits
    builtins and numpy and raises, naming the class, on anything else."""
    with open_file(path, "rb") as f:
        return _VQGANUnpickler(f).load()


def save_vqgan_pickle(sd, path):
    """A VQGANModel state dict as the released pickle: the flax tree of
    numpy arrays (`vqgan_params_to_flax`)."""
    with open_file(path, "wb") as f:
        pickle.dump(vqgan_params_to_flax(sd), f)
