"""Chunk-streamed checkpoints: read and write the JAX package's streams.

Counterpart of `lwm_tpu/checkpoint.py`, without msgpack, flax or JAX
(`utils/msgpack.py` carries the subset the streams use). The format (v2):

    {"format": "lwm-tpu-ckpt", "version": 2}                  # header
    ["leaf", [path...], dtype_name, [shape...], n_chunks]     # per leaf
    <raw bytes> * n_chunks                                    #   "
    ["obj", [path...], msgpack-packable value]                # non-arrays

Leaves are split into chunks of at most `chunk_bytes` (256 MiB by
default): rows along axis 0, or the flattened elements when one row is
larger. `save_stream` writes the JAX writer's bytes for the same leaves
(`:90-134`); `iter_stream` and `load_stream` read v2 and v1 streams
(`:137-197`), v1 being the `(path, flax-serialized bytes)` records of
released LWM checkpoints, one leaf at a time: the file is never held whole.

Leaves load as numpy arrays, bfloat16 ones as `torch.bfloat16` tensors
(numpy has no bfloat16); 0-d leaves as numpy scalars (0-d tensors for
bfloat16). `load_trainstate_checkpoint` dispatches the `params::`,
`trainstate_params::`, `flax_params::` and `trainstate::` specs
(`:286-325`); its params tree feeds `utils/convert.py` scanned or not.

`StreamingCheckpointer` is the trainer's (`:200-325`): `save_all` writes
`metadata[_step].pkl`, `dataset[_step].pkl` and `streaming_train_state` (with
`save_optimizer_state`) or `streaming_params`, a milestone with the `_step`
suffix; the train state is the JAX trainer's tree (`train_state_tree`:
flax's `to_state_dict` of a `TrainState` — `step`, `params/params/...`,
`opt_state/...`) and its stream is the JAX writer's bytes for the same
state. `load_into` reads any spec into a model and its optimizer one leaf
at a time (`iter_stream`; a `flax_params::` file is one blob): each leaf is
converted, cast to its tensor's own dtype, as the JAX trainer's shard
functions cast to their target's, and placed before the next is read. The
default `float_dtype="bf16"` rounds every float leaf on save, the
optimizer's moments included, as the reference does.

On a mesh whose ranks hold parts of the leaves (tp slices, shards over
fsdp × sp: `parallel.fsdp`) the stream is the one device's: every rank
walks the tree in the writer's order and each leaf, params and moments,
is gathered from the ranks' parts as rank 0 writes it and freed after
(`checkpoint_gathers`); a load cuts each whole leaf to the rank's part.
So a checkpoint saved on any mesh loads on any other, and on one device.
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np
import torch

from lwm_tpu_torch.utils import msgpack
from lwm_tpu_torch.parallel.fsdp import placements
from lwm_tpu_torch.parallel.mesh import mesh_of
from lwm_tpu_torch.utils.convert import flax_params_tree, leaf_params, optax_state_tree
from lwm_tpu_torch.utils.dtypes import get_float_dtype_by_name
from lwm_tpu_torch.utils.flags import merge_config
from lwm_tpu_torch.utils.io import save_pickle

_HEADER = {"format": "lwm-tpu-ckpt", "version": 2}
DEFAULT_CHUNK_BYTES = 256 * 2**20
_FLOAT_DTYPES = ("bfloat16", "float16", "float32", "float64")
_TORCH_NAMES = {torch.bfloat16: "bfloat16", torch.float16: "float16", torch.float32: "float32",
                torch.float64: "float64", torch.int8: "int8", torch.uint8: "uint8",
                torch.int16: "int16", torch.int32: "int32", torch.int64: "int64",
                torch.bool: "bool"}


def _chunk_ranges(shape, itemsize, chunk_bytes):
    """(flat, start, stop) slices covering the array, as the JAX writer
    plans them: rows of axis 0, or the flattened elements when one row
    exceeds the budget; a 0-d leaf is one flat element."""
    if not shape:
        yield (True, 0, 1)
        return
    n_elems = int(np.prod(shape, dtype=np.int64))
    row_bytes = (n_elems // shape[0] if shape[0] else 0) * itemsize
    if row_bytes > chunk_bytes:
        step = max(1, chunk_bytes // itemsize)
        for start in range(0, n_elems, step):
            yield (True, start, min(start + step, n_elems))
    else:
        rows = max(1, chunk_bytes // max(1, row_bytes))
        for start in range(0, shape[0], rows):
            yield (False, start, min(start + rows, shape[0]))


def _host_buffer(chunk):
    """A C-contiguous host numpy array of a chunk's bytes: a tensor is made
    contiguous on its own device first (a kernel's transpose runs on the
    card, not the host), then copied over; bfloat16 goes by its bits."""
    if isinstance(chunk, torch.Tensor):
        chunk = chunk.contiguous().cpu()
        if chunk.dtype == torch.bfloat16:
            chunk = chunk.view(torch.int16)
        return chunk.numpy()
    return np.ascontiguousarray(chunk)


def _write_leaf(fout, key, value, float_dtype, chunk_bytes):
    if callable(value):   # a lazy leaf of utils.convert.flax_params_tree
        value = value()
    if value is None or isinstance(value, (str, bytes, bool)):
        fout.write(msgpack.pack(["obj", list(key), value]))
        return
    if isinstance(value, torch.Tensor):
        value = value.detach()
        name = _TORCH_NAMES[value.dtype]
        if float_dtype and name in _FLOAT_DTYPES:
            value = value.to(get_float_dtype_by_name(float_dtype))
            name = _TORCH_NAMES[value.dtype]
        itemsize = value.element_size()
    else:
        value = np.asarray(value)
        if value.dtype == object:
            raise TypeError(f"cannot checkpoint object-dtype leaf at {key}")
        if float_dtype and value.dtype.name in _FLOAT_DTYPES:
            value = torch.from_numpy(np.array(value)).to(get_float_dtype_by_name(float_dtype))
            name, itemsize = _TORCH_NAMES[value.dtype], value.element_size()
        else:
            name, itemsize = value.dtype.name, value.dtype.itemsize
    shape = tuple(int(d) for d in value.shape)
    plan = list(_chunk_ranges(shape, itemsize, chunk_bytes))
    fout.write(msgpack.pack(["leaf", list(key), name, list(shape), len(plan)]))
    flat = None
    for is_flat, start, stop in plan:
        if is_flat and flat is None:
            flat = value.reshape(-1) if shape else value.reshape(1)
        chunk = _host_buffer(flat[start:stop] if is_flat else value[start:stop])
        fout.write(msgpack.bin_header(chunk.nbytes))   # one chunk on the host at a time
        fout.write(chunk.reshape(-1).data)


def save_stream(flat_state, path, float_dtype=None, chunk_bytes=DEFAULT_CHUNK_BYTES):
    """Write a flat {path tuple: leaf} dict as a v2 stream. Leaves: numpy
    arrays, tensors (on any device, copied to the host a chunk at a time),
    Python numbers (as numpy makes them arrays), zero-argument callables
    returning one of those (made as the leaf is written), and
    None/str/bytes/bool as `obj` records. `float_dtype` ('bf16', ...) casts
    float leaves."""
    with open(path, "wb") as fout:
        fout.write(msgpack.pack(_HEADER))
        for key, value in flat_state.items():
            _write_leaf(fout, key, value, float_dtype, chunk_bytes)


def _read_leaf(unpacker, dtype_name, shape, n_chunks):
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    bf16 = dtype_name == "bfloat16"
    dst = np.empty(n, dtype=np.int16 if bf16 else np.dtype(dtype_name))
    view = memoryview(dst.view(np.uint8))
    offset = 0
    for _ in range(n_chunks):
        offset += unpacker.read_bin_into(view[offset:])
    if offset != view.nbytes:
        raise ValueError(f"leaf of {view.nbytes} bytes got {offset}")
    if bf16:
        arr = torch.from_numpy(dst).view(torch.bfloat16).reshape(tuple(shape))
        return arr if shape else arr.reshape(())
    arr = dst.reshape(tuple(shape))
    return arr if shape else arr[()]


def iter_stream(path):
    """The (key tuple, leaf) records of a v1 or v2 stream in file order,
    one leaf read at a time."""
    with open(path, "rb") as fin:
        unpacker = msgpack.Unpacker(fin)
        try:
            first = next(unpacker)
        except StopIteration:
            return
        if not isinstance(first, dict):   # v1: (path, flax-serialized bytes) records
            key, value = first
            yield tuple(key), msgpack.flax_restore(value)
            for key, value in unpacker:
                yield tuple(key), msgpack.flax_restore(value)
            return
        if first.get("format") != "lwm-tpu-ckpt":   # v2 header
            raise ValueError(f"unrecognized checkpoint header: {first}")
        if first.get("version") != 2:
            raise ValueError(f"unsupported checkpoint version: {first.get('version')}")
        for record in unpacker:
            kind = record[0]
            if kind == "leaf":
                _, key, dtype_name, shape, n_chunks = record
                yield tuple(key), _read_leaf(unpacker, dtype_name, shape, n_chunks)
            elif kind == "obj":
                yield tuple(record[1]), record[2]
            else:
                raise ValueError(f"unknown checkpoint record kind: {kind!r}")


def load_stream(path, remove_prefix=None):
    """Read a v1 or v2 stream into a flat {path tuple: leaf} dict, one
    leaf at a time; with `remove_prefix`, only the leaves under it, the
    prefix removed."""
    prefix = () if remove_prefix is None else tuple(remove_prefix)
    return {key[len(prefix):]: value for key, value in iter_stream(path)
            if key[:len(prefix)] == prefix}


def flatten_dict(tree, prefix=()):
    """{a: {b: x}} → {(a, b): x} (flax.traverse_util.flatten_dict)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):   # an empty dict leaves no leaf, as in flax
            out.update(flatten_dict(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def unflatten_dict(flat):
    """{(a, b): x} → {a: {b: x}}."""
    tree = {}
    for key, value in flat.items():
        node = tree
        for k in key[:-1]:
            node = node.setdefault(k, {})
        node[key[-1]] = value
    return tree


def save_tree(tree, path, float_dtype=None, chunk_bytes=DEFAULT_CHUNK_BYTES):
    """A nested dict as a v2 stream (`save_train_state_to_file`)."""
    save_stream(flatten_dict(tree), path, float_dtype, chunk_bytes)


def load_checkpoint(path, remove_dict_prefix=None):
    """A stream as a nested dict (`load_checkpoint` without a target)."""
    return unflatten_dict(load_stream(path, remove_dict_prefix))


def load_flax_checkpoint(path):
    """A single-blob flax msgpack file (`flax.serialization.msgpack_restore`)."""
    with open(path, "rb") as fin:
        return msgpack.flax_restore(fin.read())


def load_trainstate_checkpoint(load_from, disallow_trainstate=False):
    """'TYPE::PATH' → (train_state, {"params": params}), one of them None,
    as `StreamingCheckpointer.load_trainstate_checkpoint` without a target:
    `trainstate::` gives the whole tree, `trainstate_params::` its
    params/params subtree, `params::` a params stream, `flax_params::` a
    single-blob flax file."""
    load_type, sep, load_path = load_from.partition("::")
    if not sep:
        raise ValueError(f"checkpoint spec {load_from!r} has no TYPE:: prefix")
    if disallow_trainstate and load_type == "trainstate":
        raise ValueError("trainstate loading disallowed here")
    if load_type == "trainstate":
        return load_checkpoint(load_path), None
    if load_type == "trainstate_params":
        params = load_checkpoint(load_path, remove_dict_prefix=("params", "params"))
    elif load_type == "params":
        params = load_checkpoint(load_path)
    elif load_type == "flax_params":
        params = load_flax_checkpoint(load_path)
    else:
        raise ValueError(f"invalid load_from type: {load_type}")
    return None, {"params": params}


def checkpoint_gathers(state):
    """Whether saving `state` (a `train.TrainState`) gathers leaves from
    the ranks' parts, so that every rank takes part in it."""
    mesh = mesh_of(state.model)
    return mesh is not None and any(
        pl.over_tp or pl.over_shard for pl in placements(state.model).values())


def _whole(pl, part):
    """A lazy leaf: the whole leaf of `part` (gathered when it is made)."""
    if pl is None or not (pl.over_tp or pl.over_shard):
        return part
    return functools.partial(pl.whole, part)


def _params_for_saving(model):
    """{name: the whole param, or a callable gathering it} (`_whole`)."""
    places = placements(model) if mesh_of(model) is not None else {}
    return {n: _whole(places.get(n), p) for n, p in model.named_parameters()}


def train_state_tree(state):
    """`train.TrainState` (model, optimizer, step) → the JAX trainer's train
    state tree: {"step": int32, "params": {"params": flax tree},
    "opt_state": optax tree} (`utils/convert.py`), its stacked leaves, its
    unmade moments and, on a mesh, its gathered leaves lazy."""
    model, opt = state.model, state.optimizer
    named = opt.named_state()
    params = {opt.names[p]: p for p in opt.params}
    if opt.placement is not None:   # parts → whole leaves, made as they are written
        for key in (*opt.MOMENTS, "acc"):
            if key not in named or (key == "acc" and opt.k == 1):
                continue
            got = named[key]
            dtype = opt.mu_dtype if key == opt.MOMENTS[0] else None
            named[key] = {
                n: _whole(opt.placement[p], got[n]) if n in got else functools.partial(
                    torch.zeros, opt.placement[p].shape, dtype=dtype or p.dtype, device=p.device)
                for n, p in params.items()}
    return {
        "step": np.int32(state.step),
        "params": {"params": flax_params_tree(_params_for_saving(model), model.config)},
        "opt_state": optax_state_tree(
            named, params, model.config,
            kind=opt.KIND, mu_dtype=opt.mu_dtype, accumulate_gradient_steps=opt.k,
            multi_transform=opt.multi_transform),
    }


def _drain(tree):
    """Make every lazy leaf of `tree` in the writer's order and drop it: a
    rank that does not write takes part in the gathers rank 0's writer
    makes."""
    for value in flatten_dict(tree).values():
        if callable(value):
            value()


def _stream_records(load_type, path):
    """(key, leaf) of a spec's file, a leaf at a time: a param's key is
    ("params", its flax path...), a train state's other keys as written
    ("step", "opt_state/..."); a `flax_params::` file is one blob, decoded
    whole."""
    if load_type == "flax_params":
        params = load_flax_checkpoint(path)
        yield from flatten_dict(params.get("params", params), ("params",)).items()
        return
    for key, leaf in iter_stream(path):
        if load_type == "params":
            yield (key if key[:1] == ("params",) else ("params", *key)), leaf
        elif key[:2] == ("params", "params"):   # a train state's params
            yield key[1:], leaf
        elif load_type == "trainstate":
            yield key, leaf


def _opt_record(key):
    """A train state's key under "opt_state" → (what, param path): a count
    ("count", "mini_step", "gradient_step"; path None), a moment ("mu",
    "nu", "v", "ema", "acc"; its path under the params), or None (optax's
    other counts and `v_row`/`v_col` placeholders). The layout is
    `utils.convert.optax_state_tree`'s."""
    k = list(key)
    if k[:3] == ["inner_states", "False", "inner_state"]:
        k = k[3:]
    if k[:1] in (["mini_step"], ["gradient_step"]):
        return k[0], None
    if k[:2] == ["acc_grads", "params"]:
        return "acc", tuple(k[2:])
    if k[:1] == ["inner_opt_state"]:
        k = k[1:]
    if k[:3] == ["1", "0", "count"]:
        return "count", None
    if k[:2] == ["1", "0"] and len(k) > 3 and k[2] in ("mu", "nu", "v") and k[3] == "params":
        return k[2], tuple(k[4:])
    if k[:3] == ["1", "3", "ema"] and k[3:4] == ["params"]:
        return "ema", tuple(k[4:])
    return None


class StreamingCheckpointer:
    """The trainer's checkpointer; see the module note."""

    DEFAULTS = dict(float_dtype="bf16", save_optimizer_state=False,
                    chunk_bytes=DEFAULT_CHUNK_BYTES)

    @classmethod
    def get_default_config(cls, updates=None):
        return merge_config(cls.DEFAULTS, updates, "checkpointer")

    def __init__(self, config, checkpoint_dir, enable=True):
        self.config = self.get_default_config(config)
        self.checkpoint_dir = checkpoint_dir
        self.enable = enable

    def save_checkpoint(self, tree, filename):
        if self.enable:
            save_tree(tree, os.path.join(self.checkpoint_dir, filename),
                      float_dtype=self.config["float_dtype"],
                      chunk_bytes=self.config["chunk_bytes"])

    def save_pickle(self, obj, filename):
        if self.enable:
            save_pickle(obj, os.path.join(self.checkpoint_dir, filename))

    def save_all(self, state, metadata=None, dataset=None, milestone=False):
        """Returns the seconds the state's stream took to write. A rank that
        does not write (`enable` False) takes part in the gathers when the
        state's leaves are parts (`checkpoint_gathers`) and else returns."""
        if not self.enable and not checkpoint_gathers(state):
            return 0.0
        if self.config["save_optimizer_state"]:
            tree, name = train_state_tree(state), "streaming_train_state"
        else:
            tree = flax_params_tree(_params_for_saving(state.model), state.model.config)
            name = "streaming_params"
        suffix = f"_{state.step}" if milestone else ""   # milestones are kept
        self.save_pickle(metadata, f"metadata{suffix}.pkl")
        self.save_pickle(dataset, f"dataset{suffix}.pkl")
        t0 = time.perf_counter()
        if self.enable:
            self.save_checkpoint(tree, f"{name}{suffix}")
        else:
            _drain(tree)
        return time.perf_counter() - t0

    @staticmethod
    @torch.no_grad()
    def load_into(load_from, state):
        """Load a 'TYPE::PATH' spec into `state` (train.TrainState): the
        params of any spec into the model; with `trainstate::`, also the
        optimizer's state (`optim` `load_moment`, then its counts through
        `load_named_state`) and the step count. A leaf at a time: each is
        converted, cut to this rank's part on a mesh, and placed before the
        next is read. Returns the spec's type."""
        load_type, sep, path = load_from.partition("::")
        if not sep:
            raise ValueError(f"checkpoint spec {load_from!r} has no TYPE:: prefix")
        if load_type not in ("trainstate", "trainstate_params", "params", "flax_params"):
            raise ValueError(f"invalid load_from type: {load_type}")
        model, opt = state.model, state.optimizer
        cfg = model.config
        device = model.wte.weight.device
        named = dict(model.named_parameters())
        places = placements(model)
        on_mesh = mesh_of(model) is not None
        loaded, counts, kinds = set(), {}, set()
        opt_names = set(opt.names.values())
        for key, leaf in _stream_records(load_type, path):
            if key[:1] == ("step",):
                state.step = int(np.asarray(leaf))
            elif key[:1] == ("params",):
                for name, value in leaf_params(key[1:], leaf, cfg, device=device):
                    if name not in named:
                        raise ValueError(f"{load_from}: {name} is not a parameter of the model")
                    p = named[name]
                    if on_mesh:
                        value = places[name].local_part(value)
                    if value.shape != p.shape:
                        raise ValueError(f"{load_from}: {name} is {tuple(value.shape)}, the "
                                         f"model's {tuple(p.shape)}")
                    p.copy_(value)
                    loaded.add(name)
            elif key[:1] == ("opt_state",):
                got = _opt_record(key[1:])
                if got is None:
                    continue
                what, sub = got
                if sub is None:
                    counts[what] = int(np.asarray(leaf))
                    continue
                kinds.add(what)
                if what not in (*opt.MOMENTS, "acc"):
                    continue   # the other optimizer's: load_named_state below refuses it
                for name, value in leaf_params(sub, leaf, cfg, device=device):
                    if name in opt_names:
                        opt.load_moment(what, name, value)
        missing = named.keys() - loaded
        if missing:
            raise ValueError(f"{load_from}: no weights for {sorted(missing)}")
        if load_type == "trainstate":
            opt.load_named_state({**counts, **{k: {} for k in kinds}})
        return load_type
