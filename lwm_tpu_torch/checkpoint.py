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
(`:90-134`); `load_stream` reads v2 and v1 streams (`:137-197`), v1 being
the `(path, flax-serialized bytes)` records of released LWM checkpoints,
one leaf at a time: the file is never held whole.

Leaves load as numpy arrays, bfloat16 ones as `torch.bfloat16` tensors
(numpy has no bfloat16); 0-d leaves as numpy scalars (0-d tensors for
bfloat16). `load_trainstate_checkpoint` dispatches the `params::`,
`trainstate_params::`, `flax_params::` and `trainstate::` specs
(`:286-325`); its params tree feeds `utils/convert.py` scanned or not.
"""

from __future__ import annotations

import numpy as np
import torch

from lwm_tpu_torch.utils import msgpack
from lwm_tpu_torch.utils.dtypes import get_float_dtype_by_name

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


def _raw_bytes(chunk):
    """C-order bytes of a numpy array or a CPU tensor (bf16 by its bits)."""
    if isinstance(chunk, torch.Tensor):
        chunk = chunk.contiguous()
        if chunk.dtype == torch.bfloat16:
            chunk = chunk.view(torch.int16)
        return chunk.numpy().tobytes()
    return np.ascontiguousarray(chunk).tobytes()


def _write_leaf(fout, key, value, float_dtype, chunk_bytes):
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
        chunk = flat[start:stop] if is_flat else value[start:stop]
        if isinstance(chunk, torch.Tensor) and chunk.device.type != "cpu":
            chunk = chunk.cpu()   # one chunk on the host at a time
        fout.write(msgpack.pack(_raw_bytes(chunk)))


def save_stream(flat_state, path, float_dtype=None, chunk_bytes=DEFAULT_CHUNK_BYTES):
    """Write a flat {path tuple: leaf} dict as a v2 stream. Leaves: numpy
    arrays, tensors (on any device, copied to the host a chunk at a time),
    Python numbers (as numpy makes them arrays), and None/str/bytes/bool
    as `obj` records. `float_dtype` ('bf16', ...) casts float leaves."""
    with open(path, "wb") as fout:
        fout.write(msgpack.pack(_HEADER))
        for key, value in flat_state.items():
            _write_leaf(fout, key, value, float_dtype, chunk_bytes)


def _read_leaf(unpacker, dtype_name, shape, n_chunks):
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    bf16 = dtype_name == "bfloat16"
    dst = np.empty(n, dtype=np.int16 if bf16 else np.dtype(dtype_name))
    view = dst.view(np.uint8)
    offset = 0
    for _ in range(n_chunks):
        buf = next(unpacker)
        view[offset:offset + len(buf)] = np.frombuffer(buf, np.uint8)
        offset += len(buf)
    if offset != view.nbytes:
        raise ValueError(f"leaf of {view.nbytes} bytes got {offset}")
    if bf16:
        arr = torch.from_numpy(dst).view(torch.bfloat16).reshape(tuple(shape))
        return arr if shape else arr.reshape(())
    arr = dst.reshape(tuple(shape))
    return arr if shape else arr[()]


def _read_stream(unpacker, first, on_leaf):
    """Drive a v2 or v1 stream, calling on_leaf(key tuple, value)."""
    if isinstance(first, dict):   # v2 header
        if first.get("format") != "lwm-tpu-ckpt":
            raise ValueError(f"unrecognized checkpoint header: {first}")
        if first.get("version") != 2:
            raise ValueError(f"unsupported checkpoint version: {first.get('version')}")
        for record in unpacker:
            kind = record[0]
            if kind == "leaf":
                _, key, dtype_name, shape, n_chunks = record
                on_leaf(tuple(key), _read_leaf(unpacker, dtype_name, shape, n_chunks))
            elif kind == "obj":
                on_leaf(tuple(record[1]), record[2])
            else:
                raise ValueError(f"unknown checkpoint record kind: {kind!r}")
    else:                         # v1: (path, flax-serialized bytes) records
        key, value = first
        on_leaf(tuple(key), msgpack.flax_restore(value))
        for key, value in unpacker:
            on_leaf(tuple(key), msgpack.flax_restore(value))


def load_stream(path, remove_prefix=None):
    """Read a v1 or v2 stream into a flat {path tuple: leaf} dict, one
    leaf at a time; with `remove_prefix`, only the leaves under it, the
    prefix removed."""
    remove_prefix = None if remove_prefix is None else tuple(remove_prefix)
    out = {}

    def on_leaf(key, value):
        if remove_prefix is not None:
            if key[:len(remove_prefix)] != remove_prefix:
                return
            key = key[len(remove_prefix):]
        out[key] = value

    with open(path, "rb") as fin:
        unpacker = msgpack.Unpacker(fin)
        try:
            first = next(unpacker)
        except StopIteration:
            return out
        _read_stream(unpacker, first, on_leaf)
    return out


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
