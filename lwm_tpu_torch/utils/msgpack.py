"""The subset of msgpack that the checkpoint streams use, with no dependency.

The JAX package writes its checkpoints with `msgpack` and reads the older
ones through flax (`lwm_tpu/checkpoint.py`); neither package is on the GPU
machine, so the port carries this reader and writer.

Types: nil, bool, every int width, float32/64, str, bin, array and map in
all their widths, and ext. `pack` encodes as `msgpack.Packer()` does by
default (`use_bin_type=True`, floats as float64, the narrowest int, str and
container header), so a stream written here is byte for byte the JAX
writer's. `Unpacker` decodes a file record by record and never holds the
file whole: a record's bytes are read as it is parsed, and a 7b leaf
arrives as 256 MiB `bin` chunks (`lwm_tpu/checkpoint.py:17-30`).

Flax's ext records (`flax.serialization._msgpack_ext_unpack`), which the v1
streams of released LWM checkpoints carry (`tests/fixtures/make_v1_golden.py`),
decode as flax decodes them: code 1 an ndarray packed as (shape, dtype name,
C-order bytes), code 2 a native complex packed as (real, imag), code 3 a
numpy scalar packed as code 1. Arrays come back as numpy arrays, except
bfloat16 ones, which numpy has no dtype for: they come back as
`torch.bfloat16` tensors built from their raw bytes.
"""

from __future__ import annotations

import io
import struct

import numpy as np
import torch


class ExtType:
    """An ext record with a code no hook claimed."""

    __slots__ = ("code", "data")

    def __init__(self, code, data):
        self.code, self.data = code, data

    def __eq__(self, other):
        return isinstance(other, ExtType) and (self.code, self.data) == (other.code, other.data)

    def __repr__(self):
        return f"ExtType({self.code}, {self.data!r})"


# ---------------------------------------------------------------------- pack

def _pack_into(out, obj):
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_header(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = memoryview(obj).cast("B")
        _pack_header(out, data.nbytes, None, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_header(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for x in obj:
            _pack_into(out, x)
    elif isinstance(obj, dict):
        _pack_header(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack_into(out, k)
            _pack_into(out, v)
    elif isinstance(obj, ExtType):
        _pack_ext(out, obj.code, obj.data)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def _pack_int(out, n):
    if 0 <= n < 0x80 or -32 <= n < 0:
        out += struct.pack(">b" if n < 0 else ">B", n)
    elif n >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2**64 - 1)):
            if n <= top:
                out += bytes([code]) + struct.pack(fmt, n)
                return
        raise OverflowError(f"int {n} is too big for msgpack")
    else:
        for code, fmt, low in ((0xD0, ">b", -2**7), (0xD1, ">h", -2**15),
                               (0xD2, ">i", -2**31), (0xD3, ">q", -2**63)):
            if n >= low:
                out += bytes([code]) + struct.pack(fmt, n)
                return
        raise OverflowError(f"int {n} is too small for msgpack")


def _pack_header(out, n, fix, fix_max, codes):
    """A length header: the fix form below fix_max, else 8/16/32-bit (a
    None code: that width does not exist for the type)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise OverflowError(f"length {n} is too big for msgpack")


def _pack_ext(out, code, data):
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_header(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code) + bytes(data)


def pack(obj):
    """msgpack bytes of nil/bool/int/float/str/bytes/list/tuple/dict/ExtType."""
    out = bytearray()
    _pack_into(out, obj)
    return bytes(out)


# -------------------------------------------------------------------- unpack

_FIXED = {  # code → (struct format, size)
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


class Unpacker:
    """Decode msgpack objects one at a time from a binary file (or bytes):
    `next(unpacker)` or iteration. `ext_hook(code, data)` turns ext records
    into values (default: `ExtType`)."""

    def __init__(self, f, ext_hook=None):
        self._f = io.BytesIO(f) if isinstance(f, (bytes, bytearray)) else f
        self._ext_hook = ext_hook or ExtType

    def _read(self, n):
        data = self._f.read(n)
        if len(data) != n:
            raise ValueError(f"msgpack stream ends inside a record ({len(data)} of {n} bytes)")
        return data

    def _len(self, size):
        return struct.unpack(_LEN[size], self._read(size))[0]

    def __iter__(self):
        return self

    def __next__(self):
        first = self._f.read(1)
        if not first:
            raise StopIteration
        return self._obj(first[0])

    def _obj(self, c):
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self._map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return self._array(c & 0x0F)
        if 0xA0 <= c <= 0xBF:
            return self._read(c & 0x1F).decode("utf-8")
        if c == 0xC0:
            return None
        if c in (0xC2, 0xC3):
            return c == 0xC3
        if c in _FIXED:
            fmt, size = _FIXED[c]
            return struct.unpack(fmt, self._read(size))[0]
        if c in (0xC4, 0xC5, 0xC6):          # bin 8/16/32
            return self._read(self._len(1 << (c - 0xC4)))
        if c in (0xD9, 0xDA, 0xDB):          # str 8/16/32
            return self._read(self._len(1 << (c - 0xD9))).decode("utf-8")
        if c in (0xDC, 0xDD):                # array 16/32
            return self._array(self._len(2 << (c - 0xDC)))
        if c in (0xDE, 0xDF):                # map 16/32
            return self._map(self._len(2 << (c - 0xDE)))
        if c in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):   # fixext 1/2/4/8/16
            return self._ext(1 << (c - 0xD4))
        if c in (0xC7, 0xC8, 0xC9):          # ext 8/16/32
            return self._ext(self._len(1 << (c - 0xC7)))
        raise ValueError(f"msgpack: unknown type byte 0x{c:02x}")

    def _array(self, n):
        return [self._next_obj() for _ in range(n)]

    def _map(self, n):
        out = {}
        for _ in range(n):
            k = self._next_obj()
            out[k] = self._next_obj()
        return out

    def _ext(self, n):
        code = struct.unpack(">b", self._read(1))[0]
        return self._ext_hook(code, self._read(n))

    def _next_obj(self):
        return self._obj(self._read(1)[0])


def unpackb(data, ext_hook=None):
    """The one object msgpack-encoded in `data`."""
    unpacker = Unpacker(bytes(data), ext_hook)
    obj = next(unpacker)
    if unpacker._f.read(1):
        raise ValueError("msgpack: extra data after the object")
    return obj


# ------------------------------------------------------------- flax ext codes

def _array_from_raw(buffer, dtype_name, shape):
    """An array of `dtype_name` from C-order raw bytes: numpy, or a
    `torch.bfloat16` tensor for bfloat16 (numpy has no such dtype)."""
    if dtype_name == "bfloat16":
        raw = torch.frombuffer(bytearray(buffer), dtype=torch.int16) if len(buffer) else \
            torch.zeros(0, dtype=torch.int16)
        return raw.view(torch.bfloat16).reshape(tuple(shape))
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(tuple(shape))


def _ndarray_from_bytes(data):
    shape, dtype_name, buffer = unpackb(data)
    return _array_from_raw(buffer, dtype_name, shape)


def flax_ext_hook(code, data):
    """`flax.serialization._msgpack_ext_unpack`: 1 ndarray, 2 native
    complex, 3 numpy scalar; other codes stay `ExtType`."""
    if code == 1:
        return _ndarray_from_bytes(data)
    if code == 2:
        re, im = unpackb(data)
        return complex(re, im)
    if code == 3:
        arr = _ndarray_from_bytes(data)
        return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
    return ExtType(code, data)


def _unchunk(d):
    """flax's chunked-array leaves ({'__msgpack_chunked_array__', 'shape',
    'chunks'}: arrays above flax's 2**30-byte record) back into arrays,
    as `flax.serialization._unchunk_array_leaves_in_place` does."""
    if not isinstance(d, dict):
        return d
    if "__msgpack_chunked_array__" in d:
        shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
        chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in d.items()}


def flax_restore(data):
    """`flax.serialization.msgpack_restore` (what `from_bytes(None, data)`
    returns): the tree with array leaves."""
    return _unchunk(unpackb(data, flax_ext_hook))
