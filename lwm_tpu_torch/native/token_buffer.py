"""ctypes binding of the token-packing buffer (`token_buffer.cpp`), the
counterpart of `lwm_tpu/native/token_buffer.py:17-147`.

The source is compiled at first use, never at import, by `g++ -O3 -shared`
into `lwm_tpu_torch/_build/` (gitignored), named by a hash of the source.
Where no compiler works, `native_available()` is False and the data
pipeline packs in Python: the two give the same batches byte for byte.
It is host code for the data loader, not a GPU kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "token_buffer.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)


def _build_lib():
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so_path = BUILD_DIR / f"token_buffer_{digest}.so"
    if not so_path.exists():
        tmp = so_path.with_name(f"{so_path.name}.tmp{os.getpid()}")
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(str(so_path))
    lib.tb_create.restype = ctypes.c_void_p
    lib.tb_create.argtypes = []
    lib.tb_destroy.restype = None
    lib.tb_destroy.argtypes = [ctypes.c_void_p]
    lib.tb_append.restype = None
    lib.tb_append.argtypes = [ctypes.c_void_p, _I32P, _F32P, ctypes.c_void_p, ctypes.c_int64]
    lib.tb_size.restype = ctypes.c_int64
    lib.tb_size.argtypes = [ctypes.c_void_p]
    lib.tb_emit.restype = ctypes.c_int32
    lib.tb_emit.argtypes = [ctypes.c_void_p, ctypes.c_int64, _I32P, _I32P, _F32P,
                            ctypes.c_void_p, ctypes.c_void_p]
    lib.tb_clear.restype = None
    lib.tb_clear.argtypes = [ctypes.c_void_p]
    return lib


def _get_lib():
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            _TRIED = True
            try:
                _LIB = _build_lib()
            except (OSError, subprocess.CalledProcessError):
                _LIB = None
    return _LIB


def native_available():
    return _get_lib() is not None


class NativeTokenBuffer:
    """Contiguous token / loss-mask stream; `emit` cuts one (batch, seq)
    batch with next-token targets and consumes batch·seq tokens. The
    source's vision-mask stream is left unused (null) until the vision
    pipeline is ported."""

    def __init__(self):
        self._lib = _get_lib()
        if self._lib is None:
            raise RuntimeError("native token buffer unavailable (g++ failed or is missing)")
        self._handle = self._lib.tb_create()

    def __del__(self):
        if getattr(self, "_handle", None) and self._lib is not None:
            self._lib.tb_destroy(self._handle)
            self._handle = None

    def __len__(self):
        return int(self._lib.tb_size(self._handle))

    def append(self, tokens, masks):
        tokens = np.ascontiguousarray(tokens, dtype=np.int32)
        masks = np.ascontiguousarray(masks, dtype=np.float32)
        if tokens.shape != masks.shape or tokens.ndim != 1:
            raise ValueError(f"tokens {tokens.shape} and masks {masks.shape} must be equal 1-D")
        self._lib.tb_append(self._handle, tokens.ctypes.data_as(_I32P),
                            masks.ctypes.data_as(_F32P), None, tokens.size)

    def emit(self, batch_size, seq_length):
        """A packed batch dict, or None while fewer than batch·seq + 1
        tokens are buffered."""
        chunk = batch_size * seq_length
        input_tokens = np.empty(chunk, np.int32)
        target_tokens = np.empty(chunk, np.int32)
        loss_masks = np.empty(chunk, np.float32)
        ok = self._lib.tb_emit(
            self._handle, chunk, input_tokens.ctypes.data_as(_I32P),
            target_tokens.ctypes.data_as(_I32P), loss_masks.ctypes.data_as(_F32P), None, None)
        if not ok:
            return None
        shape = (batch_size, seq_length)
        return {"input_tokens": input_tokens.reshape(shape),
                "target_tokens": target_tokens.reshape(shape),
                "loss_masks": loss_masks.reshape(shape)}

    def clear(self):
        self._lib.tb_clear(self._handle)
