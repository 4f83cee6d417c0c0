"""Build the port's CUDA kernels and bind them with ctypes.

At first use, every `lwm_tpu_torch/csrc/*.cu` is compiled by its own nvcc
process, all started together, and the objects are linked into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds, not minutes) under `lwm_tpu_torch/_build/`, named by a hash of the
sources and flags so an edited source rebuilds. Nothing is built
when a module is imported; this machine-independent module needs no GPU
until `load()` is called.

Contract of every C entry point: it launches on the stream it is given
(the wrapper passes `torch.cuda.current_stream()`), allocates nothing, and
returns `cudaGetLastError()` after the launch; `check()` raises if that is
not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",  # -v: per-kernel registers and spills
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures, kept beside the sources' `extern "C"` declarations
_SIGNATURES = {
    "lwm_flash_fwd": [
        _P, _P, _P, _P, _P, _P,           # q, k, v, bias (or NULL), out, lse
        _I, _I, _I, _I, _I, _I,           # b, sq, skv, h, h_kv, d
        _L, _L, _L,                       # q strides (batch, seq, head)
        _L, _L, _L,                       # k strides
        _L, _L, _L,                       # v strides
        _L, _L,                           # bias strides (batch, q row)
        _I, _I, _I, _F,                   # causal, q_offset, kv_offset, scale
        _P,                               # cudaStream_t
    ],
    "lwm_flash_decode": [
        _P, _P, _P, _P, _P, _P, _P,       # q, k, v, k_scale, v_scale, mask, out
        _P, _P, _P,                       # m_out, l_out (or NULL), split scratch (fp32)
        _I, _I, _I, _I, _I, _I, _I, _I,   # b, h, h_kv, T, d, kv_len, int8 cache, split keys
        _L, _L,                           # q strides (batch, head)
        _L, _L, _L,                       # k/v strides (batch, head, seq)
        _F,                               # scale
        _P,                               # cudaStream_t
    ],
    "lwm_int8_matmul": [
        _P, _P, _P, _P,                   # x (bf16), w (int8), scale (fp32), out (bf16)
        _I, _I, _I,                       # m, f, d
        _P,                               # cudaStream_t
    ],
    "lwm_int8_gemv_max_m": [],            # K5's m threshold: the GEMV at or below, the GEMM above
    "lwm_w8a8_matmul": [
        _P, _P, _P, _P, _P,               # x_q (int8), x_scale, w (int8), w_scale, out (bf16)
        _I, _I, _I,                       # m, f, d
        _P,                               # cudaStream_t
    ],
    "lwm_w8a8_gemv_max_m": [],            # K6's m threshold: the GEMV at or below, the GEMM above
}
_BWD_INPUTS = [_P] * 7                    # q, k, v, g, lse, delta, bias (or NULL)
_BWD_DIMS = [
    _I, _I, _I, _I, _I, _I,               # b, sq, skv, h, h_kv, d
    _L, _L, _L,                           # q strides (batch, seq, head)
    _L, _L, _L,                           # k strides
    _L, _L, _L,                           # v strides
    _L, _L, _L,                           # g strides
    _L, _L,                               # bias strides (batch, q row)
    _I, _I, _I, _F,                       # causal, q_offset, kv_offset, scale
    _P,                                   # cudaStream_t
]
_SIGNATURES["lwm_flash_bwd"] = [*_BWD_INPUTS, _P, _P, _P, *_BWD_DIMS]  # + dq_accum (fp32), dk, dv


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels "
            "are built from lwm_tpu_torch/csrc at first use"
        )
    return str(path)


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path():
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liblwm_kernels_{h.hexdigest()[:16]}.so"


def build():
    """Compile csrc/*.cu unless the library for these sources exists.
    Returns nvcc's output (ptxas register/spill report), or '' when the
    library was already built."""
    so = library_path()
    if so.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    report = [proc.communicate()[0] for _, _, proc in jobs]  # wait for every nvcc first
    for (cmd, _, proc), out in zip(jobs, report):
        _check_nvcc(proc.returncode, cmd, out)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, "-shared", *NVCC_FLAGS, "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _check_nvcc(proc.returncode, cmd, proc.stdout)
    for _, obj, _ in jobs:
        obj.unlink()
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return "".join(report)


def _check_nvcc(rc, cmd, out):
    if rc != 0:
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")


@functools.cache
def load():
    """Build if needed, dlopen, and declare every entry's C signature."""
    build()
    lib = ctypes.CDLL(str(library_path()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc, name):
    """Raise if a C entry reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_handle(device):
    """The raw cudaStream_t of PyTorch's current stream on `device`."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
