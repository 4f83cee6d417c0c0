#!/usr/bin/env python3
"""Time copies of the fused flash-attention backward against each other.

    python3 scripts/time_flash_bwd.py [SRC.cu ...]

Each SRC is a copy of `lwm_tpu_torch/csrc/flash_bwd.cu` (a variant under
test; default: the package's own source) with the same C entry point
`lwm_flash_bwd`. Each is built by nvcc into a library of its own (all at
once), its ptxas register and spill lines are printed, it is held against
the plain twin at the train step's attention shape (b 2, seq 4096, 32
heads, d 128, causal, 300 right-padded keys in row 1; chip_smoke.py's
BWD_REL_TOL and BWD_COS_MIN), and then all are timed in turns, 1..N then
N..1, with CUDA events over 10 calls of the wrapper (dq_accum zeroing and
the bf16 rounding included). Needs one NVIDIA GPU and nvcc.
"""

import ctypes
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from lwm_tpu_torch.ops import _build, flash  # noqa: E402


def build(srcs):
    """nvcc each source into its own library, all started together.
    Returns [(library, ptxas lines)]."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for i, src in enumerate(srcs):
        so = out_dir / f"v{i}_{Path(src).stem}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(src)]
        jobs.append((so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True)))
    libs = []
    for so, proc in jobs:
        report = proc.communicate()[0]
        if proc.returncode != 0:   # reported; the other sources are still timed
            libs.append((None, [f"nvcc failed ({proc.returncode}):", *report.splitlines()[-30:]]))
            continue
        lib = ctypes.CDLL(str(so))
        lib.lwm_flash_bwd.argtypes = _build._SIGNATURES["lwm_flash_bwd"]
        lib.lwm_flash_bwd.restype = ctypes.c_int
        keep = ("entry function", "registers", "spill", "wgmma", "warning", "C75")
        libs.append((lib, [ln.strip() for ln in report.splitlines()
                           if any(t in ln for t in keep)]))
    return libs


def main():
    srcs = sys.argv[1:] or [str(_build.CSRC / "flash_bwd.cu")]
    smoke.phase_env()
    libs = build(srcs)
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    b, h, h_kv, d, S = 2, 32, 32, 128, 4096
    q, g = smoke._randn((b, S, h, d), gen), smoke._randn((b, S, h, d), gen)
    k, v = smoke._randn((b, S, h_kv, d), gen), smoke._randn((b, S, h_kv, d), gen)
    bias, valid = smoke._bwd_bias("per_key", b, S, gen)
    out, lse = flash.flash_attention_fwd(q, k, v, bias, causal=True)
    delta = torch.einsum("bqhd,bqhd->bhq", g.float(), out.float()).contiguous()
    args = (q, k, v, g, lse, delta, bias)
    want = flash.flash_attention_bwd_plain(*args)

    def call(lib):
        with mock.patch.object(_build, "load", lambda: lib):
            return flash.flash_attention_bwd(*args)

    for src, (lib, report) in zip(srcs, libs):
        print(f"== {src}", flush=True)
        for line in report:
            print(f"  ptxas {line}")
        if lib is None:
            continue
        got = call(lib)
        torch.cuda.synchronize()
        for name, a, r in zip(("dq", "dk", "dv"), got, want):
            rel = (a.float() - r.float()).abs().max().item() / r.float().abs().max().item()
            cos = smoke._cosine(a, r)
            ok = rel <= smoke.BWD_REL_TOL and cos >= smoke.BWD_COS_MIN
            print(f"  {name} max|Δ|/max|ref| {rel:.3e} cos {cos:.6f} {'ok' if ok else 'FAILS'}")
    built = [i for i, (lib, _) in enumerate(libs) if lib is not None]
    order = built + built[::-1]
    times = {i: [] for i in order}
    for i in order:
        times[i].append(smoke.time_ms(lambda: call(libs[i][0]), 10))
    pairs = smoke.attn_pairs(valid, S, 0)
    bound = smoke.bound_ms(0, 10 * d * h * pairs, smoke.H100_BF16_PEAK)[0]
    for i in built:
        src, ms = srcs[i], times[i]
        print(f"{src}: " + ", ".join(f"{t:.3f}" for t in ms) + f" ms ({100 * bound / min(ms):.1f}% "
              f"of the {bound:.3f} ms operations bound) [{smoke.card()}]")


if __name__ == "__main__":
    main()
