#!/usr/bin/env python3
"""Time copies of a flash-attention kernel against each other.

    python3 scripts/time_flash.py fwd [SRC.cu ...]
    python3 scripts/time_flash.py bwd [SRC.cu ...]

Each SRC is a copy of `lwm_tpu_torch/csrc/flash_fwd.cu` (fwd: K1, C entry
`lwm_flash_fwd`) or `csrc/flash_bwd.cu` (bwd: the fused backward,
`lwm_flash_bwd`), a variant under test or another commit's kernel with the
same entry; default: the package's own source. Each is built by nvcc into a
library of its own (all at once; `#include`s resolve beside the copy, then
in the package's csrc), its ptxas register and spill lines are printed, it
is held against the plain twin, and then all are timed in turns, 1..N then
N..1, with CUDA events over calls of the wrapper. Shapes:
- fwd: chip_smoke.py's two timed K1 cases, a 2048-token admission over the
  4096-slot cache and the train step's attention (b 2, seq 4096, 32 heads,
  d 128, causal, 300 right-padded keys in row 1); BF16_TOL and LSE_TOL.
- bwd: the train step's attention as above (dq_accum zeroing and the bf16
  rounding included in each call); BWD_REL_TOL and BWD_COS_MIN.
Needs one NVIDIA GPU and nvcc.
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

ENTRY = {"fwd": "lwm_flash_fwd", "bwd": "lwm_flash_bwd"}


def build(srcs, entry):
    """nvcc each source into its own library, all started together.
    Returns [(library or None, ptxas lines)]."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for i, src in enumerate(srcs):
        so = out_dir / f"v{i}_{Path(src).stem}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared",
               "-o", str(so), str(src)]
        jobs.append((so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True)))
    libs = []
    for so, proc in jobs:
        report = proc.communicate()[0]
        if proc.returncode != 0:   # reported; the other sources are still timed
            libs.append((None, [f"nvcc failed ({proc.returncode}):", *report.splitlines()[-30:]]))
            continue
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, entry)
        fn.argtypes = _build._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        keep = ("entry function", "registers", "spill", "wgmma", "warning", "C75")
        libs.append((lib, [ln.strip() for ln in report.splitlines()
                           if any(t in ln for t in keep)]))
    return libs


def fwd_shapes(gen):
    """{name: (check(out) -> str, call(), bound ms)} at K1's timed cases."""
    shapes = {}
    for case in smoke.K1_CASES:
        name, b, h_kv, d, sq, T, causal, q_off, kv_off, head_major, kind = case
        if name not in smoke.K1_TIMED:
            continue
        q = smoke._randn((b, sq, 32, d), gen)
        kv_shape = (b, h_kv, T, d) if head_major else (b, T, h_kv, d)
        k, v = smoke._randn(kv_shape, gen), smoke._randn(kv_shape, gen)
        bias, valid = smoke._k1_bias(kind, b, sq, T, q_off, gen)
        kw = dict(causal=causal, q_offset=q_off, kv_offset=kv_off, kv_head_major=head_major)
        ref, ref_lse = flash.flash_attention_fwd_plain(q, k, v, bias, **kw)

        def check(got, ref=ref, ref_lse=ref_lse):
            err = (got[0].float() - ref.float()).abs().max().item()
            lse_err = (got[1] - ref_lse).abs().max().item()
            ok = err <= smoke.BF16_TOL and lse_err <= smoke.LSE_TOL
            verdict = "ok" if ok else "FAILS"
            return f"max|out-plain| {err:.3e} max|lse-plain| {lse_err:.3e} {verdict}"

        call = (lambda q=q, k=k, v=v, bias=bias, kw=kw:
                flash.flash_attention_fwd(q, k, v, bias, **kw))
        shapes[name] = (check, call, smoke.k1_bound(q, k, bias, valid, kw)[0])
    return shapes


def bwd_shapes(gen):
    """{name: (check, call, bound ms)} at the train step's attention."""
    name, h_kv, d, S, causal, q_off, kv_off, kind = smoke.BWD_CASES[0]
    b, h = 2, 32
    q, g = smoke._randn((b, S, h, d), gen), smoke._randn((b, S, h, d), gen)
    k, v = smoke._randn((b, S, h_kv, d), gen), smoke._randn((b, S, h_kv, d), gen)
    bias, valid = smoke._bwd_bias(kind, b, S, gen)
    out, lse = flash.flash_attention_fwd(q, k, v, bias, causal=True)
    delta = torch.einsum("bqhd,bqhd->bhq", g.float(), out.float()).contiguous()
    args = (q, k, v, g, lse, delta, bias)
    want = flash.flash_attention_bwd_plain(*args)

    def check(got):
        parts = []
        for oname, a, r in zip(("dq", "dk", "dv"), got, want):
            rel = (a.float() - r.float()).abs().max().item() / r.float().abs().max().item()
            cos = smoke._cosine(a, r)
            ok = rel <= smoke.BWD_REL_TOL and cos >= smoke.BWD_COS_MIN
            verdict = "ok" if ok else "FAILS"
            parts.append(f"{oname} max|Δ|/max|ref| {rel:.3e} cos {cos:.6f} {verdict}")
        return "; ".join(parts)

    pairs = smoke.attn_pairs(valid, S, 0)
    bound = smoke.bound_ms(0, 10 * d * h * pairs, smoke.H100_BF16_PEAK)[0]
    return {name: (check, lambda: flash.flash_attention_bwd(*args), bound)}


def main():
    if len(sys.argv) < 2 or sys.argv[1] not in ENTRY:
        raise SystemExit("usage: time_flash.py fwd|bwd [SRC.cu ...]")
    kind, srcs = sys.argv[1], sys.argv[2:]
    srcs = srcs or [str(_build.CSRC / f"flash_{kind}.cu")]
    smoke.phase_env()
    libs = build(srcs, ENTRY[kind])
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    shapes = (fwd_shapes if kind == "fwd" else bwd_shapes)(gen)

    def run(lib, call):
        with mock.patch.object(_build, "load", lambda: lib):
            return call()

    for src, (lib, report) in zip(srcs, libs):
        print(f"== {src}", flush=True)
        for line in report:
            print(f"  ptxas {line}")
        if lib is None:
            continue
        for name, (check, call, _) in shapes.items():
            got = run(lib, call)
            torch.cuda.synchronize()
            print(f"  {name}: {check(got)}", flush=True)
    built = [i for i, (lib, _) in enumerate(libs) if lib is not None]
    for name, (_, call, bound) in shapes.items():
        times = {i: [] for i in built}
        for i in built + built[::-1]:
            times[i].append(smoke.time_ms(lambda: run(libs[i][0], call), 10))
        for i in built:
            ms = times[i]
            print(f"{name} {srcs[i]}: " + ", ".join(f"{t:.3f}" for t in ms) + f" ms "
                  f"({100 * bound / min(ms):.1f}% of the {bound:.4f} ms bound) [{smoke.card()}]")


if __name__ == "__main__":
    main()
