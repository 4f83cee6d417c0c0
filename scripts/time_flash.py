#!/usr/bin/env python3
"""Time copies of a flash-attention kernel (or of K5 or K6) against each other.

    python3 scripts/time_flash.py fwd [SRC.cu ...]
    python3 scripts/time_flash.py fwd32 [SRC.cu ...]
    python3 scripts/time_flash.py bwd [SRC.cu ...]
    python3 scripts/time_flash.py bwd32 [SRC.cu ...]
    python3 scripts/time_flash.py int8 [SRC.cu ...]
    python3 scripts/time_flash.py w8a8 [SRC.cu ...]
    python3 scripts/time_flash.py dec [ROOT[@SPLIT] ...]

fwd, fwd32, bwd, int8, w8a8: each SRC is a copy of
`lwm_tpu_torch/csrc/flash_fwd.cu` (fwd: K1, C entry `lwm_flash_fwd`),
`csrc/flash_fwd_f32.cu` (fwd32: K1's fp32 route, `lwm_flash_fwd_f32`; the
route before its three-product redesign has the same entry),
`csrc/flash_bwd.cu` (bwd: the fused
backward, `lwm_flash_bwd`), `csrc/flash_bwd_f32.cu` (bwd32: its fp32 route,
`lwm_flash_bwd_f32`; the route before its three-product redesign has the
same entry), `csrc/int8_matmul.cu` (int8: K5,
`lwm_int8_matmul`) or `csrc/w8a8_matmul.cu` (w8a8: K6, `lwm_w8a8_matmul`), a
variant under test or another commit's kernel with the same entry; default:
the package's own source. A w8a8 copy is called through the wrapper, which
also reads `lwm_w8a8_gemv_max_m` (K6 sources from the redesign of its GEMM
on); an int8 copy must build against this tree's headers (K5 sources from
the decode GEMVs' shared ring, csrc/gemv.cuh, on). Each is built by nvcc into a
library of its own (all at once; `#include`s resolve beside the copy, then
in the package's csrc), its ptxas register and spill lines are printed, it
is held against the plain twin, and then all are timed in turns, 1..N then
N..1, with CUDA events over calls of the wrapper. Shapes:
- fwd: chip_smoke.py's two timed K1 cases, a 2048-token admission over the
  4096-slot cache and the train step's attention (b 2, seq 4096, 32 heads,
  d 128, causal, 300 right-padded keys in row 1); BF16_TOL and LSE_TOL.
- fwd32: chip_smoke.py's timed K1_F32_CASES (the needle batch, the 32k
  bundle's prefill, the CFG prefills, the speculative verify, the last
  timed from CUDA-graph replays, and the apps' prefills: vision chat's, the
  32K eval's and the 128-frame vision-needle eval's) and the fp32 train step's attention
  (BWD_F32_CASES[0]); out and lse within F32_REL_TOL of the twin's largest
  |value|, the bound of three TF32 products (chip_smoke.tf32_bounds).
- bwd: the train step's attention as above (dq_accum zeroing and the bf16
  rounding included in each call); BWD_REL_TOL and BWD_COS_MIN.
- bwd32: chip_smoke.py's timed BWD_F32_CASES (the fp32 train step's
  attention, the 8K and 32K stages of the context-extension bundle); dq, dk
  and dv within F32_REL_TOL of the twin's largest |value| (at 32K on
  BWD_F32_TWIN_HEADS heads, and of the twin's arithmetic in float64, as
  chip_smoke.phase_bwd_f32 holds it), the bound of three TF32 products
  (chip_smoke.tf32_bounds).
- int8: every chip_smoke.QUANT_SHAPES case that takes K5's decode GEMV
  (m <= 16), held to the twin within QUANT_REL_TOL; the decode shapes (m 8)
  timed from CUDA-graph replays of the C entry (50 calls a graph) with
  weight copies cycled past the L2 (as chip_smoke.phase_k56), F.linear bf16
  on the dequantized weights and the bound beside; then from eager
  launches as chip_smoke.phase_k56 times them (20 calls of the wrapper),
  10 times in turns, median and range: the host's cost per call where it
  exceeds the kernel's, as in a decode round not captured in a graph.
- w8a8: every chip_smoke.QUANT_SHAPES case, both of K6's routes (the
  decode GEMV at m <= 16, the admission GEMM above), held bit for bit to the
  twin; the decode (m 8) and admission shapes timed from CUDA-graph replays
  of the wrapper with weight copies cycled past the L2 (as
  chip_smoke.phase_k56), `_int_mm` + scales and the bound beside; then the
  decode shapes from eager launches, 10 times in turns, as for int8.
dec (K4): each ROOT is a checkout of the repo (default: this one), e.g.
another commit unpacked under the gitignored _checkout/; its own wrapper
(`lwm_tpu_torch/ops/decode.py`) and kernels (built from its csrc into its
_build/) are loaded beside this tree's, so a kernel whose C entry changed
is timed through its own wrapper. @SPLIT sets that checkout's
`decode.SPLIT_KEYS`. Each is held against this tree's plain twin at every
chip_smoke.K4_CASES and K4_FOLD_CASES case (a checkout that refuses a
case's group is reported and skipped there), then timed in turns from CUDA-graph replays
(cache copies cycled past the L2, as chip_smoke.phase_k4), then profiled:
device time by kernel name over eager calls, so a split kernel's merge pass
shows its share. The ptxas lines of each checkout's decode kernels are
printed.
Needs one NVIDIA GPU and nvcc.
"""

import ctypes
import importlib.util
import re
import statistics
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
import lwm_tpu_torch.ops as ops_pkg  # noqa: E402
from lwm_tpu_torch.ops import _build, decode, flash, quant  # noqa: E402

ENTRY = {"fwd": "lwm_flash_fwd", "fwd32": "lwm_flash_fwd_f32", "bwd": "lwm_flash_bwd",
         "bwd32": "lwm_flash_bwd_f32", "int8": "lwm_int8_matmul", "w8a8": "lwm_w8a8_matmul",
         "dec": None}
SOURCE = {"fwd": "flash_fwd.cu", "fwd32": "flash_fwd_f32.cu", "bwd": "flash_bwd.cu",
          "bwd32": "flash_bwd_f32.cu", "int8": "int8_matmul.cu", "w8a8": "w8a8_matmul.cu"}


def iters(name):
    """Launches per timing: 50 for a decode GEMV or the verify (10-200 us),
    3 for the 32k-class prefills (~0.03-0.3 s), else 10."""
    if name.startswith("decode") or name == smoke.K1_F32_VERIFY:
        return 50
    return 3 if name in smoke.K1_F32_CHUNKED else 10


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


def _f32_check(ref, ref_lse):
    """check(got) of the fp32 route: out and lse (rows with a valid key)
    over the twin's largest |value|, held to F32_REL_TOL."""
    live = ref_lse > smoke.BIG_NEG / 2

    def check(got):
        rel = ((got[0] - ref).abs().max() / ref.abs().max()).item()
        lse_rel = ((got[1][live] - ref_lse[live]).abs().max()
                   / ref_lse[live].abs().max()).item()
        ok = rel <= smoke.F32_REL_TOL and lse_rel <= smoke.F32_REL_TOL
        return (f"max|out-plain|/max|plain| {rel:.3e} max|lse-plain|/max|plain| {lse_rel:.3e} "
                f"{'ok' if ok else 'FAILS'}")

    return check


def fwd32_shapes(gen):
    """{name: (check, call, bound ms)} at K1's timed fp32 cases and the fp32
    train step's attention."""
    shapes = {}
    for case in smoke.K1_F32_CASES:
        if case[0] not in smoke.K1_F32_TIMED:
            continue
        q, k, v, bias, kw, valid = smoke.k1_f32_inputs(case, gen)
        chunk = smoke.F32_TWIN_CHUNK if case[0] in smoke.K1_F32_CHUNKED else None
        call = (lambda q=q, k=k, v=v, bias=bias, kw=kw:
                flash.flash_attention_fwd(q, k, v, bias, **kw))
        bound = smoke.tf32_bounds(*smoke.k1_f32_work(case, q, bias, valid))[0]
        shapes[case[0]] = (_f32_check(*smoke._k1_twin(q, k, v, bias, kw, chunk)), call, bound)
    name, b, h_kv, d, sq, skv, causal, q_off, kv_off, kind = smoke.BWD_F32_CASES[0]
    f32, h = torch.float32, 32
    q = smoke._randn((b, sq, h, d), gen, f32)
    k, v = smoke._randn((b, skv, h_kv, d), gen, f32), smoke._randn((b, skv, h_kv, d), gen, f32)
    bias, valid = smoke._bwd_f32_bias(kind, b, sq, skv, gen)
    kw = dict(causal=causal, q_offset=q_off, kv_offset=kv_off)
    n_bytes = 2 * q.numel() * 4 + 2 * int(valid.sum()) * h_kv * d * 4 + b * h * sq * 4
    pairs = smoke.attn_pairs(valid, sq, q_off)
    bound = smoke.tf32_bounds(n_bytes + bias.numel() * 4, 4 * d * h * pairs)[0]
    shapes[name] = (_f32_check(*flash.flash_attention_fwd_plain(q, k, v, bias, **kw)),
                    lambda: flash.flash_attention_fwd(q, k, v, bias, **kw), bound)
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


def bwd32_shapes(gen):
    """{name: (check, call, bound ms)} at the fp32 backward's timed cases."""
    shapes = {}
    for name, b, h_kv, d, sq, skv, causal, q_off, kv_off, kind in smoke.BWD_F32_CASES:
        if name not in smoke.BWD_F32_TIMED:
            continue
        h = smoke.BWD_F32_HEADS.get(name, 32)
        f32 = torch.float32
        q, g = smoke._randn((b, sq, h, d), gen, f32), smoke._randn((b, sq, h, d), gen, f32)
        k, v = smoke._randn((b, skv, h_kv, d), gen, f32), smoke._randn((b, skv, h_kv, d), gen, f32)
        bias, valid = smoke._bwd_f32_bias(kind, b, sq, skv, gen)
        kw = dict(causal=causal, q_offset=q_off, kv_offset=kv_off)
        out, lse = flash.flash_attention_fwd(q, k, v, bias, **kw)
        delta = torch.einsum("bqhd,bqhd->bhq", g, out).contiguous()
        args = (q, k, v, g, lse, delta, bias)
        n = smoke.BWD_F32_TWIN_HEADS if name in smoke.BWD_F32_HEADS else h
        twin_args = (*(x[:, :, :n].contiguous() for x in (q, k, v, g)),
                     *(x[:, :n].contiguous() for x in (lse, delta)), bias)
        want = (smoke._bwd_f64 if name in smoke.BWD_F32_HEADS else
                flash.flash_attention_bwd_plain)(*twin_args, **kw)
        torch.cuda.empty_cache()

        def check(got, want=want, n=n):
            parts = []
            for oname, a, r in zip(("dq", "dk", "dv"), got, want):
                rel = ((a[:, :, :n] - r).abs().max() / r.abs().max()).item()
                parts.append(f"{oname} max|Δ|/max|plain| {rel:.3e} "
                             f"{'ok' if rel <= smoke.F32_REL_TOL else 'FAILS'}")
            return "; ".join(parts)

        pairs = smoke.attn_pairs(valid, sq, q_off)
        bound = smoke.tf32_bounds(*smoke.bwd_f32_work(q, k, bias, pairs))[0]
        shapes[name] = (check, lambda args=args, kw=kw: flash.flash_attention_bwd(*args, **kw),
                        bound)
        del out, twin_args
    return shapes


def _weight_sets(w, s, timed):
    """Enough copies of (w, s) to cycle a timed stream past the L2."""
    n = max(1, -(-int(smoke.L2_FLUSH_BYTES) // w.numel())) if timed else 1
    return [(w.clone(), s.clone()) for _ in range(n - 1)] + [(w, s)]


def int8_shapes(gen):
    """{name: (check, call, bound ms or None: checked, not timed)} at K5's
    decode GEMV shapes; each call takes the next weight copy."""
    shapes = {}
    for name, m, d, f in smoke.QUANT_SHAPES:
        if m > 16:
            continue
        x = smoke._randn((m, d), gen)
        w, s = quant.quantize_weight(torch.randn((f, d), generator=gen, device="cuda") * 0.02)
        want = quant.int8_matmul_plain(x, w, s)

        def check(got, want=want):
            rel = ((got.float() - want.float()).abs().max().item()
                   / want.float().abs().max().item())
            verdict = "ok" if rel <= smoke.QUANT_REL_TOL else "FAILS"
            return f"max|out-plain|/max|plain| {rel:.3e} {verdict}"

        timed = name.startswith("decode")
        sets = _weight_sets(w, s, timed)
        turn = iter(range(10**9))

        def call(x=x, sets=sets, turn=turn):
            return quant.int8_matmul(x, *sets[next(turn) % len(sets)])

        bound = None
        if timed:
            bound = smoke.bound_ms(m * d * 2 + f * d + f * 4 + m * f * 2, 2 * m * d * f,
                                   smoke.H100_BF16_PEAK)[0]
            w16 = [((wc.float() * sc[:, None]).to(smoke.BF16),) for wc, sc in sets]
            lib = smoke.time_ms(lambda w: torch.nn.functional.linear(x, w), iters(name), w16,
                                graph=True)
            del w16
            print(f"{name}: F.linear bf16 {lib:.4f} ms, bound {bound:.4f} ms", flush=True)
        shapes[name] = (check, call, bound)
    return shapes


def w8a8_shapes(gen):
    """{name: (check, call, bound ms or None: checked, not timed)} at every
    QUANT_SHAPES case of K6, both routes; each call takes the next weight
    copy."""
    shapes = {}
    for name, m, d, f in smoke.QUANT_SHAPES:
        x_q, x_s = quant.quantize_activations(smoke._randn((m, d), gen))
        w, s = quant.quantize_weight(torch.randn((f, d), generator=gen, device="cuda") * 0.02)
        want = quant.w8a8_matmul_plain(x_q, x_s, w, s, out_dtype=smoke.BF16)

        def check(got, want=want):
            verdict = "ok" if torch.equal(got, want) else "FAILS"
            return f"max|out-plain| {(got.float() - want.float()).abs().max().item():.3e} {verdict}"

        timed = not name.startswith("edge")
        sets = _weight_sets(w, s, timed)
        turn = iter(range(10**9))

        def call(x_q=x_q, x_s=x_s, sets=sets, turn=turn):
            return quant.w8a8_matmul_quantized(x_q, x_s, *sets[next(turn) % len(sets)],
                                               out_dtype=smoke.BF16)

        bound = None
        if timed:
            bound = smoke.bound_ms(m * d + m * 4 + f * d + f * 4 + m * f * 2, 2 * m * d * f,
                                   smoke.H100_INT8_PEAK)[0]
            lib = smoke.time_ms(lambda w, s: smoke._int_mm_scaled(x_q, x_s, w, s), iters(name),
                                sets, graph=True)
            print(f"{name}: _int_mm + scales {lib:.4f} ms, bound {bound:.4f} ms", flush=True)
        shapes[name] = (check, call, bound)
    return shapes


def _load_checkout(root, i):
    """A checkout's `_build` and `decode` modules, loaded under names of
    their own: its decode wrapper calls its own library."""
    def load(name, path):
        spec = importlib.util.spec_from_file_location(f"_checkout{i}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    ops = Path(root) / "lwm_tpu_torch" / "ops"
    build_mod = load("_build", ops / "_build.py")
    with mock.patch.object(ops_pkg, "_build", build_mod):
        dec_mod = load("decode", ops / "decode.py")
    return build_mod, dec_mod


def _decode_ptxas(report):
    """ptxas's lines for the decode kernels of one build report."""
    keep, lines = False, []
    for ln in report.splitlines():
        if "entry function" in ln:
            keep = "decode" in ln
        if keep and any(t in ln for t in ("entry function", "registers", "spill")):
            lines.append(ln.strip())
    return lines


def _kernel_ms(call, n=20):
    """Device ms per call by kernel name, from torch.profiler over n eager
    calls (after one warm-up)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3 / n
    return by_name


def _short(kernel_name):
    """`decode_split_kernel` of `void (anonymous namespace)::decode_split_kernel<...>(...)`."""
    found = re.search(r"(\w*kernel\w*)", kernel_name)
    return found.group(1) if found else kernel_name[:60]


def main_dec(specs):
    """K4 of each checkout (ROOT[@SPLIT]) at chip_smoke's K4 cases."""
    specs = specs or [str(ROOT)]
    smoke.phase_env()
    subjects = []
    for i, spec in enumerate(specs):
        root, _, split = spec.partition("@")
        build_mod, dec_mod = _load_checkout(root, i)
        if split:
            dec_mod.SPLIT_KEYS = int(split)
        subjects.append((spec, build_mod, dec_mod))
    reports = [b.build() for _, b, _ in subjects]  # each checkout builds into its own _build/
    for (spec, build_mod, _), report in zip(subjects, reports):
        build_mod.load()
        print(f"== {spec}: {build_mod.library_path()}", flush=True)
        for line in _decode_ptxas(report):
            print(f"  ptxas {line}")
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    for case in smoke.K4_CASES + smoke.K4_FOLD_CASES:
        name = case[0]
        args = smoke.k4_inputs(case, gen)
        ref = decode.flash_decode_plain(*args)
        bnd, by, kv_bytes = smoke.k4_bound(args[0], args[1], args[3], args[4])
        sets = smoke.k4_arg_sets(args, kv_bytes)
        order = []
        for i, (spec, _, dec_mod) in enumerate(subjects):
            try:
                got = dec_mod.flash_decode(*args)
            except ValueError as e:   # a checkout whose K4 refuses this group
                print(f"{name} {spec}: refused ({e})", flush=True)
                continue
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            verdict = "ok" if err <= smoke.BF16_TOL else "FAILS"
            print(f"{name} {spec}: max|out-plain| {err:.3e} {verdict}", flush=True)
            order.append(i)
        times = {i: [] for i in order}
        for i in order + order[::-1]:
            fn = subjects[i][2].flash_decode
            times[i].append(smoke.time_ms(lambda *a, fn=fn: fn(*a), 50, sets, graph=True))
        for i in order:
            spec, _, dec_mod = subjects[i]
            per_kernel = _kernel_ms(lambda: dec_mod.flash_decode(*args))
            total = sum(per_kernel.values())
            parts = ", ".join(f"{_short(k)} {ms:.4f} ms ({100 * ms / total:.1f}%)"
                              for k, ms in per_kernel.items())
            print(f"{name} {spec}: " + ", ".join(f"{t:.4f}" for t in times[i]) + " ms graph "
                  f"({100 * bnd / min(times[i]):.1f}% of the {bnd:.4f} ms bound, {by}); "
                  f"profiled eager: {parts} [{smoke.card()}]", flush=True)
        del args, ref, sets
        torch.cuda.empty_cache()


def main():
    if len(sys.argv) < 2 or sys.argv[1] not in ENTRY:
        raise SystemExit("usage: time_flash.py fwd|fwd32|bwd|bwd32|int8|w8a8 [SRC.cu ...] | "
                         "dec [ROOT[@SPLIT] ...]")
    kind, srcs = sys.argv[1], sys.argv[2:]
    if kind == "dec":
        return main_dec(srcs)
    srcs = srcs or [str(_build.CSRC / SOURCE[kind])]
    smoke.phase_env()
    libs = build(srcs, ENTRY[kind])
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    shapes = {"fwd": fwd_shapes, "fwd32": fwd32_shapes, "bwd": bwd_shapes,
              "bwd32": bwd32_shapes, "int8": int8_shapes, "w8a8": w8a8_shapes}[kind](gen)

    def run(lib, call):
        with mock.patch.object(_build, "load", lambda: lib):
            return call()

    refused = set()
    for i, (src, (lib, report)) in enumerate(zip(srcs, libs)):
        print(f"== {src}", flush=True)
        for line in report:
            print(f"  ptxas {line}")
        if lib is None:
            continue
        for name, (check, call, _) in shapes.items():
            try:
                got = run(lib, call)
            # a refused launch, or an older copy without an entry the wrapper
            # reads: reported, not timed
            except (RuntimeError, AttributeError) as err:
                print(f"  {name}: {err} FAILS", flush=True)
                refused.add(i)
                break
            torch.cuda.synchronize()
            print(f"  {name}: {check(got)}", flush=True)
    built = [i for i, (lib, _) in enumerate(libs) if lib is not None and i not in refused]
    for name, (_, call, bound) in shapes.items():
        if bound is None:
            continue
        times = {i: [] for i in built}
        for i in built + built[::-1]:
            graph = kind in ("int8", "w8a8") or name == smoke.K1_F32_VERIFY
            times[i].append(smoke.time_ms(lambda: run(libs[i][0], call), iters(name),
                                          graph=graph))
        for i in built:
            ms = times[i]
            print(f"{name} {srcs[i]}: " + ", ".join(f"{t:.4f}" for t in ms) + f" ms "
                  f"({100 * bound / min(ms):.1f}% of the {bound:.4f} ms bound) [{smoke.card()}]")
        if not name.startswith("decode"):
            continue
        eager = {i: [] for i in built}
        for rep in range(10):
            for i in built if rep % 2 == 0 else built[::-1]:
                eager[i].append(smoke.time_ms(lambda: run(libs[i][0], call), 20))
        for i in built:
            ms = sorted(eager[i])
            print(f"{name} {srcs[i]}: eager {statistics.median(ms):.4f} ms a call (median of "
                  f"10 x 20 calls; {ms[0]:.4f}-{ms[-1]:.4f}) [{smoke.card()}]")


if __name__ == "__main__":
    main()
