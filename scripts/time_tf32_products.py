#!/usr/bin/env python3
"""Time the two prototypes of K1's fp32 product loop (scripts/tf32_products.cu).

    python3 scripts/time_tf32_products.py

Builds `scripts/tf32_products.cu` with nvcc (against the package's
`csrc/hopper.cuh`), checks each prototype's s = q·kᵀ (one pass, three TF32
products) against float64 within 1e-5 of max|s|, then times each over the
whole card, `ITERS` passes a block, with CUDA events: `mma.sync` m16n8k8
(the route's loop: raw fp32 tiles split in registers) and `wgmma` m64n64k8
(pre-split hi/lo tiles, both operands from shared memory). Prints the
TF32 rate (three products counted) and the fp32 rate it gives (a third),
beside the H100 SXM's 495 TFLOP/s TF32 and 67 TFLOP/s fp32 peaks, with
the card's name and power limit. Needs one NVIDIA GPU and nvcc.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from lwm_tpu_torch.ops import _build  # noqa: E402

ITERS, D, BK = 2000, 128, 64
NAMES = ("mma.sync m16n8k8 (split in registers)", "wgmma m64n64k8 (hi/lo tiles in shared memory)")


def main():
    smoke.phase_env()
    so = _build.BUILD_DIR / "tf32_products.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared", "-o", str(so),
           str(ROOT / "scripts" / "tf32_products.cu")]
    out = subprocess.run(cmd, capture_output=True, text=True)
    for line in (out.stdout + out.stderr).splitlines():
        if any(t in line for t in ("registers", "spill", "error", "warning", "C75")):
            print("ptxas", line.strip())
    if out.returncode != 0:
        raise SystemExit(f"nvcc failed ({out.returncode})")
    lib = ctypes.CDLL(str(so))
    fn = lib.tf32_products
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [I, P, P, P, I, I, P, P, P]
    fn.restype = I
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    k = torch.randn((BK, D), generator=gen, device="cuda")
    stream = _build.stream_handle(k.device)
    for which, name in enumerate(NAMES):
        rows, blocks = ctypes.c_int(), ctypes.c_int()
        q = torch.randn((64 * (which + 1), D), generator=gen, device="cuda")
        s = torch.zeros((q.shape[0], BK), device="cuda")

        def run(iters, n_blocks=0):
            rc = fn(which, q.data_ptr(), k.data_ptr(), s.data_ptr(), iters, n_blocks,
                    ctypes.byref(rows), ctypes.byref(blocks), stream)
            _build.check(rc, f"tf32_products {name}")

        run(1, 1)
        torch.cuda.synchronize()
        want = q.double() @ k.double().T
        rel = ((s.double() - want).abs().max() / want.abs().max()).item()
        verdict = "ok" if rel <= 1e-5 else "FAILS"
        run(ITERS)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run(ITERS)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        flop = 3 * 2 * rows.value * BK * D * ITERS * blocks.value
        tf32 = flop / ms / 1e9
        print(f"{name}: {blocks.value} blocks of {rows.value} rows, {ms:.3f} ms for {ITERS} "
              f"passes a block: {tf32:.1f} TFLOP/s TF32 ({100 * tf32 / 495:.1f}% of 495), "
              f"{tf32 / 3:.1f} TFLOP/s at fp32 accuracy ({tf32 / 3 / 67:.2f}x the 67 TFLOP/s "
              f"FMA peak); one pass vs float64: max|Δ|/max|s| {rel:.2e} {verdict} "
              f"[{smoke.card()}]", flush=True)


if __name__ == "__main__":
    main()
