#!/usr/bin/env python3
"""Time the prototypes of the fp32 routes' product loops (scripts/tf32_products.cu).

    python3 scripts/time_tf32_products.py

Builds `scripts/tf32_products.cu` with nvcc (against the package's
`csrc/tf32.cuh`), checks each prototype's product (one pass, three TF32
products) against float64 within 1e-5 of its largest element, then times
each over the whole card, `ITERS` passes a block, with CUDA events. K1's
forward, s = q·kᵀ at d 128: `mma.sync` m16n8k8 (raw fp32 tiles split in
registers at every fragment) and `wgmma` m64n64k8 (pre-split hi/lo tiles).
The backward's dv += pᵀ·g over a 32-query stage: `mma.sync` m16n8k8 with
p's fragments in registers and g's gathered from hi/lo tiles as they lie,
and `wgmma` m64n128k8 with p from registers and gᵀ's hi/lo tiles; its sᵀ =
k·qᵀ at 32 queries by `wgmma` m64n32k8. Prints the TF32 rate (three
products counted) and the fp32 rate it gives (a third), beside the H100
SXM's 495 TFLOP/s TF32 and 67 TFLOP/s fp32 peaks, with the card's name and
power limit. Needs one NVIDIA GPU and nvcc.
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

ITERS = 2000
# (which, name, a's shape, b's shape, out = a·bᵀ (True) or a·b); every block
# computes the same product
LOOPS = [
    (0, "fwd s: mma.sync m16n8k8 (split in registers)", (64, 128), (64, 128), True),
    (1, "fwd s: wgmma m64n64k8 (hi/lo tiles in shared memory)", (128, 128), (64, 128), True),
    (2, "bwd dv: mma.sync m16n8k8 (p in registers, g's hi/lo tiles as they lie)",
     (128, 32), (32, 128), False),
    (3, "bwd dv: wgmma m64n128k8 (p in registers, gT's hi/lo tiles)", (128, 32), (32, 128),
     False),
    (4, "bwd sT: wgmma m64n32k8 x 2 warpgroups (hi/lo tiles in shared memory)", (64, 128),
     (32, 128), True),
]


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
    fn.argtypes = [I, P, P, P, I, I, P, P]
    fn.restype = I
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    stream = _build.stream_handle(torch.device("cuda"))
    for which, name, a_shape, b_shape, transposed in LOOPS:
        a = torch.randn(a_shape, generator=gen, device="cuda")
        b = torch.randn(b_shape, generator=gen, device="cuda")
        want = a.double() @ (b.double().T if transposed else b.double())
        got = torch.zeros(want.shape, device="cuda")
        blocks = ctypes.c_int()

        def run(iters, n_blocks=0):
            rc = fn(which, a.data_ptr(), b.data_ptr(), got.data_ptr(), iters, n_blocks,
                    ctypes.byref(blocks), stream)
            _build.check(rc, f"tf32_products {name}")

        run(1, 1)
        torch.cuda.synchronize()
        rel = ((got.double() - want).abs().max() / want.abs().max()).item()
        verdict = "ok" if rel <= 1e-5 else "FAILS"
        run(ITERS)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run(ITERS)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        # three products of the block's tile a pass (loop 4: both warpgroups')
        pass_flop = 3 * 2 * want.shape[0] * want.shape[1] * a_shape[1] * (2 if which == 4 else 1)
        tf32 = pass_flop * ITERS * blocks.value / ms / 1e9
        print(f"{name}: {blocks.value} blocks, {ms:.3f} ms for {ITERS} passes a block: "
              f"{tf32:.1f} TFLOP/s TF32 ({100 * tf32 / 495:.1f}% of 495), {tf32 / 3:.1f} "
              f"TFLOP/s at fp32 accuracy ({tf32 / 3 / 67:.2f}x the 67 TFLOP/s FMA peak); one "
              f"pass vs float64: max|Δ|/max|out| {rel:.2e} {verdict} [{smoke.card()}]",
              flush=True)


if __name__ == "__main__":
    main()
