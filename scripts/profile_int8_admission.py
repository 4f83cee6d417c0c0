#!/usr/bin/env python3
"""Profile one admission of the PyTorch port's 7b model (int8 weights, or
bf16) on one NVIDIA GPU.

    python3 scripts/profile_int8_admission.py [--root DIR] [--bf16]

Builds the 7b serving model of `chip_smoke.py` (random bf16 weights from a
seed, quantized on the card with `quantize_params_int8`, served with
`quant_dense="int8"`; with `--bf16` the bf16 model itself), prefills one
prompt of 2000 tokens into the 2048 bucket, then runs one more such
admission under `torch.profiler` and prints the device time by kernel kind:
K5's admission GEMM (`int8_gemm_kernel`), cuBLAS's dense products, K1 (`flash_fwd_kernel`) and the rest, with each one's share of the
kernel time and the device's idle share of the admission's wall time.

`--root DIR` imports `lwm_tpu_torch` from DIR instead of this checkout (an
unpacked copy of another commit), so two versions are profiled the same way.
"""

import argparse
import subprocess
import sys
import time
from pathlib import Path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--bf16", action="store_true", help="profile the bf16 model instead")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import lwm_tpu_torch
    from lwm_tpu_torch.models.llama import LLaMAConfig, LLaMAForCausalLM
    from lwm_tpu_torch.ops import quant
    from lwm_tpu_torch.serve import prefill_logits

    if not torch.cuda.is_available():
        raise SystemExit("profile_int8_admission: no GPU (torch.cuda.is_available() is False)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"package {Path(lwm_tpu_torch.__file__).parent}; card {card}", flush=True)

    # chip_smoke.py's serving configuration (scripts/run_serve.sh)
    cfg = LLaMAConfig.load_config("7b")
    cfg = cfg.replace(scan_attention=False, scan_mlp=False, theta=50_000_000,
                      decode_index="per_row",
                      max_sequence_length=max(cfg.max_sequence_length, 4096))
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = LLaMAForCausalLM(cfg, dtype=torch.bfloat16, device="cuda")
    model.init_weights(gen)
    if not args.bf16:
        sd = quant.quantize_params_int8(model.state_dict())
        del model
        torch.cuda.empty_cache()
        model = LLaMAForCausalLM(cfg.replace(quant_dense="int8"), dtype=torch.bfloat16,
                                 device="meta")
        model.load_state_dict(sd, assign=True)

    bucket = 2048
    prompt = np.random.default_rng(0).integers(2, cfg.vocab_size, bucket - 48).tolist()
    cache = model.init_cache(1, 4096)
    prefill_logits(model, cache, prompt, bucket)   # warm-up: kernels built and loaded
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill_logits(model, cache, prompt, bucket)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kinds = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
            continue
        name = ev.name
        if "int8_gemm_kernel" in name:
            kind = "K5 admission GEMM"
        elif "flash_fwd_kernel" in name:
            kind = "K1 flash_fwd"
        elif any(t in name.lower() for t in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
            kind = "dense (cuBLAS)"
        else:
            kind = "other"
        kinds[kind] = kinds.get(kind, 0.0) + ev.time_range.elapsed_us() / 1e3
    busy = sum(kinds.values())
    if busy <= 0:
        raise SystemExit("profile_int8_admission: the profiler recorded no device kernels")
    print(f"{'bf16' if args.bf16 else 'int8'} admission, bucket {bucket} "
          f"({len(prompt)} prompt tokens), 7b, 32 layers: "
          f"{wall_ms:.1f} ms wall (profiled), kernels {busy:.1f} ms, device idle "
          f"{100 - 100 * busy / wall_ms:.1f}% [{card}]")
    for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"  {kind}: {ms:.2f} ms ({100 * ms / busy:.1f}% of kernel time)")


if __name__ == "__main__":
    main()
