#!/usr/bin/env python3
"""Drive the PyTorch port (lwm_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure raises and exits non-zero (there is no CPU path):
  1. torch/CUDA versions and the card (nvidia-smi name, power limit).
  2. Build the CUDA kernels from lwm_tpu_torch/csrc with nvcc (sm_90a).
  3. K1 flash_attention_fwd vs its plain twin at the serving shapes (bf16).
  4. K4 flash_decode vs its plain twin: 8 slots, bf16 and int8, MHA and GQA.
  5. Serve 12 requests through InflightServer with the 7b preset at the
     scripts/run_serve.sh settings (bf16, theta 5e7, 8 slots, cache 4096,
     buckets 256/1024/2048), random weights from a seed; check every
     request and that both kernels ran on that path; hold kernel-path
     admission logits against an attn_impl="plain" model on the same
     weight tensors and against an fp32 copy of them.
The last lines: the card, one JSON object per kernel run, and
{"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from lwm_tpu_torch.models.llama import LLaMAConfig, LLaMAForCausalLM, quantize_kv
from lwm_tpu_torch.ops import _build, decode, flash
from lwm_tpu_torch.ops.reference import BIG_NEG
from lwm_tpu_torch.serve import InflightServer, prefill_logits

BF16 = torch.bfloat16
BF16_TOL = 2e-2   # max |kernel - twin| on bf16 outputs (one bf16 step near 1 is 4e-3)
LSE_TOL = 1e-3    # fp32 lse; only the summation order differs
# admission logits at 32 layers (7b): the plain bf16 path itself sits at
# cosine ~0.998 to an fp32 run of the same weights, so kernel vs plain is
# held to 0.997, and the kernel path's distance to fp32 (1 - cosine) to at
# most 1.25x the plain bf16 path's
COS_MIN = 0.997
FLOOR_RATIO = 1.25
SEED = 0


def log(msg):
    print(msg, flush=True)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20):
    """Mean ms per call on the device (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_env():
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — this script needs a GPU")
    log(f"card: {card()} ({torch.cuda.device_count()} visible)")


def phase_build():
    t0 = time.perf_counter()
    report = _build.build()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.1f}s -> {_build.library_path().name}")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas {line.strip()}")


def _randn(shape, gen, dtype=BF16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def phase_k1(gen):
    """K1 at the admission shapes. Returns (max_abs_err, ms, plain_ms)."""
    b, h, d, T = 1, 32, 128, 4096
    worst, timing = 0.0, None
    cases = [
        # name, h_kv, sq, q_offset, bias kind
        ("bucket2048_T4096_perkey", 32, 2048, 0, "per_key"),
        ("q16_fulltile_qoff1000", 32, 16, 1000, "full"),
        ("gqa_hkv8_bucket1024", 8, 1024, 0, "per_key"),
    ]
    for name, h_kv, sq, q_off, kind in cases:
        q = _randn((b, sq, h, d), gen)
        k = _randn((b, h_kv, T, d), gen)
        v = _randn((b, h_kv, T, d), gen)
        keys = torch.arange(T, device="cuda")
        if kind == "per_key":   # admission: the prompt's keys are valid
            valid = keys < sq - 37
            bias = torch.where(valid, 0.0, BIG_NEG)[None, None, None, :]
        else:                   # per-row frontiers with random holes
            rows = q_off + torch.arange(sq, device="cuda")[:, None]
            holes = torch.rand((sq, T), generator=gen, device="cuda") < 0.2
            valid = (keys[None] <= rows) & ~(holes & (keys[None] > 0))
            bias = torch.where(valid, 0.0, BIG_NEG)[None, None]
        kw = dict(causal=True, q_offset=q_off, kv_head_major=True)
        out, lse = flash.flash_attention_fwd(q, k, v, bias, **kw)
        ref, ref_lse = flash.flash_attention_fwd_plain(q, k, v, bias, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        log(f"K1 {name}: max|out-plain| {err:.3e} (tol {BF16_TOL}) "
            f"max|lse-plain| {lse_err:.3e} (tol {LSE_TOL})")
        if not (err <= BF16_TOL and lse_err <= LSE_TOL):
            raise AssertionError(f"K1 {name} disagrees with its plain twin")
        worst = max(worst, err)
        if timing is None:
            ms = time_ms(lambda: flash.flash_attention_fwd(q, k, v, bias, **kw))
            plain_ms = time_ms(lambda: flash.flash_attention_fwd_plain(q, k, v, bias, **kw), 5)
            log(f"K1 {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
            timing = (ms, plain_ms)
        del q, k, v, out, ref
    return worst, *timing


def phase_k4(gen):
    """K4 at the decode shapes. Returns (max_abs_err, ms, plain_ms)."""
    b, h, d, T = 8, 32, 128, 4096
    lengths = torch.tensor([4000, 17, 2048, 3000, 0, 513, 1024, 3999], device="cuda")
    mask = torch.arange(T, device="cuda")[None] <= lengths[:, None]
    mask[2, :300] = False            # a left-pad hole
    kv_len = int(lengths.max()) + 1
    worst, timing = 0.0, None
    for name, h_kv, int8 in [("bf16_mha", 32, False), ("bf16_gqa_hkv8", 8, False),
                             ("int8_mha", 32, True), ("int8_gqa_hkv8", 8, True)]:
        q = _randn((b, 1, h, d), gen)
        k = _randn((b, h_kv, T, d), gen)
        v = _randn((b, h_kv, T, d), gen)
        ks = vs = None
        if int8:
            k, ks = quantize_kv(k)
            v, vs = quantize_kv(v)
        args = (q, k, v, mask, kv_len, ks, vs)
        out = decode.flash_decode(*args)
        ref = decode.flash_decode_plain(*args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        log(f"K4 {name}: max|out-plain| {err:.3e} (tol {BF16_TOL})")
        if not err <= BF16_TOL:
            raise AssertionError(f"K4 {name} disagrees with its plain twin")
        worst = max(worst, err)
        if timing is None:
            ms = time_ms(lambda: decode.flash_decode(*args), 50)
            plain_ms = time_ms(lambda: decode.flash_decode_plain(*args), 20)
            log(f"K4 {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
                f"(b={b} h={h} T={T} kv_len={kv_len})")
            timing = (ms, plain_ms)
    return worst, *timing


def serving_config():
    """scripts/run_serve.sh: 7b, theta 5e7, no scan; the CLI sets per_row
    and max_sequence_length = max(preset, cache_len)."""
    cfg = LLaMAConfig.load_config("7b")
    return cfg.replace(
        scan_attention=False, scan_mlp=False, theta=50_000_000,
        decode_index="per_row", max_sequence_length=max(cfg.max_sequence_length, 4096),
    )


def phase_serve():
    """Returns (launch counts of the serving run, summary dict)."""
    cfg = serving_config()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = LLaMAForCausalLM(cfg, dtype=BF16, device="cuda")
    model.init_weights(gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"serve: 7b model ({n_params / 1e9:.2f}B params, bf16, random seed {SEED}) "
        f"built in {time.perf_counter() - t0:.1f}s")

    srv = InflightServer(
        model, slots=8, cache_len=4096, prompt_buckets=(256, 1024, 2048),
        stop_tokens=(cfg.eos_token_id,), seed=SEED,
    )
    rng = np.random.default_rng(SEED)
    lens = [50, 1900, 700, 130, 2000, 999, 256, 1500, 64, 1200, 400, 1800]
    prompts = [rng.integers(2, cfg.vocab_size, n).tolist() for n in lens]
    budgets = [64 + (i % 3) * 8 for i in range(12)]
    temps = [0.0] * 12
    temps[3], temps[8] = 0.8, 1.0
    rids = [srv.submit(p, n, t) for p, n, t in zip(prompts, budgets, temps)]

    flash.flash_attention_fwd.launches = 0
    decode.flash_decode.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = {f.req_id: f for f in srv.run()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": flash.flash_attention_fwd.launches,
                "flash_decode": decode.flash_decode.launches}
    log(f"serve: {srv.stats_line()}; wall {wall:.2f}s; launches {launches}")

    if sorted(done) != sorted(rids):
        raise AssertionError(f"served {sorted(done)}, submitted {sorted(rids)}")
    for rid, n in zip(rids, budgets):
        toks = done[rid].tokens
        if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"request {rid}: token outside the vocab")
        ok_len = len(toks) == n and done[rid].stopped == "length"
        ok_eos = done[rid].stopped == "eos" and toks[-1] == cfg.eos_token_id and len(toks) <= n
        if not (ok_len or ok_eos):
            raise AssertionError(f"request {rid}: {len(toks)} tokens, stopped {done[rid].stopped}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the serving path never launched: {launches}")
    s = srv.stats
    decode_tokens = s["emitted"] - s["admitted"]
    summary = dict(
        prefill_s=s["prefill_s"], decode_s=s["decode_s"], rounds=s["rounds"],
        decode_tokens=decode_tokens, decode_tok_s=decode_tokens / s["decode_s"],
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    log(f"serve: prefill {s['prefill_s']:.3f}s over {s['admitted']} admissions, decode "
        f"{s['decode_s']:.3f}s for {decode_tokens} tokens in {s['rounds']} rounds = "
        f"{summary['decode_tok_s']:.1f} tok/s; peak {summary['peak_gib']:.1f} GiB "
        f"[{card()}]")

    # The same weight tensors through the plain attention path, and an fp32
    # upcast copy through it as the reference both bf16 paths are held to:
    # at 32 random layers bf16 rounding alone moves the logits' cosine to
    # the fp32 result to ~0.998, so the kernel path must be as close to the
    # fp32 result as the plain bf16 path is, and agree with it on argmax.
    plain = LLaMAForCausalLM(cfg.replace(attn_impl="plain"), dtype=BF16, device="meta")
    plain.load_state_dict(model.state_dict(), assign=True)
    ref32 = LLaMAForCausalLM(cfg.replace(attn_impl="plain"), dtype=torch.float32, device="meta")
    del srv
    torch.cuda.empty_cache()
    ref32.load_state_dict({k: v.float() for k, v in model.state_dict().items()}, assign=True)

    def cos(a, b):
        return torch.nn.functional.cosine_similarity(a, b, dim=0).item()

    for i in (0, 2, 4):
        bucket = next(b for b in (256, 1024, 2048) if b >= len(prompts[i]))
        got, want, truth = (
            prefill_logits(m, m.init_cache(1, 4096), prompts[i], bucket)
            for m in (model, plain, ref32)
        )
        c_kp, c_k32, c_p32 = cos(got, want), cos(got, truth), cos(want, truth)
        log(f"admission logits, prompt {len(prompts[i])} (bucket {bucket}): kernel vs plain "
            f"max|diff| {(got - want).abs().max().item():.4f} cosine {c_kp:.6f}; cosine to fp32: "
            f"kernel {c_k32:.6f} plain {c_p32:.6f}; argmax kernel/plain/fp32 "
            f"{int(got.argmax())}/{int(want.argmax())}/{int(truth.argmax())}")
        if int(got.argmax()) != int(want.argmax()):
            raise AssertionError("kernel and plain paths pick different admission tokens")
        if not (c_kp >= COS_MIN and 1 - c_k32 <= FLOOR_RATIO * (1 - c_p32)):
            raise AssertionError("kernel-path admission logits are off the bf16 noise floor")
    return launches, summary


def main():
    phase_env()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k1 = phase_k1(gen)
    k4 = phase_k4(gen)
    torch.cuda.empty_cache()
    launches, _ = phase_serve()
    kernels = [
        dict(name="flash_fwd", route="cuda", source="lwm_tpu_torch/csrc/flash_fwd.cu",
             replaces="lwm_tpu/ops/pallas_flash.py:199", launches=launches["flash_fwd"],
             max_abs_err=k1[0], ms=k1[1], plain_ms=k1[2]),
        dict(name="flash_decode", route="cuda", source="lwm_tpu_torch/csrc/flash_decode.cu",
             replaces="lwm_tpu/ops/pallas_decode.py:66", launches=launches["flash_decode"],
             max_abs_err=k4[0], ms=k4[1], plain_ms=k4[2]),
    ]
    log(card())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
