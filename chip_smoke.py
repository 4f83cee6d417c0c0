#!/usr/bin/env python3
"""Drive the PyTorch port (lwm_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

    python3 chip_smoke.py --profile DIR   # also profile one more train step and
                                          # write its kernel table to DIR

Phases; any failure raises and exits non-zero (there is no CPU path):
  1. torch/CUDA versions and the card (nvidia-smi name, power limit).
  2. Build the CUDA kernels from lwm_tpu_torch/csrc with nvcc (sm_90a).
  3. K1 flash_attention_fwd vs its plain twin at the serving shapes (bf16).
  4. K4 flash_decode vs its plain twin: 8 slots, bf16 and int8, MHA and GQA.
  5. K2/K3 flash_attention_bwd_dq/_dkv vs their plain twin at the training
     shapes (b 2, seq 4096, 32 heads, d 128; GQA; a ragged seq).
  6. Serve 12 requests through InflightServer with the 7b preset at the
     scripts/run_serve.sh settings (bf16, theta 5e7, 8 slots, cache 4096,
     buckets 256/1024/2048), random weights from a seed; check every
     request and that K1 and K4 ran on that path; hold kernel-path
     admission logits against an attn_impl="plain" model on the same
     weight tensors and against an fp32 copy of them.
  7. Train step at 7b width (2 layers, seq 4096): loss and per-parameter
     grads of the kernel path against an attn_impl="plain" bf16 model and
     an fp32 copy (the noise floor), on the same weights and batch.
  8. Train the 7b width at 16 of its 32 layers (fp32 master weights, bf16
     compute, remat save_flash, AdamW as scripts/run_train_text.sh), batch
     2 x 4096, 6 steps on one fixed batch from the seed: finite, falling
     loss, and K1/K2/K3 launched layers x steps times on that path.
The last lines: the card, one JSON object per kernel run, and
{"ok": true, "device": {...}}.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from lwm_tpu_torch import train
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
# K2/K3 vs their twin, per output: max|Δ| / max|ref| (bf16 outputs, p and ds
# rounded to bf16 at the same points, fp32 sums over 4096 keys in another
# order) and cosine
BWD_REL_TOL = 2e-2
BWD_COS_MIN = 0.9999
# kernel vs plain train step at 2 random 7b-width layers: the losses agree to
# 1e-2 (bf16 logits over a 32000 vocab), and per parameter the kernel path's
# 1 - cosine to the fp32 grads is at most FLOOR_RATIO x the plain bf16
# path's, plus GRAD_COS_SLACK for parameters where both are at fp32 noise
LOSS_TOL = 1e-2
GRAD_COS_SLACK = 1e-6
H100_BF16_PEAK = 989e12   # dense bf16 FLOP/s, H100 SXM data sheet
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


def _cosine(a, b):
    a, b = a.reshape(-1).double(), b.reshape(-1).double()
    return (a @ b / (a.norm() * b.norm()).clamp_min(1e-300)).item()


def phase_k23(gen):
    """K2/K3 at the training shapes against the plain twin. Returns
    ((K2 max_abs_err, K3 max_abs_err), (dq_ms, dkv_ms), plain_ms) — plain_ms
    is the twin's whole backward, which computes dq, dk and dv at once."""
    b, h, d = 2, 32, 128
    worst, timing = {"dq": 0.0, "dkv": 0.0}, None
    for name, h_kv, S in [("b2_S4096_h32_causal_padkeys", 32, 4096),
                          ("gqa_hkv8_S4096", 8, 4096), ("ragged_S4000_hkv8", 8, 4000)]:
        q, g = _randn((b, S, h, d), gen), _randn((b, S, h, d), gen)
        k, v = _randn((b, S, h_kv, d), gen), _randn((b, S, h_kv, d), gen)
        valid = torch.ones((b, S), dtype=torch.bool, device="cuda")
        valid[1, S - 300:] = False                     # right-padded row
        bias = torch.where(valid, 0.0, torch.finfo(BF16).min)[:, None, None, :]
        out, lse = flash.flash_attention_fwd(q, k, v, bias, causal=True)
        delta = torch.einsum("bqhd,bqhd->bhq", g.float(), out.float()).contiguous()
        args = (q, k, v, g, lse, delta, bias)
        got = (flash.flash_attention_bwd_dq(*args), *flash.flash_attention_bwd_dkv(*args))
        want = flash.flash_attention_bwd_plain(*args)
        torch.cuda.synchronize()
        parts = []
        for oname, a, r in zip(("dq", "dk", "dv"), got, want):
            diff = (a.float() - r.float()).abs().max().item()
            rel = diff / r.float().abs().max().item()
            cos = _cosine(a, r)
            parts.append(f"{oname} max|Δ|/max|ref| {rel:.3e} cos {cos:.6f}")
            if not (rel <= BWD_REL_TOL and cos >= BWD_COS_MIN):
                raise AssertionError(f"K2/K3 {name} {oname} disagrees with its plain twin")
            kernel = "dq" if oname == "dq" else "dkv"
            worst[kernel] = max(worst[kernel], diff)
        log(f"K2/K3 {name}: " + "; ".join(parts) +
            f" (bounds {BWD_REL_TOL}, cos {BWD_COS_MIN})")
        if timing is None:
            dq_ms = time_ms(lambda: flash.flash_attention_bwd_dq(*args), 10)
            dkv_ms = time_ms(lambda: flash.flash_attention_bwd_dkv(*args), 10)
            plain_ms = time_ms(lambda: flash.flash_attention_bwd_plain(*args), 3)
            log(f"K2/K3 {name}: K2 {dq_ms:.3f} ms, K3 {dkv_ms:.3f} ms, plain backward "
                f"{plain_ms:.3f} ms [{card()}]")
            timing = (dq_ms, dkv_ms), plain_ms
        del q, k, v, g, out, got, want, args
        torch.cuda.empty_cache()
    return (worst["dq"], worst["dkv"]), *timing


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

    torch.cuda.synchronize()
    _reset_launch_counts()
    t0 = time.perf_counter()
    done = {f.req_id: f for f in srv.run()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
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
    if min(launches["flash_fwd"], launches["flash_decode"]) <= 0:
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


def _lm_batch(b, s, vocab, seed):
    """A fixed next-token batch from the seed: targets are the inputs shifted."""
    toks = np.random.default_rng(seed).integers(2, vocab, (b, s + 1))
    return dict(
        input_tokens=torch.from_numpy(toks[:, :-1]).cuda(),
        target_tokens=torch.from_numpy(toks[:, 1:]).cuda(),
        loss_masks=torch.ones((b, s), device="cuda"),
    )


def _launch_counts():
    return {"flash_fwd": flash.flash_attention_fwd.launches,
            "flash_bwd_dq": flash.flash_attention_bwd_dq.launches,
            "flash_bwd_dkv": flash.flash_attention_bwd_dkv.launches,
            "flash_decode": decode.flash_decode.launches}


def _reset_launch_counts():
    for fn in (flash.flash_attention_fwd, flash.flash_attention_bwd_dq,
               flash.flash_attention_bwd_dkv, decode.flash_decode):
        fn.launches = 0


def phase_train_compare():
    """One train step's loss and grads at 7b width (2 layers, seq 4096):
    the kernel path vs attn_impl="plain" on the same fp32 weights (both
    computing in bf16), each held to an fp32 copy."""
    cfg = train.build_model_config("7b", update_llama_config=dict(num_hidden_layers=2))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    kernel = LLaMAForCausalLM(cfg, dtype=BF16, param_dtype=torch.float32, device="cuda")
    kernel.init_weights(gen)
    batch = _lm_batch(1, 4096, cfg.vocab_size, SEED + 1)
    results = {}
    for name, impl, dtype in [("kernel", "auto", BF16), ("plain", "plain", BF16),
                              ("fp32", "plain", torch.float32)]:
        if name == "kernel":
            model = kernel
        else:
            model = LLaMAForCausalLM(cfg.replace(attn_impl=impl), dtype=dtype,
                                     param_dtype=torch.float32, device="cuda")
            model.load_state_dict(kernel.state_dict())
        _reset_launch_counts()
        t0 = time.perf_counter()
        loss, _ = train.compute_loss(model, batch)
        loss.backward()
        torch.cuda.synchronize()
        grads = {n: p.grad for n, p in model.named_parameters()}
        results[name] = (loss.item(), grads, time.perf_counter() - t0, _launch_counts())
        if name != "kernel":
            del model
    (l_k, g_k, t_k, n_k), (l_p, g_p, t_p, _), (l_32, g_32, t_32, _) = (
        results[n] for n in ("kernel", "plain", "fp32"))
    log(f"train compare (7b width, 2 layers, 1 x 4096): loss kernel {l_k:.6f} plain {l_p:.6f} "
        f"fp32 {l_32:.6f} (|kernel - plain| tol {LOSS_TOL}); fwd+bwd s (one unwarmed call each) "
        f"kernel {t_k:.2f} plain {t_p:.2f} fp32 {t_32:.2f}; kernel-path launches {n_k}")
    if not (math.isfinite(l_k) and abs(l_k - l_p) <= LOSS_TOL):
        raise AssertionError("kernel-path loss disagrees with the plain path")
    if min(n_k[k] for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")) <= 0:
        raise AssertionError(f"a training kernel never launched: {n_k}")
    worst = (0.0, "")
    for n in g_k:
        c_k32, c_p32 = _cosine(g_k[n], g_32[n]), _cosine(g_p[n], g_32[n])
        ratio = (1 - c_k32) / max(1 - c_p32, 1e-12)
        worst = max(worst, (ratio, f"{n}: cosine to fp32 kernel {c_k32:.6f} plain {c_p32:.6f}"))
        if not 1 - c_k32 <= FLOOR_RATIO * (1 - c_p32) + GRAD_COS_SLACK:
            raise AssertionError(f"kernel-path grad of {n} is off the bf16 noise floor: "
                                 f"cosine to fp32 {c_k32:.6f} vs plain {c_p32:.6f}")
    log(f"train compare: every grad within {FLOOR_RATIO}x the plain path's distance to fp32 "
        f"(+{GRAD_COS_SLACK}); largest ratio {worst[0]:.3f} ({worst[1]})")
    del results, g_k, g_p, g_32, kernel
    torch.cuda.empty_cache()


def train_flops(cfg, b, s):
    """Model FLOPs of one step (no recompute): 6 x dense params x tokens,
    plus causal attention's 3 x 2 x 2 x b x s^2/2 x hidden per layer."""
    h, f, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    kv = cfg.kv_heads * cfg.head_dim
    dense = L * (2 * h * h + 2 * h * kv + 3 * h * f) + h * cfg.vocab_size
    return 6 * dense * b * s + L * 6 * b * s * s * h


def phase_train_full(profile=None):
    """The 7b width at 16 of its 32 layers, 6 AdamW steps (then, with a
    `profile` directory, one profiled step). Returns the launch counts of
    the 6-step run."""
    layers, b, s, steps = 16, 2, 4096, 6
    cfg = train.build_model_config("7b", update_llama_config=dict(num_hidden_layers=layers))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    t0 = time.perf_counter()
    model = LLaMAForCausalLM(cfg, dtype=BF16, param_dtype=torch.float32, device="cuda")
    model.init_weights(gen)
    # scripts/run_train_text.sh:29-35, with init_lr > 0 so that step 1 moves
    state = train.create_train_state(model, dict(adamw_optimizer=dict(
        weight_decay=0.1, lr=8e-5, end_lr=8e-5, lr_warmup_steps=5, lr_decay_steps=200,
        init_lr=8e-6)))
    batch = _lm_batch(b, s, cfg.vocab_size, SEED + 2)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    log(f"train: 7b width x {layers} layers ({n_params / 1e9:.2f}B params, fp32 master "
        f"weights, bf16 compute, remat {cfg.remat_block}), batch {b} x {s}, built in "
        f"{time.perf_counter() - t0:.1f}s")
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    losses, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        m = train.train_step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(m["loss"].item())
        log(f"train step {i + 1}: loss {losses[-1]:.5f} acc {m['acc'].item():.5f} "
            f"lr {m['learning_rate'].item():.3e} grad_norm {m['gradient_norm'].item():.4f} "
            f"param_norm {m['param_norm'].item():.2f} time {times[-1]:.3f}s")
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_s = float(np.median(times[1:]))
    flops = train_flops(cfg, b, s)
    log(f"train: {steps} steps, launches {launches}; step time median of steps 2-{steps} "
        f"{step_s:.3f}s, {b * s / step_s:.0f} tokens/s, model FLOPs {flops / 1e12:.1f} T/step "
        f"= {flops / step_s / 1e12:.1f} TFLOP/s = {100 * flops / step_s / H100_BF16_PEAK:.1f}% "
        f"of 989 TFLOP/s; peak memory {peak:.1f} GiB [{card()}]")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"training loss not finite and falling: {losses}")
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if launches[k] != layers * steps:
            raise AssertionError(f"{k} launched {launches[k]} times, want {layers * steps}")
    if profile:
        profile_step(state, batch, profile)
    return launches


def _kernel_kind(name):
    if "flash_fwd_kernel" in name:
        return "K1 flash_fwd"
    if "flash_bwd_dq_kernel" in name:
        return "K2 flash_bwd_dq"
    if "flash_bwd_dkv_kernel" in name:
        return "K3 flash_bwd_dkv"
    if any(t in name.lower() for t in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "dot_kernel")):
        return "dense (cuBLAS)"
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return "memcpy/memset"
    return "elementwise/reduce/other"


def profile_step(state, batch, out_dir):
    """One more train step under torch.profiler: device time by kind, from
    the kernel events only (GPU-side user annotations such as the optimizer
    step span kernels already counted, and are reported apart); the full
    table goes to out_dir/train_step_profile.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train.train_step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kinds, spans = {}, {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        ms = ev.time_range.elapsed_us() / 1e3
        if getattr(ev, "is_user_annotation", False) or ev.name.startswith("Optimizer."):
            spans[ev.name] = spans.get(ev.name, 0.0) + ms
            continue
        kind = _kernel_kind(ev.name)
        kinds[kind] = kinds.get(kind, 0.0) + ms
    busy = sum(kinds.values())
    if busy <= 0:
        log("profile: the profiler recorded no device kernels")
        return
    log(f"profile: one train step {wall_ms:.1f} ms wall (profiled), kernels {busy:.1f} ms: "
        f"device busy {100 * busy / wall_ms:.1f}%, idle {100 - 100 * busy / wall_ms:.1f}% "
        f"[{card()}]")
    for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        log(f"profile:   {kind}: {ms:.1f} ms ({100 * ms / busy:.1f}% of kernel time)")
    for name, ms in sorted(spans.items(), key=lambda kv: -kv[1])[:3]:
        log(f"profile:   span {name}: {ms:.1f} ms on the device")
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    (Path(out_dir) / "train_step_profile.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))


def main():
    args = sys.argv[1:]
    if args and (args[0] != "--profile" or len(args) != 2):
        raise SystemExit("usage: chip_smoke.py [--profile DIR]")
    profile = args[1] if args else None
    phase_env()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k1 = phase_k1(gen)
    k4 = phase_k4(gen)
    k23 = phase_k23(gen)
    torch.cuda.empty_cache()
    _reset_launch_counts()
    serve_launches, _ = phase_serve()
    torch.cuda.empty_cache()
    phase_train_compare()
    train_launches = phase_train_full(profile)
    kernels = [
        dict(name="flash_fwd", route="cuda", source="lwm_tpu_torch/csrc/flash_fwd.cu",
             replaces="lwm_tpu/ops/pallas_flash.py:199",
             launches=serve_launches["flash_fwd"] + train_launches["flash_fwd"],
             max_abs_err=k1[0], ms=k1[1], plain_ms=k1[2]),
        dict(name="flash_bwd_dq", route="cuda", source="lwm_tpu_torch/csrc/flash_bwd.cu",
             replaces="lwm_tpu/ops/pallas_flash.py:288",
             launches=train_launches["flash_bwd_dq"],
             max_abs_err=k23[0][0], ms=k23[1][0], plain_ms=k23[2]),
        dict(name="flash_bwd_dkv", route="cuda", source="lwm_tpu_torch/csrc/flash_bwd.cu",
             replaces="lwm_tpu/ops/pallas_flash.py:356",
             launches=train_launches["flash_bwd_dkv"],
             max_abs_err=k23[0][1], ms=k23[1][1], plain_ms=k23[2]),
        dict(name="flash_decode", route="cuda", source="lwm_tpu_torch/csrc/flash_decode.cu",
             replaces="lwm_tpu/ops/pallas_decode.py:66", launches=serve_launches["flash_decode"],
             max_abs_err=k4[0], ms=k4[1], plain_ms=k4[2]),
    ]
    log(card())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
