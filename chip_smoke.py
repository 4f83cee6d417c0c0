#!/usr/bin/env python3
"""Drive the PyTorch port (lwm_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

    python3 chip_smoke.py --profile DIR   # also profile one more train step and
                                          # write its kernel table to DIR

Phases; any failure raises and exits non-zero (there is no CPU path):
  1. torch/CUDA versions and the card (nvidia-smi name, power limit).
  2. Build the CUDA kernels from lwm_tpu_torch/csrc with nvcc (sm_90a).
  3. K1 flash_attention_fwd vs its plain twin at the serving and training
     shapes and at the edges of its tiles (K1_CASES), timed at a 2048-token
     admission over the 4096-slot cache and at the train step's attention
     (b 2, seq 4096, 32 heads, d 128).
  4. K4 flash_decode vs its plain twin, output and (o, m, l) partials, at
     8 slots (bf16 and int8, MHA and GQA; a row with no valid key gives
     (0, BIG_NEG, 0)) and at one slot of T 65536; every case timed.
  5. The fused backward flash_attention_bwd (dq, dk, dv in one kernel) vs
     its plain twin at the training shapes (b 2, seq 4096, 32 heads, d 128;
     GQA; a ragged seq) and at edges of its tiles (seq 1000 with offsets
     and a full-tile bias, causal or not; d 64 at 8 kv heads).
  6. K5 int8_matmul and K6 w8a8_matmul vs their plain twins at the int8
     serving shapes: decode (8 slots; also the 1b preset's wq and w2) and
     admission at each bucket (m 256/
     1024/2048, ragged 2000) and product (all four at m 2048; wq, w1, w2
     and lm_head at m 256); ragged edges sized to the GEMMs' tiles, K5's
     and K6's alike (m 17/65/129/130/300/1000, d 4112, f 999/4001/4040),
     and to K5's and K6's decode GEMVs (one row tile, split and ring rule):
     one request (m 1) and both token tiles full (m 16) at a ragged d and f
     (4112, 999), and each side of every boundary of their split of d
     across a cluster (f 2080/2112/2144 and 4192/4224, d 4080 and 2032)
     and of their ring depth (f 4224/4256 and 8448/8480).
     Each timed shape logs the kernel from graph replays and from eager
     launches (the host path a decode round pays), its twin, one PyTorch
     call and the bound.
  7. Serve 12 requests through InflightServer with the 7b preset at the
     scripts/run_serve.sh settings (bf16, theta 5e7, 8 slots, cache 4096,
     buckets 256/1024/2048), random weights from a seed, after one untimed
     warm-up admission at each bucket (as every serving arm); check every
     request and the K1/K4 launch counts of that path; hold kernel-path
     admission logits against an attn_impl="plain" model on the same
     weight tensors and against an fp32 copy of them.
  8. The same weights quantized on the card (`quantize_params_int8`, the
     run_serve.sh QUANTIZE=1 bundle): serve the 12 requests with
     quant_dense="int8" (K5 for every dense product) and 4 with
     "int8_w8a8" and an int8 cache (K6, K5 for lm_head); exact launch
     counts, K5's and K6's admission GEMMs counted apart; admission logits
     of K5 against the "int8_xla" dequant arm on the same int8 tensors,
     and of both (and W8A8) against an fp32 copy of the dequantized
     weights.
  9. Train step at 7b width (2 layers, seq 4096): loss and per-parameter
     grads of the kernel path against an attn_impl="plain" bf16 model and
     an fp32 copy (the noise floor), on the same weights and batch.
 10. Train the 7b width at 16 of its 32 layers (fp32 master weights, bf16
     compute, remat save_flash, AdamW as scripts/run_train_text.sh), batch
     2 x 4096, 6 steps on one fixed batch from the seed: finite, falling
     loss, and K1 and the backward launched layers x steps times on that
     path.
Each kernel phase times the kernel, its plain twin and one PyTorch call that
computes the same function (the yardstick; the port never calls it) beside
the kernel's bound: the larger of its bytes over 3.35 TB/s and its
operations over the peak rate of their type (H100 SXM data sheet). K4, K5
and K6 (every shape) and their library calls are timed by replaying the
calls from a captured CUDA graph, so a 20-60 us kernel is not timed at the
host's launch rate.
The last lines: the card, one JSON object listing every kernel, and
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
import torch.nn.functional as F

from lwm_tpu_torch import train
from lwm_tpu_torch.models.llama import LLaMAConfig, LLaMAForCausalLM, quantize_kv
from lwm_tpu_torch.ops import _build, decode, flash, quant
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
# K5 vs the "int8_xla" arm on the same int8 weights: that arm rounds twice
# (the bf16 product, then x bf16 scale), so it sits further from the fp32
# result than a bf16 path does (1 - cosine 0.0023 vs K5's 0.0018 at prompt
# 50 on an H100 80GB HBM3 at 700 W, PERF.md), and two independent noises add:
# ~0.0042 expected, more at longer prompts. The floor-ratio and argmax
# checks are the guards; where the arm's argmax misses the fp32 one, K5 may
# pick the fp32 token (prompt 700: K5 and fp32 19947, int8_xla 16244)
INT8_ARM_COS_MIN = 0.994
# the fused backward vs its twin, per output: max|Δ| / max|ref| (bf16
# outputs, p and ds rounded to bf16 at the same points, fp32 sums over 4096
# keys in another order; dq is summed across key tiles by fp32 atomics, whose
# order changes from run to run) and cosine
BWD_REL_TOL = 2e-2
BWD_COS_MIN = 0.9999
# kernel vs plain train step at 2 random 7b-width layers: the losses agree to
# 1e-2 (bf16 logits over a 32000 vocab), and per parameter the kernel path's
# 1 - cosine to the fp32 grads is at most FLOOR_RATIO x the plain bf16
# path's, plus GRAD_COS_SLACK for parameters where both are at fp32 noise
LOSS_TOL = 1e-2
GRAD_COS_SLACK = 1e-6
# K5 vs its twin: max|Δ| / max|ref| (bf16 output, fp32 sums in another order)
QUANT_REL_TOL = 1e-2
# W8A8 serving with the int8 cache: admission-logit cosine to an fp32 run of
# the dequantized weights. Per-row int8 activations add ~1-3% rounding noise
# at each of the 224 quantized products (bf16 adds ~0.4% per op and lands at
# 0.998), and 32 random layers amplify it: measured 0.959-0.969 at prompts
# 50/700/2000 (H100 80GB HBM3 at 700 W, PERF.md). The bound sits below that;
# K6 itself is held bit for bit to its twin, and to JAX on the CPU
W8A8_COS_MIN = 0.93
H100_BF16_PEAK = 989e12   # dense bf16 FLOP/s, H100 SXM data sheet
H100_INT8_PEAK = 1979e12  # dense int8 OP/s
H100_HBM = 3.35e12        # bytes/s
L2_FLUSH_BYTES = 150e6    # weight copies cycled in a timing: 3x the 50 MB L2
SEED = 0
# K5/K6 vs their twins: name, m, d (in), f (out). Decode is m = 8 slots;
# admission is m = a bucket (256, 1024, 2048; and a ragged 2000) at each
# product shape (wq/wk/wv/wo 4096→4096, w1/w3 4096→11008, w2 11008→4096,
# lm_head 4096→32000). The edges exercise the masked m, d and f tails, both
# of the decode kernels' token tiles, the GEMMs' smallest m (17) and each
# tile that K5's and K6's GEMMs pick (the same rule): m 17, 65, 129 and 130
# at f 999 take the 64-row tile, m 300 at f 4001 the 128-row one, m 1000 at
# f 4001 and 4040 the 256-row one. d 4112 ends in a 16-byte piece of a k
# tile; f 999 and 4001 are stored element by element by K6, 4040 (a
# multiple of 8) in 16-byte chunks up to a last column tile of 72. The decode
# GEMVs (m <= 16) take 32 output channels a block, 8 tokens a column tile (m
# 1 and 13 fill one in part, m 9 and 16 two), 128 k a stage (d 4112 and
# 4080 end inside a box, 2032 in its last 16) and split d over a cluster by
# rules of their own. K5 splits into 4 blocks while the 32-channel tiles
# times 2 leave SMs of the H100's 132 without a block (f <= 2080) and d >=
# 4096, into 2 while the tiles alone do (f <= 4192) and d >= 2048: f 999,
# 2080 take 4; f 2112, 4192 (and f 999 at d 4080) take 2; f 4224 (and d
# 2032) none. Its ring has 8 stages up to two blocks an SM (f 8448 unsplit:
# 264 blocks), 4 above (f 8480). K6 splits into 2 while the split grid still
# gives each SM at most one block (up to 66 tiles: f 999, 2080, 2112; none at
# f 2144) and d >= 4096 (none at d 4080 or 2032); its ring has 16 stages up
# to one block an SM (f 4192, 4224 unsplit), 8 up to two (f 4256, 8448), 4
# above (f 8480). The 1b preset's wq and w2 (timed) take K6's two sides of d.
QUANT_SHAPES = [
    ("decode_m8_wq_4096x4096", 8, 4096, 4096),
    ("decode_m8_w1_4096x11008", 8, 4096, 11008),
    ("decode_m8_w2_11008x4096", 8, 11008, 4096),
    ("decode_m8_head_4096x32000", 8, 4096, 32000),
    ("decode_m8_1b_wq_2048x2048", 8, 2048, 2048),
    ("decode_m8_1b_w2_5504x2048", 8, 5504, 2048),
    ("admit_m256_wq_4096x4096", 256, 4096, 4096),
    ("admit_m256_w1_4096x11008", 256, 4096, 11008),
    ("admit_m256_w2_11008x4096", 256, 11008, 4096),
    ("admit_m2048_wq_4096x4096", 2048, 4096, 4096),
    ("admit_m256_head_4096x32000", 256, 4096, 32000),
    ("admit_m1024_w1_4096x11008", 1024, 4096, 11008),
    ("admit_m2048_w1_4096x11008", 2048, 4096, 11008),
    ("admit_m2048_w2_11008x4096", 2048, 11008, 4096),
    ("admit_m2048_head_4096x32000", 2048, 4096, 32000),
    ("admit_m2000_w1_4096x11008", 2000, 4096, 11008),
    ("admit_m2000_head_4096x32000", 2000, 4096, 32000),
    ("edge_m1_d4112_f999", 1, 4112, 999),
    ("edge_m13_d4112_f999", 13, 4112, 999),
    ("edge_m16_d4112_f999", 16, 4112, 999),
    ("edge_m8_d4112_f2080", 8, 4112, 2080),
    ("edge_m8_d4112_f2112", 8, 4112, 2112),
    ("edge_m16_d4112_f4192", 16, 4112, 4192),
    ("edge_m16_d4112_f4224", 16, 4112, 4224),
    ("edge_m9_d4080_f999", 9, 4080, 999),
    ("edge_m1_d2032_f999", 1, 2032, 999),
    ("edge_m8_d4112_f8448", 8, 4112, 8448),
    ("edge_m16_d4112_f8480", 16, 4112, 8480),
    ("edge_m1_d4112_f2144", 1, 4112, 2144),
    ("edge_m9_d4112_f4256", 9, 4112, 4256),
    ("edge_m17_d4112_f999", 17, 4112, 999),
    ("edge_m65_d4112_f999", 65, 4112, 999),
    ("edge_m129_d4112_f999", 129, 4112, 999),
    ("edge_m130_d4112_f999", 130, 4112, 999),
    ("edge_m300_d4112_f4001", 300, 4112, 4001),
    ("edge_m1000_d4112_f4001", 1000, 4112, 4001),
    ("edge_m1000_d4112_f4040", 1000, 4112, 4040),
]
# the shapes the kernels line reports for K5/K6: w1 (and w3) of every decode
# round; and, by name, their other decode products (wq, w2, the lm_head
# shape, which W8A8 runs on K5), for K6 also the 1b preset's w2 (its split
# of d), and their admission GEMMs at a 2048-token admission: w1 for both,
# w2 for K6
QUANT_REPORT = "decode_m8_w1_4096x11008"
QUANT_DECODE_NAMED = ("decode_m8_wq_4096x4096", "decode_m8_w2_11008x4096",
                      "decode_m8_head_4096x32000")
QUANT_NAMED_REPORTS = {
    "int8_matmul": (*QUANT_DECODE_NAMED, "admit_m2048_w1_4096x11008"),
    "w8a8_matmul": (*QUANT_DECODE_NAMED, "decode_m8_1b_w2_5504x2048",
                    "admit_m2048_w1_4096x11008", "admit_m2048_w2_11008x4096"),
}


def log(msg):
    print(msg, flush=True)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, arg_sets=((),), graph=False):
    """Mean ms per call on the device (CUDA events, after a warm-up). Calls
    cycle through `arg_sets`: copies of a large operand keep a weight
    stream out of the 50 MB L2, as in a forward where every layer's weights
    are new. With `graph`, the `iters` calls are captured once in a CUDA
    graph and the replay is timed, so the device never waits on the host's
    Python and ctypes launch path (the wrappers launch on the current
    stream and allocate through torch, so they are capture-safe)."""
    def run():
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])

    fn(*arg_sets[0])
    torch.cuda.synchronize()
    if graph:
        cuda_graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(cuda_graph):
            run()
        cuda_graph.replay()
        torch.cuda.synchronize()
        run = cuda_graph.replay
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes, n_ops, peak):
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over `peak`. Returns (ms, what bounds it)."""
    t_bytes, t_ops = n_bytes / H100_HBM, n_ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def attn_pairs(valid_keys, sq, q_offset):
    """(query, key) pairs attention needs: key j is seen by query i when it
    is valid and j <= q_offset + i. valid_keys: bool [T] or [b, T]."""
    v = valid_keys.reshape(-1, valid_keys.shape[-1]).long()
    seen = torch.cumsum(v, -1)                                  # valid keys <= j
    last = (q_offset + torch.arange(sq, device=v.device)).clamp(max=v.shape[-1] - 1)
    return int(seen[:, last].sum())


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
        if any(t in line for t in ("entry function", "registers", "spill", "wgmma")):
            log(f"  ptxas {line.strip()}")


def _randn(shape, gen, dtype=BF16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


# K1's cases: name, b, h_kv, d, sq, skv, causal, q_offset, kv_offset,
# head-major kv (the serving cache) or seq-major (training), bias kind. The
# first two are timed: a 2048-token admission over the 4096-slot cache, and
# the train step's attention (7b width, batch 2 x 4096, the model's per-key
# bias with 300 right-padded keys in row 1, as BWD_CASES[0]). The rest hold
# the edges of the kernel's 128-query and 128-key tiles: a 16-row block
# over a full-tile bias; GQA; a ragged 2000-token bucket (its last query
# tile has 80 rows); seq 1000 with offsets off the tile grid and a
# full-tile bias, causal and not (a 104-row query tile, a 104-key tile);
# d 64 at 8 kv heads; rows with no valid key (out 0, lse BIG_NEG)
K1_TRAIN_REPORT = "train_b2_S4096_h32_causal_padkeys"
K1_TIMED = ("bucket2048_T4096_perkey", K1_TRAIN_REPORT)
K1_CASES = [
    ("bucket2048_T4096_perkey", 1, 32, 128, 2048, 4096, True, 0, 0, True, "prompt"),
    (K1_TRAIN_REPORT, 2, 32, 128, 4096, 4096, True, 0, 0, False, "per_key"),
    ("q16_fulltile_qoff1000", 1, 32, 128, 16, 4096, True, 1000, 0, True, "frontier"),
    ("gqa_hkv8_bucket1024", 1, 8, 128, 1024, 4096, True, 0, 0, True, "prompt"),
    ("ragged_bucket2000_T4096", 1, 32, 128, 2000, 4096, True, 0, 0, True, "prompt"),
    ("S1000_causal_offsets_fulltile", 2, 32, 128, 1000, 1000, True, 700, 300, False, "full"),
    ("S1000_noncausal_offsets_fulltile", 2, 32, 128, 1000, 1000, False, 700, 300, False, "full"),
    ("d64_hkv8_S4096", 2, 8, 64, 4096, 4096, True, 0, 0, False, "per_key"),
    ("q300_rows_without_keys", 1, 32, 128, 300, 4096, True, 3000, 0, True, "no_keys"),
]
K1_EMPTY_ROWS = (0, 129, 299)   # the rows "no_keys" masks whole


def _k1_bias(kind, b, sq, T, q_off, gen):
    """(bias, valid keys or None) for a K1 case. "prompt": an admission's
    per-key bias, the prompt's keys valid; "per_key" and "full": the
    backward's (_bwd_bias); "frontier": per-row frontiers with 20% random
    holes over a full tile, and "no_keys" the same with K1_EMPTY_ROWS
    masked whole."""
    keys = torch.arange(T, device="cuda")
    if kind == "prompt":
        valid = keys < sq - 37
        return torch.where(valid, 0.0, BIG_NEG)[None, None, None, :], valid
    if kind in ("per_key", "full"):
        return _bwd_bias(kind, b, T, gen)
    rows = q_off + torch.arange(sq, device="cuda")[:, None]
    holes = torch.rand((sq, T), generator=gen, device="cuda") < 0.2
    valid = (keys[None] <= rows) & ~(holes & (keys[None] > 0))
    if kind == "no_keys":
        valid[list(K1_EMPTY_ROWS)] = False
    return torch.where(valid, 0.0, BIG_NEG)[None, None], None


def _time_k1(q, k, v, bias, valid, kw):
    """K1, its plain twin and SDPA with the same mask as a float bias, and
    the bound, at one timed case: dict(ms, plain_ms, library_ms, bound_ms,
    bound_by)."""
    sq, h = q.shape[1:3]
    head_major = kw["kv_head_major"]
    h_kv = k.shape[1] if head_major else k.shape[2]
    T = k.shape[2] if head_major else k.shape[1]
    ms = time_ms(lambda: flash.flash_attention_fwd(q, k, v, bias, **kw))
    plain_ms = time_ms(lambda: flash.flash_attention_fwd_plain(q, k, v, bias, **kw), 3)
    # yardstick: SDPA with the same float bias, causal by position
    pos = kw["q_offset"] + torch.arange(sq, device="cuda")
    mask = torch.where(torch.arange(T, device="cuda")[None] <= pos[:, None], bias, BIG_NEG)
    mask = mask.to(BF16)
    kt, vt = (k, v) if head_major else (k.transpose(1, 2), v.transpose(1, 2))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), kt, vt, attn_mask=mask, enable_gqa=h_kv != h))
    del mask
    bnd, by = k1_bound(q, k, bias, valid, kw)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd, bound_by=by)


def k1_bound(q, k, bias, valid, kw):
    """K1's bound at one case: (ms, what bounds it). q read and out written
    in bf16, the valid keys' k and v read once, lse written, the bias read;
    two products of 2·d flops a (query, key) pair and head."""
    b, sq, h, d = q.shape
    h_kv = k.shape[1] if kw["kv_head_major"] else k.shape[2]
    pairs = attn_pairs(valid, sq, kw["q_offset"])
    n_bytes = 2 * q.numel() * 2 + 2 * int(valid.sum()) * h_kv * d * 2 + b * h * sq * 4
    n_bytes += bias.numel() * 4
    return bound_ms(n_bytes, 4 * d * h * pairs, H100_BF16_PEAK)


def phase_k1(gen):
    """K1 against its plain twin at K1_CASES. Returns (max_abs_err, ms,
    plain_ms, library_ms, bound_ms, bound_by) with the times at the
    admission case, and the same times as a dict at K1_TRAIN_REPORT."""
    h = 32
    worst, timed = 0.0, {}
    for name, b, h_kv, d, sq, T, causal, q_off, kv_off, head_major, kind in K1_CASES:
        q = _randn((b, sq, h, d), gen)
        kv_shape = (b, h_kv, T, d) if head_major else (b, T, h_kv, d)
        k, v = _randn(kv_shape, gen), _randn(kv_shape, gen)
        bias, valid = _k1_bias(kind, b, sq, T, q_off, gen)
        kw = dict(causal=causal, q_offset=q_off, kv_offset=kv_off, kv_head_major=head_major)
        out, lse = flash.flash_attention_fwd(q, k, v, bias, **kw)
        ref, ref_lse = flash.flash_attention_fwd_plain(q, k, v, bias, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        log(f"K1 {name}: max|out-plain| {err:.3e} (tol {BF16_TOL}) "
            f"max|lse-plain| {lse_err:.3e} (tol {LSE_TOL})")
        if not (err <= BF16_TOL and lse_err <= LSE_TOL):
            raise AssertionError(f"K1 {name} disagrees with its plain twin")
        if kind == "no_keys":
            rows = list(K1_EMPTY_ROWS)
            if not (torch.all(out[:, rows] == 0) and torch.all(lse[:, :, rows] == BIG_NEG)):
                raise AssertionError(f"K1 {name}: rows with no valid key are not 0 / BIG_NEG")
            log(f"K1 {name}: rows {rows} give out 0 and lse BIG_NEG")
        worst = max(worst, err)
        if name in K1_TIMED:
            t = timed[name] = _time_k1(q, k, v, bias, valid, kw)
            log(f"K1 {name}: kernel {t['ms']:.3f} ms ({100 * t['bound_ms'] / t['ms']:.1f}% of the "
                f"bound), plain {t['plain_ms']:.3f} ms, SDPA {t['library_ms']:.3f} ms, bound "
                f"{t['bound_ms']:.4f} ms ({t['bound_by']}) [{card()}]")
        del q, k, v, out, ref, bias
        torch.cuda.empty_cache()
    admit = timed[K1_TIMED[0]]
    return (worst, *(admit[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")),
            timed[K1_TRAIN_REPORT])


# K4's cases: name, b, h_kv, T, int8 cache. At 8 slots (7b: 32 heads, d 128,
# T 4096) the rows hold 4001, 18, 1749 (a left-pad hole of 300), 3001, 1,
# 514, 1025 and 4000 valid keys under kv_len 4001, as a serving round's
# slots do; bf16 and int8, MHA and GQA (8 kv heads). The last is one long
# request: one slot, T 65536, every key valid (an LWM long-context decode
# step). Every case is timed; the first is the row's headline.
K4_CASES = [
    ("bf16_mha", 8, 32, 4096, False),
    ("bf16_gqa_hkv8", 8, 8, 4096, False),
    ("int8_mha", 8, 32, 4096, True),
    ("int8_gqa_hkv8", 8, 8, 4096, True),
    ("bf16_mha_b1_T65536", 1, 32, 65536, False),
]
K4_SLOT_LENGTHS = [4000, 17, 2048, 3000, 0, 513, 1024, 3999]   # last valid key of each row
K4_EMPTY_ROW = 4     # cleared whole in the no-key check


def k4_inputs(case, gen):
    """(q, k, v, mask, kv_len, k_scale, v_scale) of one K4 case."""
    name, b, h_kv, T, int8 = case
    h, d = 32, 128
    if b == 1:
        mask = torch.ones((1, T), dtype=torch.bool, device="cuda")
        kv_len = T
    else:
        lengths = torch.tensor(K4_SLOT_LENGTHS, device="cuda")
        mask = torch.arange(T, device="cuda")[None] <= lengths[:, None]
        mask[2, :300] = False            # a left-pad hole
        kv_len = int(lengths.max()) + 1
    q = _randn((b, 1, h, d), gen)
    k, v = _randn((b, h_kv, T, d), gen), _randn((b, h_kv, T, d), gen)
    ks = vs = None
    if int8:
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
    return q, k, v, mask, kv_len, ks, vs


def k4_bound(q, k, mask, kv_len):
    """K4's bound: (ms, what bounds it, valid-key bytes). q read and out
    written in bf16, the mask read up to kv_len, each valid key's k and v
    read once (and with an int8 cache their two fp32 scales); two products
    of 2·d flops a valid key and query head."""
    b, _, h, d = q.shape
    h_kv = k.shape[1]
    n_valid = int(mask[:, :kv_len].sum())
    kv_bytes = n_valid * h_kv * (2 * d * k.element_size() + (8 if k.dtype == torch.int8 else 0))
    n_bytes = kv_bytes + 2 * q.numel() * 2 + b * kv_len
    return (*bound_ms(n_bytes, 4 * n_valid * h * d, H100_BF16_PEAK), kv_bytes)


def k4_arg_sets(args, kv_bytes):
    """Copies of the cache cycled in a timing, so the valid keys of the
    calls between two reads of one copy exceed L2_FLUSH_BYTES (3x the L2)."""
    q, k, v, mask, kv_len, ks, vs = args
    n = max(1, math.ceil(L2_FLUSH_BYTES / kv_bytes))
    sets = [args]
    for _ in range(n - 1):
        sets.append((q, k.clone(), v.clone(), mask, kv_len,
                     None if ks is None else ks.clone(), None if vs is None else vs.clone()))
    return sets


def _k4_check(name, args):
    """The kernel against its twin, plain output and partials; returns the
    worst max|Δ| on o."""
    out = decode.flash_decode(*args)
    ref = decode.flash_decode_plain(*args)
    o, m, l = decode.flash_decode(*args, return_partials=True)
    ro, rm, rl = decode.flash_decode_plain(*args, return_partials=True)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    o_err = (o.float() - ro.float()).abs().max().item()
    m_err = (m - rm).abs().max().item()
    l_rel = ((l - rl).abs().max() / rl.abs().max()).item()
    log(f"K4 {name}: max|out-plain| {err:.3e} (tol {BF16_TOL}); partials max|o-plain| "
        f"{o_err:.3e} (tol {BF16_TOL}), max|m-plain| {m_err:.3e} (tol {LSE_TOL}), "
        f"max|l-plain|/max l {l_rel:.3e} (tol {LSE_TOL})")
    if not (err <= BF16_TOL and o_err <= BF16_TOL and m_err <= LSE_TOL and l_rel <= LSE_TOL):
        raise AssertionError(f"K4 {name} disagrees with its plain twin")
    if not torch.equal(o, out):
        raise AssertionError(f"K4 {name}: o with partials differs from the plain output")
    return max(err, o_err)


def phase_k4(gen):
    """K4 at K4_CASES against its plain twin (output and partials), with a
    row of no valid key at the 8-slot cases, each case timed. Returns
    (max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by) at the first
    case, and {name: dict(ms, plain_ms, library_ms, bound_ms, bound_by)} for
    the others."""
    worst, first, others = 0.0, None, {}
    for case in K4_CASES:
        name, b, h_kv, T, int8 = case
        args = k4_inputs(case, gen)
        q, k, v, mask, kv_len, ks, vs = args
        worst = max(worst, _k4_check(name, args))
        if b > K4_EMPTY_ROW:
            cleared = mask.clone()
            cleared[K4_EMPTY_ROW] = False
            args0 = (q, k, v, cleared, kv_len, ks, vs)
            worst = max(worst, _k4_check(f"{name} row {K4_EMPTY_ROW} cleared", args0))
            o, m, l = decode.flash_decode(*args0, return_partials=True)
            r = K4_EMPTY_ROW
            if not (torch.all(o[r] == 0) and torch.all(m[r] == BIG_NEG) and torch.all(l[r] == 0)):
                raise AssertionError(f"K4 {name}: a row with no valid key is not (0, BIG_NEG, 0)")
        bnd, by, kv_bytes = k4_bound(q, k, mask, kv_len)
        sets = k4_arg_sets(args, kv_bytes)
        ms = time_ms(lambda *a: decode.flash_decode(*a), 50, sets, graph=True)
        plain_ms = time_ms(lambda: decode.flash_decode_plain(*args), 3)
        lib_ms, lib = None, "no SDPA for an int8 cache"
        if not int8:
            # yardstick: SDPA at q = 1 with the same keys (bool mask, GQA)
            seen = (mask & (torch.arange(T, device="cuda") < kv_len)[None])[:, None, None, :]
            lib_ms = time_ms(lambda q, k, v, *_: F.scaled_dot_product_attention(
                q.transpose(1, 2), k, v, attn_mask=seen, enable_gqa=h_kv != 32), 50, sets,
                graph=True)
            lib = f"SDPA {lib_ms:.4f} ms (graph)"
            del seen
        eager = ""
        if first is None:
            eager_ms = time_ms(lambda *a: decode.flash_decode(*a), 50, sets)
            eager = f"; eager launches {eager_ms:.4f}"
        log(f"K4 {name}: kernel {ms:.4f} ms (graph{eager}; {100 * bnd / ms:.1f}% of the bound), "
            f"plain {plain_ms:.3f} ms, {lib}, bound {bnd:.4f} ms ({by}) (b={b} h=32 "
            f"h_kv={h_kv} T={T} kv_len={kv_len}; {len(sets)} cache copies cycled) [{card()}]")
        t = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd, bound_by=by)
        if first is None:
            first = t
        else:
            others[name] = t
        del args, q, k, v, ks, vs, sets
        torch.cuda.empty_cache()
    return (worst, *(first[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")),
            others)


def _cosine(a, b):
    a, b = a.reshape(-1).double(), b.reshape(-1).double()
    return (a @ b / (a.norm() * b.norm()).clamp_min(1e-300)).item()


# the fused backward's cases: name, h_kv, d, seq, causal, q_offset,
# kv_offset, bias kind. The first is the train step's attention (7b width,
# batch 2 x 4096, the model's per-key bias with 300 right-padded keys in row
# 1) and the timed one; the seq-1000 cases end in a ragged key tile (104 of
# 128) and query tile (40 of 64), and their offsets move the causal start
# off the tile grid
BWD_CASES = [
    ("b2_S4096_h32_causal_padkeys", 32, 128, 4096, True, 0, 0, "per_key"),
    ("gqa_hkv8_S4096", 8, 128, 4096, True, 0, 0, "per_key"),
    ("ragged_S4000_hkv8", 8, 128, 4000, True, 0, 0, "per_key"),
    ("S1000_noncausal_offsets_fulltile", 32, 128, 1000, False, 700, 300, "full"),
    ("S1000_causal_offsets_fulltile_hkv8", 8, 128, 1000, True, 700, 300, "full"),
    ("d64_hkv8_S4096", 8, 64, 4096, True, 0, 0, "per_key"),
]


def _bwd_bias(kind, b, S, gen):
    """The model's per-key bias (finfo.min on 300 right-padded keys of row
    1), or a full-tile one: random values with 20% random holes, key 0
    always valid."""
    if kind == "per_key":
        valid = torch.ones((b, S), dtype=torch.bool, device="cuda")
        valid[1, S - 300:] = False
        return torch.where(valid, 0.0, torch.finfo(BF16).min)[:, None, None, :], valid
    holes = torch.rand((b, S, S), generator=gen, device="cuda") < 0.2
    holes[:, :, 0] = False
    vals = torch.randn((b, S, S), generator=gen, device="cuda")
    return torch.where(holes, BIG_NEG, vals)[:, None], None


def phase_bwd(gen):
    """The fused backward at the training shapes and the tile edges against
    the plain twin. Returns (max_abs_err, ms, plain_ms, library_ms, bound_ms,
    bound_by), the times at the first case; plain_ms is the twin's whole
    backward, library_ms SDPA's backward (dq, dk, dv) with the same mask."""
    b, h = 2, 32
    worst, timing = 0.0, None
    for name, h_kv, d, S, causal, q_off, kv_off, kind in BWD_CASES:
        q, g = _randn((b, S, h, d), gen), _randn((b, S, h, d), gen)
        k, v = _randn((b, S, h_kv, d), gen), _randn((b, S, h_kv, d), gen)
        bias, valid = _bwd_bias(kind, b, S, gen)
        kw = dict(causal=causal, q_offset=q_off, kv_offset=kv_off)
        out, lse = flash.flash_attention_fwd(q, k, v, bias, **kw)
        delta = torch.einsum("bqhd,bqhd->bhq", g.float(), out.float()).contiguous()
        args = (q, k, v, g, lse, delta, bias)
        got = flash.flash_attention_bwd(*args, **kw)
        want = flash.flash_attention_bwd_plain(*args, **kw)
        torch.cuda.synchronize()
        parts = []
        for oname, a, r in zip(("dq", "dk", "dv"), got, want):
            diff = (a.float() - r.float()).abs().max().item()
            rel = diff / r.float().abs().max().item()
            cos = _cosine(a, r)
            parts.append(f"{oname} max|Δ|/max|ref| {rel:.3e} cos {cos:.6f}")
            if not (rel <= BWD_REL_TOL and cos >= BWD_COS_MIN):
                raise AssertionError(f"flash_bwd {name} {oname} disagrees with its plain twin")
            worst = max(worst, diff)
        log(f"flash_bwd {name}: " + "; ".join(parts) +
            f" (bounds {BWD_REL_TOL}, cos {BWD_COS_MIN})")
        if timing is None:
            ms = time_ms(lambda: flash.flash_attention_bwd(*args, **kw), 10)
            plain_ms = time_ms(lambda: flash.flash_attention_bwd_plain(*args, **kw), 3)
            # yardstick: SDPA's backward (dq, dk and dv together) with the
            # same per-key bias, causal
            pos = torch.arange(S, device="cuda")
            mask = torch.where(pos[None] <= pos[:, None], bias, BIG_NEG).to(BF16)
            qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
            o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=h_kv != h)
            gt = g.transpose(1, 2)
            lib_ms = time_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), gt, retain_graph=True), 10)
            pairs = attn_pairs(valid, S, 0)
            # q, g, k, v read and dq, dk, dv written in bf16; lse, delta and
            # the bias read; dq's fp32 sum zeroed and read once. Five
            # products of 2·d flops a (query, key) pair and head
            n_bytes = (2 * q.numel() + 2 * k.numel()) * 2 * 2 + 2 * b * h * S * 4 + b * S * 4
            n_bytes += q.numel() * 4 * 2
            bnd = bound_ms(n_bytes, 10 * d * h * pairs, H100_BF16_PEAK)
            log(f"flash_bwd {name}: kernel {ms:.3f} ms ({100 * bnd[0] / ms:.1f}% of the bound), "
                f"plain backward {plain_ms:.3f} ms, SDPA backward {lib_ms:.3f} ms, bound "
                f"{bnd[0]:.3f} ms ({bnd[1]}; {10 * d * h * pairs / 1e12:.2f} TFLOP, "
                f"{n_bytes / 1e9:.3f} GB) [{card()}]")
            timing = ms, plain_ms, lib_ms, *bnd
            del mask, qt, kt, vt, o
        del q, k, v, g, out, got, want, args, bias
        torch.cuda.empty_cache()
    return worst, *timing


def _int_mm_scaled(x_q, x_s, w, w_s):
    """K6's function by one PyTorch call (the yardstick): torch._int_mm,
    which refuses m <= 16, on x_q padded to 32 rows, then the scales."""
    m = x_q.shape[0]
    if m <= 16:
        x_q = F.pad(x_q, (0, 0, 0, 32 - m))
    acc = torch._int_mm(x_q, w.t())[:m]
    return (acc.float() * x_s * w_s).to(BF16)


def phase_k56(gen):
    """K5 int8_matmul and K6 w8a8_matmul at the int8 serving shapes against
    their twins: K5 to QUANT_REL_TOL, K6 bit for bit. Times every shape
    but the edges, weights cycled through copies so a decode stream comes
    from HBM. Returns ({"int8_matmul": row, "w8a8_matmul": row}, named):
    each row (max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by)
    with the times at QUANT_REPORT, `named` each kernel's {shape: ms,
    library_ms and bound_ms} at its QUANT_NAMED_REPORTS."""
    worst = {"int8_matmul": 0.0, "w8a8_matmul": 0.0}
    report, named = {}, {k: {} for k in worst}
    for name, m, d, f in QUANT_SHAPES:
        x = _randn((m, d), gen)
        w, s = quant.quantize_weight(torch.randn((f, d), generator=gen, device="cuda") * 0.02)
        x_q, x_s = quant.quantize_activations(x)
        got5, want5 = quant.int8_matmul(x, w, s), quant.int8_matmul_plain(x, w, s)
        got6 = quant.w8a8_matmul_quantized(x_q, x_s, w, s, out_dtype=BF16)
        want6 = quant.w8a8_matmul_plain(x_q, x_s, w, s, out_dtype=BF16)
        torch.cuda.synchronize()
        err5 = (got5.float() - want5.float()).abs().max().item()
        rel5 = err5 / want5.float().abs().max().item()
        err6 = (got6.float() - want6.float()).abs().max().item()
        log(f"K5 {name}: max|Δ|/max|ref| {rel5:.3e} (tol {QUANT_REL_TOL}); "
            f"K6 max|Δ| {err6:.3e} (bit-identical wanted)")
        if not rel5 <= QUANT_REL_TOL:
            raise AssertionError(f"K5 {name} disagrees with its plain twin")
        if not torch.equal(got6, want6):
            raise AssertionError(f"K6 {name} is not bit-identical to its plain twin")
        worst["int8_matmul"] = max(worst["int8_matmul"], err5)
        worst["w8a8_matmul"] = max(worst["w8a8_matmul"], err6)
        del got5, want5, got6, want6
        if name.startswith("edge"):
            continue

        n = max(1, math.ceil(L2_FLUSH_BYTES / w.numel()))
        ws = [(w.clone(), s.clone()) for _ in range(n - 1)] + [(w, s)]
        w16 = [(wc.float() * sc[:, None]).to(BF16) for wc, sc in ws]   # the bf16 product
        # CUDA-graph replays, so a 20-60 us kernel is not timed at the host's
        # launch rate; eager launches printed beside
        k5_call = lambda w, s: quant.int8_matmul(x, w, s)                       # noqa: E731
        k6_call = lambda w, s: quant.w8a8_matmul_quantized(x_q, x_s, w, s, out_dtype=BF16)  # noqa: E731
        k5 = dict(
            ms=time_ms(k5_call, 20, ws, graph=True),
            plain_ms=time_ms(lambda w, s: quant.int8_matmul_plain(x, w, s), 3, ws),
            library_ms=time_ms(lambda w: F.linear(x, w), 20, [(t,) for t in w16], graph=True),
        )
        deq_ms = time_ms(lambda w, s: quant.int8_matmul_dequant(x, w, s), 20, ws, graph=True)
        k6 = dict(
            ms=time_ms(k6_call, 20, ws, graph=True),
            plain_ms=time_ms(lambda w, s: quant.w8a8_matmul_plain(x_q, x_s, w, s, out_dtype=BF16),
                             3, ws),
            library_ms=time_ms(lambda w, s: _int_mm_scaled(x_q, x_s, w, s), 20, ws, graph=True),
        )
        eager = (f"eager launches: K5 {time_ms(k5_call, 20, ws):.4f} ms, K6 "
                 f"{time_ms(k6_call, 20, ws):.4f} ms")
        out_b, w_b = m * f * 2, f * d + f * 4
        k5["bound_ms"], k5["bound_by"] = bound_ms(m * d * 2 + w_b + out_b, 2 * m * d * f,
                                                  H100_BF16_PEAK)
        k6["bound_ms"], k6["bound_by"] = bound_ms(m * d + m * 4 + w_b + out_b, 2 * m * d * f,
                                                  H100_INT8_PEAK)
        log(f"K5 {name}: kernel {k5['ms']:.4f} ms, plain {k5['plain_ms']:.4f} ms, F.linear bf16 "
            f"{k5['library_ms']:.4f} ms, int8_matmul_dequant {deq_ms:.4f} ms, bound "
            f"{k5['bound_ms']:.4f} ms ({k5['bound_by']}) [{card()}]")
        log(f"K6 {name}: kernel {k6['ms']:.4f} ms, plain {k6['plain_ms']:.4f} ms, _int_mm + scales "
            f"{k6['library_ms']:.4f} ms, bound {k6['bound_ms']:.4f} ms ({k6['bound_by']}) "
            f"({n} weight copies cycled; CUDA-graph replay; {eager})")
        if name == QUANT_REPORT:
            report = {"int8_matmul": k5, "w8a8_matmul": k6}
        for kernel, row in (("int8_matmul", k5), ("w8a8_matmul", k6)):
            if name in QUANT_NAMED_REPORTS[kernel]:
                named[kernel][name] = {k: row[k] for k in ("ms", "library_ms", "bound_ms")}
        del x, x_q, x_s, w, s, ws, w16
        torch.cuda.empty_cache()
    return {k: dict(max_abs_err=worst[k], **report[k]) for k in worst}, named


def serving_config():
    """scripts/run_serve.sh: 7b, theta 5e7, no scan; the CLI sets per_row
    and max_sequence_length = max(preset, cache_len)."""
    cfg = LLaMAConfig.load_config("7b")
    return cfg.replace(
        scan_attention=False, scan_mlp=False, theta=50_000_000,
        decode_index="per_row", max_sequence_length=max(cfg.max_sequence_length, 4096),
    )


BUCKETS = (256, 1024, 2048)
PROMPT_LENS = [50, 1900, 700, 130, 2000, 999, 256, 1500, 64, 1200, 400, 1800]
CHECKED_PROMPTS = (0, 2, 4)   # lengths 50, 700, 2000: one per bucket


def serving_requests(cfg):
    """The 12 requests of the serving mix: prompt lengths 50-2000 over the
    three buckets, budgets 64-80, two sampled rows."""
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(2, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]
    budgets = [64 + (i % 3) * 8 for i in range(12)]
    temps = [0.0] * 12
    temps[3], temps[8] = 0.8, 1.0
    return prompts, budgets, temps


def serving_model(cfg):
    """The 7b model in bf16 on the card with random weights from SEED."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = LLaMAForCausalLM(cfg, dtype=BF16, device="cuda")
    model.init_weights(gen)
    return model


def expected_launches(cfg, admitted, rounds):
    """Kernel launches of a serving run: one forward per admission and per
    decode round; per forward K1 (admission) or K4 (decode) once a layer,
    and one dense product per wq wk wv wo w1 w2 w3 of each layer plus
    lm_head: all K5 under "int8", all but lm_head K6 under "int8_w8a8".
    An admission's products (m = its bucket) take K5's and K6's GEMMs, a
    decode round's (m = 8 slots) their GEMVs."""
    L, forwards = cfg.num_hidden_layers, admitted + rounds
    body, head = 7 * L, 0 if cfg.tie_word_embeddings else 1
    k5 = {"int8": body + head, "int8_w8a8": head}.get(cfg.quant_dense, 0)
    k6 = body if cfg.quant_dense == "int8_w8a8" else 0
    return dict(flash_fwd=L * admitted, flash_bwd=0,
                flash_decode=L * rounds, int8_matmul=k5 * forwards, w8a8_matmul=k6 * forwards,
                int8_matmul_gemm=k5 * admitted, w8a8_matmul_gemm=k6 * admitted)


def serve(model, name, n_requests=12):
    """The first `n_requests` of the mix through InflightServer (8 slots,
    cache 4096, run_serve.sh's buckets), launch counts set to 0 just before
    the run and read just after. Before it, one untimed warm-up admission at
    each bucket, so that no arm pays the first use of a kernel in its timed
    run (cuBLAS loads and picks its kernels at the first product of a
    shape). Checks every request and the exact launch counts; returns
    (launches, summary)."""
    cfg = model.config
    warm = serving_requests(cfg)[0]
    with torch.no_grad():
        for i in CHECKED_PROMPTS:   # one prompt in each bucket
            bucket = next(b for b in BUCKETS if b >= len(warm[i]))
            prefill_logits(model, model.init_cache(1, 4096), warm[i], bucket)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    srv = InflightServer(model, slots=8, cache_len=4096, prompt_buckets=BUCKETS,
                         stop_tokens=(cfg.eos_token_id,), seed=SEED)
    prompts, budgets, temps = (r[:n_requests] for r in serving_requests(cfg))
    rids = [srv.submit(p, n, t) for p, n, t in zip(prompts, budgets, temps)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = time.perf_counter()
    done = {f.req_id: f for f in srv.run()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    log(f"serve {name}: {srv.stats_line()}; wall {wall:.2f}s; launches {launches}")

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
    s = srv.stats
    want = expected_launches(cfg, s["admitted"], s["rounds"])
    if launches != want:
        raise AssertionError(f"serve {name}: launches {launches}, want {want}")
    decode_tokens = s["emitted"] - s["admitted"]
    summary = dict(
        prefill_s=s["prefill_s"], decode_s=s["decode_s"], rounds=s["rounds"],
        decode_tokens=decode_tokens, decode_tok_s=decode_tokens / s["decode_s"],
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    log(f"serve {name}: prefill {s['prefill_s']:.3f}s over {s['admitted']} admissions, decode "
        f"{s['decode_s']:.3f}s for {decode_tokens} tokens in {s['rounds']} rounds = "
        f"{summary['decode_tok_s']:.1f} tok/s; peak {summary['peak_gib']:.1f} GiB "
        f"[{card()}]")
    return launches, summary


def admission_logits(models, cfg):
    """{name: fp32 last-token logits of CHECKED_PROMPTS} for each model,
    each prompt prefilled into a fresh batch-1 cache of that model."""
    prompts = serving_requests(cfg)[0]
    out = {}
    for name, m in models.items():
        out[name] = []
        for i in CHECKED_PROMPTS:
            bucket = next(b for b in BUCKETS if b >= len(prompts[i]))
            out[name].append(prefill_logits(m, m.init_cache(1, 4096), prompts[i], bucket))
    return out


def _cos(a, b):
    return F.cosine_similarity(a, b, dim=0).item()


def hold_to_noise_floor(logits, kernel, arm, truth, cos_min=COS_MIN, argmax_of_truth=False):
    """The serving noise-floor rule, per checked prompt: the `kernel` path agrees
    with the `arm` path (the same tensors another way) at cosine >= cos_min
    and on argmax (or, with `argmax_of_truth`, on the fp32 `truth`'s argmax
    where the arm misses it), and is at most FLOOR_RATIO x as far from
    `truth` (1 - cosine) as `arm` is. Every prompt is logged before any is
    held."""
    lens = [PROMPT_LENS[i] for i in CHECKED_PROMPTS]
    failed = []
    for n, got, want, ref in zip(lens, logits[kernel], logits[arm], logits[truth]):
        c_ka, c_kt, c_at = _cos(got, want), _cos(got, ref), _cos(want, ref)
        log(f"admission logits, prompt {n}: {kernel} vs {arm} max|diff| "
            f"{(got - want).abs().max().item():.4f} cosine {c_ka:.6f} (min {cos_min}); cosine "
            f"to {truth}: {kernel} {c_kt:.6f} {arm} {c_at:.6f}; argmax {kernel}/{arm}/{truth} "
            f"{int(got.argmax())}/{int(want.argmax())}/{int(ref.argmax())}")
        picks = {int(want.argmax())} | ({int(ref.argmax())} if argmax_of_truth else set())
        if int(got.argmax()) not in picks:
            failed.append(f"prompt {n}: {kernel} and {arm} pick different admission tokens")
        if not (c_ka >= cos_min and 1 - c_kt <= FLOOR_RATIO * (1 - c_at)):
            failed.append(f"prompt {n}: {kernel} admission logits are off the bf16 noise floor")
    if failed:
        raise AssertionError("; ".join(failed))


def phase_serve():
    """bf16 serving of the 12 requests; kernel-path admission logits held
    to the noise floor against attn_impl="plain". Returns (launches,
    summary)."""
    cfg = serving_config()
    t0 = time.perf_counter()
    model = serving_model(cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"serve: 7b model ({n_params / 1e9:.2f}B params, bf16, random seed {SEED}) "
        f"built in {time.perf_counter() - t0:.1f}s")
    launches, summary = serve(model, "bf16")
    torch.cuda.empty_cache()

    # The same weight tensors through the plain attention path, and an fp32
    # upcast copy through it as the reference both bf16 paths are held to:
    # at 32 random layers bf16 rounding alone moves the logits' cosine to
    # the fp32 result to ~0.998, so the kernel path must be as close to the
    # fp32 result as the plain bf16 path is, and agree with it on argmax.
    plain = LLaMAForCausalLM(cfg.replace(attn_impl="plain"), dtype=BF16, device="meta")
    plain.load_state_dict(model.state_dict(), assign=True)
    ref32 = LLaMAForCausalLM(cfg.replace(attn_impl="plain"), dtype=torch.float32, device="meta")
    ref32.load_state_dict({k: v.float() for k, v in model.state_dict().items()}, assign=True)
    logits = admission_logits({"kernel": model, "plain": plain, "fp32": ref32}, cfg)
    hold_to_noise_floor(logits, "kernel", "plain", "fp32")
    return launches, summary


def quantized_state(cfg):
    """The serving model's weights (random from SEED) quantized on the card
    by the port's quantize_params_int8, the bf16 model freed: the
    run_serve.sh QUANTIZE=1 bundle."""
    model = serving_model(cfg)
    t0 = time.perf_counter()
    sd = quant.quantize_params_int8(model.state_dict())
    del model
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    n_q = sum(v.numel() for v in sd.values() if v.dtype == torch.int8)
    log(f"serve int8: {n_q:,} weights quantized on the card in {time.perf_counter() - t0:.2f}s "
        f"({n_q / 1e9:.2f} GB int8 vs {2 * n_q / 1e9:.2f} GB bf16)")
    return sd


def quantized_model(cfg, sd, quant_dense, **kw):
    """A model on the quantized state dict `sd` (its tensors, not copies)."""
    m = LLaMAForCausalLM(cfg.replace(quant_dense=quant_dense, **kw), dtype=BF16, device="meta")
    m.load_state_dict(sd, assign=True)
    return m


def phase_serve_w8a8(gen=None):
    """W8A8 serving alone, as phase_serve_int8 serves it (the first 4
    requests, int8_w8a8 with an int8 cache): for two checkouts' decode tok/s
    in turns (scripts/compare_phase.sh DIR serve_w8a8). Returns the summary."""
    cfg = serving_config()
    w8a8 = quantized_model(cfg, quantized_state(cfg), "int8_w8a8", kv_cache_dtype="int8")
    return serve(w8a8, "int8_w8a8 (int8 cache)", n_requests=4)[1]


def phase_serve_int8(bf16):
    """The bf16 phase's weights quantized on the card by the port's
    quantize_params_int8 (the bf16 model freed), then served: all 12
    requests with quant_dense="int8" (K5), the first 4 with "int8_w8a8" and
    an int8 cache (K6, K5 for lm_head). Admission logits: K5 held to the
    noise floor against the "int8_xla" dequant arm on the same int8 tensors,
    W8A8 to W8A8_COS_MIN, both against an fp32 copy of the dequantized
    weights. `bf16`: the bf16 run's summary, logged beside. Returns
    (int8 launches, w8a8 launches)."""
    cfg = serving_config()
    sd = quantized_state(cfg)

    def build(quant_dense, **kw):
        return quantized_model(cfg, sd, quant_dense, **kw)

    int8, w8a8, xla = build("int8"), build("int8_w8a8", kv_cache_dtype="int8"), build("int8_xla")
    launches, summary = serve(int8, "int8")
    torch.cuda.empty_cache()
    for key, unit in (("prefill_s", "s"), ("decode_tok_s", " tok/s"), ("peak_gib", " GiB")):
        log(f"serve int8 vs bf16: {key} {summary[key]:.3f}{unit} vs {bf16[key]:.3f}{unit}")
    w_launches, _ = serve(w8a8, "int8_w8a8 (int8 cache)", n_requests=4)
    torch.cuda.empty_cache()

    deq = {}
    for k, v in sd.items():
        if v.dtype == torch.int8:
            deq[k] = v.float() * sd[k[: -len("weight")] + "scale"][:, None]
        elif not k.endswith(".scale"):
            deq[k] = v.float()
    ref32 = LLaMAForCausalLM(cfg.replace(attn_impl="plain"), dtype=torch.float32, device="meta")
    ref32.load_state_dict(deq, assign=True)
    logits = admission_logits({"int8": int8, "int8_xla": xla, "int8_w8a8": w8a8,
                               "fp32_dequant": ref32}, cfg)
    w8a8_cos = [_cos(got, ref) for got, ref in zip(logits["int8_w8a8"], logits["fp32_dequant"])]
    for i, got, ref, c in zip(CHECKED_PROMPTS, logits["int8_w8a8"], logits["fp32_dequant"],
                              w8a8_cos):
        log(f"admission logits, prompt {PROMPT_LENS[i]}: int8_w8a8 (int8 cache) cosine to "
            f"fp32_dequant {c:.6f} (min {W8A8_COS_MIN}), argmax "
            f"{int(got.argmax())}/{int(ref.argmax())}")
    hold_to_noise_floor(logits, "int8", "int8_xla", "fp32_dequant", INT8_ARM_COS_MIN,
                        argmax_of_truth=True)
    if not min(w8a8_cos) >= W8A8_COS_MIN:
        raise AssertionError("int8_w8a8 admission logits are too far from the fp32 result")
    return launches, w_launches


def _lm_batch(b, s, vocab, seed):
    """A fixed next-token batch from the seed: targets are the inputs shifted."""
    toks = np.random.default_rng(seed).integers(2, vocab, (b, s + 1))
    return dict(
        input_tokens=torch.from_numpy(toks[:, :-1]).cuda(),
        target_tokens=torch.from_numpy(toks[:, 1:]).cuda(),
        loss_masks=torch.ones((b, s), device="cuda"),
    )


KERNEL_WRAPPERS = {   # kernel name → the wrapper that counts its launches
    "flash_fwd": flash.flash_attention_fwd,
    "flash_bwd": flash.flash_attention_bwd,
    "flash_decode": decode.flash_decode,
    "int8_matmul": quant.int8_matmul,
    "w8a8_matmul": quant.w8a8_matmul_quantized,
}


GEMM_WRAPPERS = ("int8_matmul", "w8a8_matmul")   # their admission GEMMs are counted apart


def _launch_counts():
    """Each wrapper's launches, and K5's and K6's admission-GEMM launches
    apart (as `<name>_gemm`)."""
    counts = {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}
    for name in GEMM_WRAPPERS:
        counts[name + "_gemm"] = KERNEL_WRAPPERS[name].gemm_launches
    return counts


def _reset_launch_counts():
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
    for name in GEMM_WRAPPERS:
        KERNEL_WRAPPERS[name].gemm_launches = 0


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
    if min(n_k[k] for k in ("flash_fwd", "flash_bwd")) <= 0:
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
    for k in ("flash_fwd", "flash_bwd"):
        if launches[k] != layers * steps:
            raise AssertionError(f"{k} launched {launches[k]} times, want {layers * steps}")
    if profile:
        profile_step(state, batch, profile)
    return launches


def _kernel_kind(name):
    if "flash_fwd_kernel" in name:
        return "K1 flash_fwd"
    if "flash_bwd_kernel" in name:
        return "flash_bwd (dq, dk, dv)"
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
    *k1, k1_train = phase_k1(gen)
    *k4, k4_cases = phase_k4(gen)
    bwd = phase_bwd(gen)
    k56, k56_named = phase_k56(gen)
    torch.cuda.empty_cache()
    # each main path's counts, set to 0 just before its run and read just after
    path_launches = []
    launches, bf16_summary = phase_serve()
    path_launches.append(launches)
    torch.cuda.empty_cache()
    path_launches.extend(phase_serve_int8(bf16_summary))
    torch.cuda.empty_cache()
    phase_train_compare()
    path_launches.append(phase_train_full(profile))
    total = {k: sum(p[k] for p in path_launches) for k in KERNEL_WRAPPERS}

    def row(name, source, replaces, max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by):
        return dict(name=name, route="cuda", source="lwm_tpu_torch/csrc/" + source,
                    replaces=replaces, launches=total[name], max_abs_err=max_abs_err, ms=ms,
                    plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=library_ms)

    kernels = [
        dict(row("flash_fwd", "flash_fwd.cu", "lwm_tpu/ops/pallas_flash.py:199", *k1),
             **{K1_TRAIN_REPORT: k1_train}),
        row("flash_bwd", "flash_bwd.cu",
            "lwm_tpu/ops/pallas_flash.py:288 and lwm_tpu/ops/pallas_flash.py:356", *bwd),
        dict(row("flash_decode", "flash_decode.cu", "lwm_tpu/ops/pallas_decode.py:66", *k4),
             **k4_cases),
        dict(row("int8_matmul", "int8_matmul.cu", "lwm_tpu/ops/quant.py:107",
                 **k56["int8_matmul"]), **k56_named["int8_matmul"]),
        dict(row("w8a8_matmul", "w8a8_matmul.cu", "lwm_tpu/ops/quant.py:182",
                 **k56["w8a8_matmul"]), **k56_named["w8a8_matmul"]),
    ]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on a main path")
    log(card())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
