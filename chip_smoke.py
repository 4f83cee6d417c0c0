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
     admission over the 4096-slot cache, at the train step's attention
     (b 2, seq 4096, 32 heads, d 128) and at the shared prefix's two shapes
     (the build's last 2048-token chunk over 32768 keys; an admission's
     256 queries over the prefix block, not causal).
  4. K4 flash_decode vs its plain twin, output and (o, m, l) partials, at
     8 slots (bf16 and int8, MHA and GQA; a row with no valid key gives
     (0, BIG_NEG, 0)), at one slot of T 65536, and at the shared-prefix
     fold (all slots' query heads over one 32768-key prefix block: groups
     6, 8, 12, 16 and 32); every case timed.
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
     weight tensors and against an fp32 copy of them. On the same weights,
     the serving modes: a 32768-token shared prefix built in 2048-token
     chunks and 8 requests over it, those beyond 512 tokens admitted in
     chunks (exact K1/K4 counts for the build, the admissions and the
     rounds; admission and decode logits, and the server's own chunked
     admission, held to an arm with the kernels' plain twins in their
     place, to the plain concat oracle and to an fp32 copy);
     prompt-lookup verify (k 7; acceptance held on one layer with zero
     output projections, where it must occur; verify logits on the noise
     floor); chunked admission (512) of a 3000-token prompt (the logits of
     its first two tokens read off the server against one unchunked
     prefill).
  8. The same weights quantized on the card (`quantize_params_int8`, the
     run_serve.sh QUANTIZE=1 bundle): serve the 12 requests with
     quant_dense="int8" (K5 for every dense product) and 4 with
     "int8_w8a8" and an int8 cache (K6, K5 for lm_head); exact launch
     counts, K5's and K6's admission GEMMs counted apart; admission logits
     of K5 against the "int8_xla" dequant arm on the same int8 tensors,
     and of both (and W8A8) against an fp32 copy of the dequantized
     weights.
     Then the serving CLI (`python -m lwm_tpu_torch.apps.serve`) as a
     subprocess, three times over a 7b-width 4-layer params stream written
     by the port: a prefix document, its index saved then loaded (the same
     completions), lookup verify; and with --quantize_weights.
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

import contextlib
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from lwm_tpu_torch import checkpoint, train
from lwm_tpu_torch.models import llama as llama_module
from lwm_tpu_torch.models.llama import LLaMAConfig, LLaMAForCausalLM, quantize_kv
from lwm_tpu_torch.ops import _build, decode, flash, quant
from lwm_tpu_torch.ops import prefix as prefix_ops
from lwm_tpu_torch.ops.reference import BIG_NEG
from lwm_tpu_torch.serve import InflightServer, _lookup_proposal, prefill_logits

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
# d 64 at 8 kv heads; rows with no valid key (out 0, lse BIG_NEG). Two more
# are timed at the shapes the shared prefix (phase_serve_prefix) gives K1:
# the build's last chunk (2048 queries at offset 30720 over the 32768 keys
# written so far, head-major) and an admission over the prefix block (256
# queries, not causal, the prefix-validity bias with 68 padding keys); the
# 1024 bucket's admission over it is held too
K1_TRAIN_REPORT = "train_b2_S4096_h32_causal_padkeys"
K1_TIMED = ("bucket2048_T4096_perkey", K1_TRAIN_REPORT, "prefix_build_q2048_qoff30720_T32768",
            "prefix_admit_q256_T32768_noncausal")
K1_CASES = [
    ("bucket2048_T4096_perkey", 1, 32, 128, 2048, 4096, True, 0, 0, True, "prompt"),
    (K1_TRAIN_REPORT, 2, 32, 128, 4096, 4096, True, 0, 0, False, "per_key"),
    ("prefix_build_q2048_qoff30720_T32768", 1, 32, 128, 2048, 32768, True, 30720, 0, True,
     "written"),
    ("prefix_admit_q256_T32768_noncausal", 1, 32, 128, 256, 32768, False, 0, 0, True, "prefix"),
    ("prefix_admit_q1024_T32768_noncausal", 1, 32, 128, 1024, 32768, False, 0, 0, True, "prefix"),
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
    per-key bias, the prompt's keys valid; "written": a prefix build
    chunk's, the keys written through its last query; "prefix": the
    prefix-validity bias, all but the last 68 keys; "per_key" and "full": the
    backward's (_bwd_bias); "frontier": per-row frontiers with 20% random
    holes over a full tile, and "no_keys" the same with K1_EMPTY_ROWS
    masked whole."""
    keys = torch.arange(T, device="cuda")
    if kind in ("prompt", "written", "prefix"):
        valid = keys < {"prompt": sq - 37, "written": q_off + sq, "prefix": T - 68}[kind]
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
    seen = torch.arange(T, device="cuda")[None] <= pos[:, None]
    if not kw["causal"]:
        seen = torch.ones_like(seen)
    mask = torch.where(seen, bias, BIG_NEG).to(BF16)
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
    pairs = attn_pairs(valid, sq, kw["q_offset"] if kw["causal"] else valid.shape[-1])
    n_bytes = 2 * q.numel() * 2 + 2 * int(valid.sum()) * h_kv * d * 2 + b * h * sq * 4
    n_bytes += bias.numel() * 4
    return bound_ms(n_bytes, 4 * d * h * pairs, H100_BF16_PEAK)


def phase_k1(gen):
    """K1 against its plain twin at K1_CASES. Returns (max_abs_err, ms,
    plain_ms, library_ms, bound_ms, bound_by) with the times at the
    admission case, and {name: the same times as a dict} at the other
    K1_TIMED cases."""
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
            {name: timed[name] for name in K1_TIMED[1:]})


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
# K4 over a shared prefix (ops/prefix.py): every slot's query heads folded
# into one batch-1 call over the prefix block, so the group is slots x g.
# name, b, h_kv, T, int8 cache, folded query heads, valid prefix keys. The
# 7b fold of 8 slots (group 8) over a 32768-token prefix in bf16 and int8;
# 16 slots (group 16); 8 slots over a GQA cache of 8 kv heads (group 32);
# and 6 and 12 slots (groups 6 and 12: a ragged last chunk of 8 heads) over
# a prefix whose last 68 stored keys are padding
K4_FOLD_CASES = [
    ("fold_g8_bf16_P32768", 1, 32, 32768, False, 256, 32768),
    ("fold_g8_int8_P32768", 1, 32, 32768, True, 256, 32768),
    ("fold_g16_bf16_P32768", 1, 32, 32768, False, 512, 32768),
    ("fold_g32_bf16_hkv8_P32768", 1, 8, 32768, False, 256, 32768),
    ("fold_g6_bf16_P32700", 1, 32, 32768, False, 192, 32700),
    ("fold_g12_bf16_P32700", 1, 32, 32768, False, 384, 32700),
    ("fold_g12_int8_P32700", 1, 32, 32768, True, 384, 32700),
]


def k4_inputs(case, gen):
    """(q, k, v, mask, kv_len, k_scale, v_scale) of one K4 case (K4_CASES,
    32 query heads, or K4_FOLD_CASES)."""
    name, b, h_kv, T, int8, *fold = case
    h, d = (fold[0] if fold else 32), 128
    if fold:
        mask = (torch.arange(T, device="cuda") < fold[1])[None]
        kv_len = fold[1]
    elif b == 1:
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
    """K4 at K4_CASES and K4_FOLD_CASES against its plain twin (output and
    partials), with a row of no valid key at the 8-slot cases, each case
    timed. Returns (max_abs_err, ms, plain_ms, library_ms, bound_ms,
    bound_by) at the first case, and {name: dict(ms, plain_ms, library_ms,
    bound_ms, bound_by)} for the others."""
    worst, first, others = 0.0, None, {}
    for case in K4_CASES + K4_FOLD_CASES:
        name, b, h_kv, T, int8 = case[:5]
        args = k4_inputs(case, gen)
        q, k, v, mask, kv_len, ks, vs = args
        h = q.shape[2]
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
                q.transpose(1, 2), k, v, attn_mask=seen, enable_gqa=h_kv != h), 50, sets,
                graph=True)
            lib = f"SDPA {lib_ms:.4f} ms (graph)"
            del seen
        eager = ""
        if first is None:
            eager_ms = time_ms(lambda *a: decode.flash_decode(*a), 50, sets)
            eager = f"; eager launches {eager_ms:.4f}"
        log(f"K4 {name}: kernel {ms:.4f} ms (graph{eager}; {100 * bnd / ms:.1f}% of the bound), "
            f"plain {plain_ms:.3f} ms, {lib}, bound {bnd:.4f} ms ({by}) (b={b} h={h} "
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


def fp32_weights(model):
    """An fp32 upcast of the model's state dict (the noise floor's truth)."""
    return {k: v.float() for k, v in model.state_dict().items()}


def plain_arms(model):
    """The noise floor's arms on `model`'s weights: "plain", the same
    tensors through attn_impl="plain", and "fp32", an fp32 upcast copy
    through it, the truth both bf16 paths are held to."""
    cfg = model.config.replace(attn_impl="plain")
    return {"plain": LLaMAForCausalLM.on_tensors(cfg, model.state_dict(), model.dtype),
            "fp32": LLaMAForCausalLM.on_tensors(cfg, fp32_weights(model), torch.float32)}


def _cos(a, b):
    return F.cosine_similarity(a, b, dim=0).item()


def hold_to_noise_floor(logits, kernel, arm, truth, cos_min=COS_MIN, argmax_of_truth=False,
                        labels=None, what="admission", floor_ratio=FLOOR_RATIO):
    """The serving noise-floor rule, per checked prompt: the `kernel` path agrees
    with the `arm` path (the same tensors another way) at cosine >= cos_min
    and on argmax (or, with `argmax_of_truth`, on the fp32 `truth`'s argmax
    where the arm misses it), and is at most `floor_ratio` x as far from
    `truth` (1 - cosine) as `arm` is; with floor_ratio None that ratio is
    logged, not held. `labels` name the rows (default: the
    CHECKED_PROMPTS' lengths). Every row is logged before any is held."""
    lens = labels or [PROMPT_LENS[i] for i in CHECKED_PROMPTS]
    failed = []
    for n, got, want, ref in zip(lens, logits[kernel], logits[arm], logits[truth]):
        c_ka, c_kt, c_at = _cos(got, want), _cos(got, ref), _cos(want, ref)
        ratio = (1 - c_kt) / (1 - c_at) if c_at < 1 else math.inf
        log(f"{what} logits, prompt {n}: {kernel} vs {arm} max|diff| "
            f"{(got - want).abs().max().item():.4f} cosine {c_ka:.6f} (min {cos_min}); cosine "
            f"to {truth}: {kernel} {c_kt:.6f} {arm} {c_at:.6f}, distance ratio {ratio:.3f} "
            f"(max {floor_ratio}); argmax {kernel}/{arm}/{truth} "
            f"{int(got.argmax())}/{int(want.argmax())}/{int(ref.argmax())}")
        picks = {int(want.argmax())} | ({int(ref.argmax())} if argmax_of_truth else set())
        if int(got.argmax()) not in picks:
            failed.append(f"prompt {n}: {kernel} and {arm} pick different {what} tokens")
        if c_ka < cos_min:
            failed.append(f"prompt {n}: {kernel} {what} logits disagree with {arm}")
        if floor_ratio is not None and not 1 - c_kt <= floor_ratio * (1 - c_at):
            failed.append(f"prompt {n}: {kernel} {what} logits are off the bf16 noise floor")
    if failed:
        raise AssertionError("; ".join(failed))


def phase_serve():
    """bf16 serving of the 12 requests; kernel-path admission logits held
    to the noise floor against attn_impl="plain". Returns (launches,
    summary, the model), the model's weights reused by the serving modes'
    phases."""
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
    logits = admission_logits({"kernel": model, **plain_arms(model)}, cfg)
    hold_to_noise_floor(logits, "kernel", "plain", "fp32")
    return launches, summary, model


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
    return LLaMAForCausalLM.on_tensors(cfg.replace(quant_dense=quant_dense, **kw), sd, BF16)


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
    ref32 = LLaMAForCausalLM.on_tensors(cfg.replace(attn_impl="plain"), deq, torch.float32)
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


# ------------------------------------------------------- the serving modes
# Shared prefix (phase_serve_prefix): a PREFIX_TOKENS document from the seed,
# built in PREFIX_CHUNK-token chunks, 8 requests of PREFIX_SUFFIX_LENS suffix
# tokens and 64 new ones (one sampled), those longer than ADMIT_CHUNK
# admitted in chunks. Its logits check prefills the first 256 tokens of each
# suffix into an 8-slot pool of CHECK_CACHE positions over the same prefix
# block and runs one decode round, and reads the server's own chunked
# admission of the last suffix (600 tokens, two chunks).
PREFIX_TOKENS, PREFIX_CHUNK = 32768, 2048
PREFIX_SUFFIX_LENS = [50, 1000, 300, 700, 128, 900, 450, 600]
CHECK_CACHE = 512
# Lookup verify (LOOKUP_K proposals a slot) on quoting prompts: a random
# 48-token span inside filler and its first 16 tokens again at the end.
# Chunked admission: ADMIT_CHUNK-token chunks, one CHUNKED_LEN-token prompt
# (beyond the largest bucket) beside prompts that take a bucket or chunks.
LOOKUP_K, ADMIT_CHUNK, CHUNKED_LEN = 7, 512, 3000
QUOTE_FILLER = [100, 900, 300, 600, 150, 450, 800, 200]
CHUNKED_LENS = [CHUNKED_LEN, 300, 700, 1500]


def admission_forwards(lengths):
    """Admission forwards of prompts of `lengths` under ADMIT_CHUNK: one a
    chunk, or one bucketed prefill."""
    return sum(-(-n // ADMIT_CHUNK) if n > ADMIT_CHUNK else 1 for n in lengths)


@contextlib.contextmanager
def attention_twins():
    """The kernel path's structure with K1 and K4 replaced by their plain
    twins where the model calls them. Over a shared prefix the two ranges
    still run apart, each output rounded to bf16 and merged by lse, as the
    kernel path (and the JAX one, lwm_tpu/ops/prefix.py) merges them, where
    the concat oracle rounds once: this arm sets the noise floor the
    kernels are held to there, and its distance beside the oracle's is the
    merge's own rounding."""
    saved = llama_module.flash_attention_fwd, llama_module.flash_decode, prefix_ops.flash_decode
    llama_module.flash_attention_fwd = flash.flash_attention_fwd_plain
    llama_module.flash_decode = prefix_ops.flash_decode = decode.flash_decode_plain
    try:
        yield
    finally:
        llama_module.flash_attention_fwd, llama_module.flash_decode, prefix_ops.flash_decode = saved


def hold_over_prefix(logits, kernel, labels, what):
    """The noise-floor rule over a shared prefix: `kernel` held to the
    "split" arm (attention_twins) at FLOOR_RATIO against "fp32", and both
    held to agree with the "plain" concat oracle, their distances to fp32
    beside the oracle's logged."""
    hold_to_noise_floor(logits, kernel, "split", "fp32", labels=labels, argmax_of_truth=True,
                        what=what)
    for name in (kernel, "split"):
        hold_to_noise_floor(logits, name, "plain", "fp32", labels=labels, argmax_of_truth=True,
                            what=f"{what} (concat oracle)", floor_ratio=None)


def serve_modes_run(srv, prompts, budgets, temps, name, want_launches):
    """Submit, run with the counts set to 0 just before and read just after,
    check every request and the exact launch counts (`want_launches(stats)`).
    Returns (launches, summary)."""
    cfg = srv.model.config
    rids = [srv.submit(p, n, t) for p, n, t in zip(prompts, budgets, temps)]
    torch.cuda.synchronize()
    _reset_launch_counts()
    t0 = time.perf_counter()
    done = {f.req_id: f for f in srv.run()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    log(f"serve {name}: {srv.stats_line()}; wall {wall:.2f}s; launches {launches}")
    if sorted(done) != sorted(rids):
        raise AssertionError(f"{name}: served {sorted(done)}, submitted {sorted(rids)}")
    for rid, n in zip(rids, budgets):
        toks, stopped = done[rid].tokens, done[rid].stopped
        if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"{name}, request {rid}: token outside the vocab")
        if not ((len(toks) == n and stopped == "length")
                or (stopped == "eos" and toks[-1] == cfg.eos_token_id and len(toks) <= n)):
            raise AssertionError(f"{name}, request {rid}: {len(toks)} tokens, stopped {stopped}")
    want = want_launches(srv.stats)
    if launches != want:
        raise AssertionError(f"serve {name}: launches {launches}, want {want}")
    s = srv.stats
    decode_tokens = s["emitted"] - s["admitted"]
    return launches, dict(prefill_s=s["prefill_s"], decode_s=s["decode_s"], rounds=s["rounds"],
                          decode_tok_s=decode_tokens / s["decode_s"], wall=wall)


def server_logits(srv, prompt):
    """(the fp32 logits of a greedy request's first two tokens as the
    server picks them, its two tokens): `prompt` served alone on the idle
    `srv` through its own admission (a bucket, or chunks staged and copied
    into the pool slot) and its first decode round from that slot, read at
    `_pick`."""
    if srv.busy():
        raise AssertionError("server_logits needs an idle server")
    rows = []
    pick = srv._pick

    def capture(logits, tau):   # an idle pool admits into slot 0
        rows.append(logits[0].clone())
        return pick(logits, tau)

    srv._pick = capture
    try:
        srv.submit(prompt, 2)
        srv.run()
    finally:
        del srv._pick
    if len(rows) != 2:
        raise AssertionError(f"server_logits: {len(rows)} picks for 2 tokens")
    return rows, srv.finished[-1].tokens.tolist()


def unchunked_logits(m, prompt, tok, cache_len, block=None, pos0=0):
    """What `server_logits` reads, through `m` at once: the last-token fp32
    logits of one prefill of `prompt` (unpadded) into a fresh batch-1 cache
    of `cache_len` positions (over the prefix `block` at RoPE offset
    `pos0`), then those of one decode step of `tok`."""
    n, dev = len(prompt), m.wte.weight.device
    cache = m.init_cache(1, cache_len, prefix=block)
    first = prefill_logits(m, cache, prompt, n, pos0)
    cache.index = n
    mask = torch.arange(cache_len, device=dev)[None] <= n
    nxt = m(torch.tensor([[tok]], device=dev), mask, torch.tensor([[n + pos0]], device=dev),
            cache=cache)
    return [first, nxt[0, 0].float()]


def prefix_logits(models, block, p_true, prompts, tokens):
    """{name: admission logits of each prompt (bucket 256) into its slot of
    an 8-slot pool of CHECK_CACHE positions over the prefix `block`, then
    the logits of one decode round of `tokens`}."""
    out = {}
    for name, m in models.items():
        dev = m.wte.weight.device
        lengths = torch.tensor([len(p) for p in prompts], device=dev)
        cache = m.init_cache(len(prompts), CHECK_CACHE, prefix=block)
        adm = [prefill_logits(m, cache.slot(i), p, 256, p_true) for i, p in enumerate(prompts)]
        mask = torch.arange(CHECK_CACHE, device=dev)[None] <= lengths[:, None]
        cache.index = int(lengths.max())
        dec = m(torch.tensor(tokens, device=dev)[:, None], mask, (lengths + p_true)[:, None],
                cache=cache)[:, 0].float()
        out[name] = adm + list(dec)
        del cache
    return out


def phase_serve_prefix(model, bf16):
    """Shared-prefix serving on the bf16 phase's weights: the prefix built
    through the server (K1 once a layer a chunk), the 8 requests served
    with chunked admission (K1 twice a layer an admission forward, K4
    twice a layer a round), exact launch counts. Then admission and
    decode-round logits over the prefix, and the server's own chunked
    admission of one suffix (server_logits), held to the noise floor
    (hold_over_prefix) against the attention_twins arm, the
    attn_impl="plain" concat oracle and an fp32 copy of the weights (which
    reads the same bf16 prefix block: an fp32 rebuild of 32768 tokens
    would take 32 GiB more; K1 is held to its twin at the build's shape in
    phase_k1). `bf16`: the plain pool's summary, logged beside. Returns the
    launches of the build and of the serving run."""
    cfg = model.config
    L = cfg.num_hidden_layers
    rng = np.random.default_rng(SEED + 3)
    prefix = rng.integers(2, cfg.vocab_size, PREFIX_TOKENS).tolist()
    prompts = [rng.integers(2, cfg.vocab_size, n).tolist() for n in PREFIX_SUFFIX_LENS]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = time.perf_counter()
    srv = InflightServer(model, slots=8, cache_len=4096, prompt_buckets=BUCKETS,
                         stop_tokens=(cfg.eos_token_id,), seed=SEED, prefix_ids=prefix,
                         prefix_chunk=PREFIX_CHUNK, admit_chunk=ADMIT_CHUNK)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build = _launch_counts()
    n_chunks = -(-PREFIX_TOKENS // PREFIX_CHUNK)
    want = dict(expected_launches(cfg, 0, 0), flash_fwd=L * n_chunks)
    if build != want:
        raise AssertionError(f"prefix build: launches {build}, want {want}")
    log(f"prefix build: {PREFIX_TOKENS} tokens in {n_chunks} chunks of {PREFIX_CHUNK}, "
        f"{build_s:.3f}s (host clock, synced); launches {build} [{card()}]")
    forwards = admission_forwards(PREFIX_SUFFIX_LENS)

    def want_launches(s):   # K1 twice a layer an admission forward, K4 twice a layer a round
        return dict(expected_launches(cfg, 0, 0), flash_fwd=2 * L * forwards,
                    flash_decode=2 * L * s["rounds"])

    temps = [0.0] * 8
    temps[5] = 0.8
    launches, summary = serve_modes_run(srv, prompts, [64] * 8, temps, "prefix", want_launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"serve prefix: build {build_s:.3f}s; decode {summary['decode_tok_s']:.1f} tok/s over "
        f"{summary['rounds']} rounds vs the plain pool's {bf16['decode_tok_s']:.1f} (12 requests, "
        f"this call); prefill {summary['prefill_s']:.3f}s over 8 admissions ({forwards} "
        f"forwards, chunks of {ADMIT_CHUNK}); peak {peak:.1f} GiB [{card()}]")

    chunked_prompt = prompts[-1]
    served, served_tokens = server_logits(srv, chunked_prompt)
    kernel, block, p_true = srv.model, srv._prefix, srv._pos0
    srv.cache = None   # the pool; the prefix block stays for the check
    del srv
    torch.cuda.empty_cache()
    models = {"kernel": kernel, **plain_arms(kernel)}
    check = [p[:256] for p in prompts]
    adm = prefix_logits({"kernel": kernel}, block, p_true, check, [0] * 8)["kernel"][:8]
    tokens = [int(x.argmax()) for x in adm]
    logits = prefix_logits(models, block, p_true, check, tokens)
    cache_len = -(-(len(chunked_prompt) + 1) // 512) * 512
    chunked = {name: unchunked_logits(m, chunked_prompt, served_tokens[0], cache_len, block,
                                      p_true)
               for name, m in models.items() if name != "kernel"}
    with attention_twins():
        logits.update(prefix_logits({"split": kernel}, block, p_true, check, tokens))
        chunked["split"] = unchunked_logits(kernel, chunked_prompt, served_tokens[0], cache_len,
                                            block, p_true)
    chunked["server"] = served
    labels = [f"{len(p)} (prefix {p_true})" for p in check]
    for what, rows in (("prefix admission", slice(0, 8)), ("prefix decode", slice(8, 16))):
        hold_over_prefix({k: v[rows] for k, v in logits.items()}, "kernel", labels, what)
    hold_over_prefix(chunked, "server", [f"{len(chunked_prompt)} (prefix {p_true}), first token",
                                         "then one decode round"],
                     f"the server's chunked admission ({ADMIT_CHUNK}) over the prefix")
    del models, block, kernel
    torch.cuda.empty_cache()
    return [build, launches]


def lookup_acceptance(model):
    """Accepted proposals, held where they must occur. A random 7b model
    quotes nothing: its 64-token greedy rollouts are 64 distinct tokens
    and no span of a prompt recurs in them (measured on one H100). A
    one-layer view of the same tensors whose two output projections (wo,
    w2) are zero makes the next token a function of the current one
    (embedding, ln_f, lm_head), while its attention still runs K1 every
    verify round, so a prompt quoting the model's own rollout W (seed + W
    + filler + W[:16]) continues with W[16:] and every proposal after the
    first round is right: acceptance above 0, every row emits W[16:]
    exactly, and K1 launches once an admission and once a round."""
    cfg = model.config.replace(num_hidden_layers=1)
    sd = {k: v for k, v in model.state_dict().items()
          if not k.startswith("h.") or k.startswith("h.0.")}
    for k in ("h.0.attention.wo.weight", "h.0.feed_forward.w2.weight"):
        sd[k] = torch.zeros_like(sd[k])
    markov = LLaMAForCausalLM.on_tensors(cfg, sd, BF16)
    rng = np.random.default_rng(SEED + 6)
    seeds = [rng.integers(2, cfg.vocab_size, 16).tolist() for _ in range(8)]
    srv = InflightServer(markov, slots=8, cache_len=4096, prompt_buckets=BUCKETS, seed=SEED)
    rids = [srv.submit(p, 48) for p in seeds]
    done = {f.req_id: f.tokens.tolist() for f in srv.run()}
    rollouts = [done[r] for r in rids]
    quotes = [p + w + rng.integers(2, cfg.vocab_size, 50).tolist() + w[:16]
              for p, w in zip(seeds, rollouts)]
    srv = InflightServer(markov, slots=8, cache_len=4096, prompt_buckets=BUCKETS, seed=SEED,
                         lookup_k=LOOKUP_K)
    rids = [srv.submit(q, 32) for q in quotes]
    _reset_launch_counts()
    done = {f.req_id: f.tokens.tolist() for f in srv.run()}
    launches = _launch_counts()
    s = srv.stats
    want = dict(expected_launches(cfg, 0, 0), flash_fwd=s["admitted"] + s["rounds"])
    if launches != want:
        raise AssertionError(f"lookup acceptance: launches {launches}, want {want}")
    log(f"lookup acceptance (one 7b layer, output projections zero; self-quoting prompts): "
        f"{srv.stats_line()}; accepted {s['accepted']} over {s['spec_rows']} row rounds; "
        f"launches {launches}")
    if s["accepted"] <= 0:
        raise AssertionError("lookup verify accepted no proposal on self-quoting prompts")
    if [done[r] for r in rids] != [w[16:48] for w in rollouts]:
        raise AssertionError("lookup verify changed a greedy row's tokens")


def phase_serve_lookup_chunked(model):
    """Prompt-lookup verify and chunked admission on the bf16 phase's
    weights. Lookup (k LOOKUP_K, quoting prompts): every round one forward
    of 1 + k tokens a slot (K1 once a layer), acceptance logged (held above
    0 by `lookup_acceptance`), and one verify forward's logits held to the
    noise floor against the plain model and an fp32 copy. Chunked
    (ADMIT_CHUNK): a CHUNKED_LEN-token prompt and three others, every
    request finished, exact launches; then the CHUNKED_LEN prompt again
    through the same server, its first two tokens' logits read off the
    server's own path (server_logits: the staging cache, the copy into the
    pool slot, a decode round from it) and held to the noise floor against
    one unchunked prefill and decode step through the plain model and an
    fp32 copy. Returns the two runs' launches."""
    cfg = model.config
    L = cfg.num_hidden_layers
    rng = np.random.default_rng(SEED + 4)
    quotes = []
    for n in QUOTE_FILLER:
        span, fill = (rng.integers(2, cfg.vocab_size, k).tolist() for k in (48, n))
        quotes.append(fill[: n // 2] + span + fill[n // 2:] + span[:16])
    srv = InflightServer(model, slots=8, cache_len=4096, prompt_buckets=BUCKETS,
                         stop_tokens=(cfg.eos_token_id,), seed=SEED, lookup_k=LOOKUP_K)

    def lookup_launches(s):   # the admissions and every verify round on K1, no K4
        return dict(expected_launches(cfg, 0, 0), flash_fwd=L * (s["admitted"] + s["rounds"]))

    look, look_sum = serve_modes_run(srv, quotes, [64] * 8, [0.0] * 8, "lookup", lookup_launches)
    s = srv.stats
    log(f"serve lookup (k {LOOKUP_K}): accepted {s['accepted']} over {s['spec_rows']} row "
        f"rounds; decode {look_sum['decode_tok_s']:.1f} tok/s [{card()}]")
    del srv
    torch.cuda.empty_cache()
    lookup_acceptance(model)

    srv = InflightServer(model, slots=8, cache_len=4096, prompt_buckets=BUCKETS,
                         stop_tokens=(cfg.eos_token_id,), seed=SEED, admit_chunk=ADMIT_CHUNK)
    long_prompts = [rng.integers(2, cfg.vocab_size, n).tolist() for n in CHUNKED_LENS]
    forwards = admission_forwards(CHUNKED_LENS)

    def chunked_launches(s):   # a forward a chunk (or a bucket), K4 a round
        return dict(expected_launches(cfg, 0, 0), flash_fwd=L * forwards,
                    flash_decode=L * s["rounds"])

    chunked, chunk_sum = serve_modes_run(srv, long_prompts, [64] * 4, [0.0] * 4,
                                         f"admit_chunk {ADMIT_CHUNK}", chunked_launches)
    log(f"serve admit_chunk: {len(CHUNKED_LENS)} requests of {CHUNKED_LENS} tokens, "
        f"{forwards} admission forwards; decode {chunk_sum['decode_tok_s']:.1f} tok/s [{card()}]")
    served, served_tokens = server_logits(srv, long_prompts[0])
    del srv
    torch.cuda.empty_cache()

    arms = {"kernel": model, **plain_arms(model)}
    # one verify forward after a quoting prompt: the admission's token, then
    # the lookup's proposal, at per-row positions over a batch-1 cache
    prompt = quotes[0]
    n = len(prompt)
    first = int(prefill_logits(model, model.init_cache(1, 4096), prompt, 256).argmax())
    ctx = np.asarray(prompt + [first])
    prop = _lookup_proposal(ctx, LOOKUP_K, 3)
    block = [first] + (prop.tolist() if prop is not None else [first] * LOOKUP_K)
    verify = {}
    for name, m in arms.items():
        cache = m.init_cache(1, 4096)
        prefill_logits(m, cache, prompt, 256)
        cache.index = n
        mask = torch.arange(4096, device="cuda")[None] <= n + LOOKUP_K
        pos = (n + torch.arange(1 + LOOKUP_K, device="cuda"))[None]
        verify[name] = list(m(torch.tensor([block], device="cuda"), mask, pos, cache=cache)[0]
                            .float())
        del cache
    hold_to_noise_floor(verify, "kernel", "plain", "fp32", argmax_of_truth=True,
                        labels=[f"{n} + verify row {j}" for j in range(1 + LOOKUP_K)],
                        what="lookup verify")

    first = {name: unchunked_logits(arms[name], long_prompts[0], served_tokens[0], 4096)
             for name in ("plain", "fp32")}
    first["server"] = served
    hold_to_noise_floor(first, "server", "plain", "fp32", argmax_of_truth=True,
                        labels=[f"{CHUNKED_LEN}, first token", "then one decode round"],
                        what=f"the server's chunked admission ({ADMIT_CHUNK})")
    del arms
    torch.cuda.empty_cache()
    return [look, chunked]


# The CLI on the card: a 7b-width model of CLI_LAYERS layers from the seed,
# saved as a params stream by the port's writer, served by
# `python -m lwm_tpu_torch.apps.serve` with the vendored BPE tokenizer, a
# shared prefix document, a prefix index and lookup verify; run twice (the
# second loads the index) and once more with --quantize_weights.
CLI_PRESET, CLI_LAYERS, CLI_NEW = "7b", 4, 32
CLI_FLAGS = ()   # more flags for every CLI run (a rehearsal on the CPU adds --device=cpu)
CLI_WORDS = ("the grass is green and the sky is blue here we go there and back again "
             "special magic number city sun yellow river stone one two three").split()


def _cli_text(rng, n_words, quote=None):
    words = [CLI_WORDS[i] for i in rng.integers(0, len(CLI_WORDS), n_words)]
    digits = [str(x) for x in rng.integers(0, 10**7, n_words // 8)]
    for i, d in enumerate(digits):
        words.insert((i * 8 + 3) % len(words), d)
    text = " ".join(words)
    return f"{quote} {text} {quote}" if quote else text


def flax_params_tree(sd, layers):
    """The port's state dict as the JAX params tree (unscanned; dense
    kernels [in, out]) that `params::` streams hold."""
    dense = lambda name: {"kernel": sd[name + ".weight"].T}   # noqa: E731
    tree = {"transformer": {"wte": {"embedding": sd["wte.weight"]},
                            "ln_f": {"kernel": sd["ln_f.weight"]}, "h": {}},
            "lm_head": dense("lm_head")}
    for i in range(layers):
        pre = f"h.{i}."
        tree["transformer"]["h"][str(i)] = {
            "attention": {n: dense(pre + "attention." + n) for n in ("wq", "wk", "wv", "wo")},
            "feed_forward": {n: dense(pre + "feed_forward." + n) for n in ("w1", "w2", "w3")},
            "attention_norm": {"kernel": sd[pre + "attention_norm.weight"]},
            "ffn_norm": {"kernel": sd[pre + "ffn_norm.weight"]},
        }
    return tree


def phase_cli():
    """The serving CLI as a subprocess on the card, three runs over one
    saved checkpoint (see CLI_LAYERS). Checks each output file has one line
    per request and that the run loading the index gives the first run's
    completions."""
    cfg = LLaMAConfig.load_config(CLI_PRESET).replace(num_hidden_layers=CLI_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    model = LLaMAForCausalLM(cfg, dtype=BF16, device="cuda")
    model.init_weights(gen)
    rng = np.random.default_rng(SEED + 5)
    with tempfile.TemporaryDirectory(prefix="lwm_cli_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        checkpoint.save_tree(flax_params_tree(model.state_dict(), CLI_LAYERS),
                             str(tmp / "params"))
        del model
        torch.cuda.empty_cache()
        log(f"cli: {CLI_PRESET} width x {CLI_LAYERS} layers saved as a params stream "
            f"({(tmp / 'params').stat().st_size / 1e9:.2f} GB) in {time.perf_counter() - t0:.1f}s")
        (tmp / "doc.txt").write_text(_cli_text(rng, 2500))
        quotes = [_cli_text(rng, 12) for _ in range(8)]
        prompts = [_cli_text(rng, 20 + 10 * i, quote=q) for i, q in enumerate(quotes)]
        (tmp / "requests.jsonl").write_text("".join(json.dumps({"prompt": p}) + "\n"
                                                    for p in prompts))
        base = [sys.executable, "-m", "lwm_tpu_torch.apps.serve", *CLI_FLAGS,
                f"--load_llama_config={CLI_PRESET}",
                f"--update_llama_config=dict(num_hidden_layers={CLI_LAYERS},scan_attention=False,"
                "scan_mlp=False,theta=50000000)",
                "--tokenizer=tests/fixtures/tokenizer_bpe",
                f"--load_checkpoint=params::{tmp / 'params'}",
                f"--input_file={tmp / 'requests.jsonl'}", f"--max_new_tokens={CLI_NEW}",
                f"--prefix_file={tmp / 'doc.txt'}", f"--lookup_k={LOOKUP_K}"]
        runs = {"index built": [f"--prefix_cache={tmp / 'doc.index'}"],
                "index loaded": [f"--prefix_cache={tmp / 'doc.index'}"],
                "quantized": ["--quantize_weights"]}
        outputs = {}
        for name, extra in runs.items():
            out = tmp / f"{name.replace(' ', '_')}.jsonl"
            t0 = time.perf_counter()
            proc = subprocess.run(base + extra + [f"--output_file={out}"], capture_output=True,
                                  text=True, timeout=600, cwd=Path(__file__).resolve().parent)
            wall = time.perf_counter() - t0
            tail = [ln for ln in proc.stderr.splitlines() if ln.startswith("[")][-4:]
            for ln in tail:
                log(f"cli {name}: {ln}")
            if proc.returncode != 0:
                raise AssertionError(f"cli {name}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
            lines = [json.loads(ln) for ln in out.read_text().splitlines()]
            if sorted(r["prompt"] for r in lines) != sorted(prompts):
                raise AssertionError(f"cli {name}: {len(lines)} lines for {len(prompts)} requests")
            outputs[name] = {r["prompt"]: r["completion"] for r in lines}
            log(f"cli {name}: {len(lines)} completions in {wall:.1f}s (process wall) "
                f"[{card()}]")
        if outputs["index loaded"] != outputs["index built"]:
            raise AssertionError("cli: the run that loaded the prefix index changed completions")
        log("cli: the run loading the saved prefix index gave the first run's completions")


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
    *k1, k1_cases = phase_k1(gen)
    *k4, k4_cases = phase_k4(gen)
    bwd = phase_bwd(gen)
    k56, k56_named = phase_k56(gen)
    torch.cuda.empty_cache()
    # each main path's counts, set to 0 just before its run and read just after
    path_launches = []
    launches, bf16_summary, model = phase_serve()
    path_launches.append(launches)
    torch.cuda.empty_cache()
    path_launches.extend(phase_serve_prefix(model, bf16_summary))
    path_launches.extend(phase_serve_lookup_chunked(model))
    del model
    torch.cuda.empty_cache()
    path_launches.extend(phase_serve_int8(bf16_summary))
    torch.cuda.empty_cache()
    phase_cli()
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
             **k1_cases),
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
