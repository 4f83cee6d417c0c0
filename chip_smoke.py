#!/usr/bin/env python3
"""Drive the PyTorch port (lwm_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

    python3 chip_smoke.py --profile DIR   # also profile one more train step (text,
                                          # then vision-text) and write their
                                          # kernel tables to DIR

Phases; any failure raises and exits non-zero (there is no CPU path):
  1. torch/CUDA versions and the card (nvidia-smi name, power limit).
  2. Build the CUDA kernels from lwm_tpu_torch/csrc with nvcc (sm_90a).
  3. K1 flash_attention_fwd vs its plain twin at the serving and training
     shapes and at the edges of its tiles (K1_CASES), timed at a 2048-token
     admission over the 4096-slot cache, at the train step's attention
     (b 2, seq 4096, 32 heads, d 128) and at the shared prefix's two shapes
     (the build's last 2048-token chunk over 32768 keys; an admission's
     256 queries over the prefix block, not causal) and at a question's
     admission over the video block (256 queries over 30976 keys).
  4. K4 flash_decode vs its plain twin, output and (o, m, l) partials, at
     8 slots (bf16 and int8, MHA and GQA; a row with no valid key gives
     (0, BIG_NEG, 0)), at one slot of T 65536, and at the shared-prefix
     fold (all slots' query heads over one 32768-key prefix block: groups
     6, 8, 12, 16 and 32; and group 4 over the video QA path's 30976-row
     block); every case timed.
     Then K1's and K4's fp32 routes (the needle evals' dtype) at fp32 against
     the same twins within 1e-5 of the twin's largest value: K1 over the
     needle batch's cache (5120 queries over 6144 slots) and its edges, and
     at the 32k needle bundle's prefill (its twin in 1024-query chunks); K4 over the needle
     batch's 4 rows (MHA and GQA) and one row of the bundle's 34816 slots,
     output and partials; and both at vision_generation's CFG pair (K1 its
     image prefill, 128 queries over 385 slots, and the 8-frame video's, 385
     over 3072; K4 a step over each); each timed beside SDPA at fp32 and
     the fp32 bound.
  5. The fused backward flash_attention_bwd (dq, dk, dv in one kernel) vs
     its plain twin at the training shapes (b 2, seq 4096, 32 heads, d 128;
     GQA; a ragged seq) and at edges of its tiles (seq 1000 with offsets
     and a full-tile bias, causal or not; d 64 at 8 kv heads). Then its
     fp32 route (csrc/flash_bwd_f32.cu, the trainers' default fp32) within
     1e-5 of the twin's largest dq, dk and dv (phase_bwd_f32): the train
     shape, one row of 8192 and one of 32768 at 6 heads (the 8K and 32K
     stages of run_context_extension.sh; the 32K one held to the twin's
     arithmetic in float64 on 2 heads), GQA, ragged sq/skv with offsets
     causal and not over a full-tile bias, d 64, rows with no valid key (dq
     0); the three long shapes timed beside the bound of three TF32
     products a product and the fp32 FMA bound, SDPA's fp32 backward and
     the twin, K1's fp32 route at the train shape too.
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
     prefill). Then video QA (phase_serve_vision): the same weights as a
     VideoLLaMA (vte and vision_head new from the seed) with a 120-frame
     video (30859 prefix tokens in the CLI's prompt layout, vision-masked
     codes) built in 2048-token chunks and 8 questions through 4 slots
     (cache 1024, buckets 64/128/256): exact K1/K4 counts, build seconds,
     each admission's seconds, decode tok/s, peak memory; admission and
     decode logits over the video on the noise floor (the block built
     again through K1's plain twin at 4 of the 32 layers), one admission
     held to one forward of video + question without a cache, and the masks
     shown to matter; then 4 requests each with its own 4-frame video
     inline (submit(vision_masks=)). Then batched generation
     (`lwm_tpu_torch.generation` through `apps.sampler.TextSampler`) on the
     same weights as a shared-index model: four left-padded prompts of
     335-3598 tokens (fixture tokenizer) in 4096, 32 new tokens, exact K1/K4
     counts, prefill and decode times; the prefill's last logits held on the
     noise floor to the plain path and to each prompt run alone unpadded,
     greedy agreement printed. Then the needle evals' dtype: the weights cast
     up to fp32, one batch of eval_needle's tester at context 4000 (4 rows x
     5120 tokens over a 6144-slot cache, 128 new tokens) on K1's and K4's
     fp32 routes (exact fp32 counts), its logits held to the plain fp32 path
     at 1e-3 of the largest and two rows' greedy tokens to it exactly.
     Then speculative decoding (`lwm_tpu_torch.speculative`) on the fp32
     copy, 4 rows of 1024-token prompts, 128 new tokens, k 7: the target
     as its own draft (every proposal accepted), a 2-layer draft at the 7b
     width, prompt lookup on repeating prompts, each arm's greedy tokens
     equal to generate's (or apart first at a reported near tie), exact
     K1/K4 counts, ms a round, tokens/s beside generate; then a bf16 arm
     over an int8 cache (K4 int8 in the draft's steps); K1 at the verify's
     q 8 and K4 at a draft step timed at fp32.
     Then VQGAN (phase_vqgan): the released architecture with random
     weights from the seed encodes and decodes 8 frames of 256^2 at fp32
     (TF32 off), timed a frame beside the same calls with TF32; one frame
     on the host CPU gives the card's codes (but at reported near ties)
     and pixels. Then text to image and video (phase_vision_generation):
     scripts/run_sample_{image,video}_torch.sh's CFG sampler at the 7b
     width, 32 layers, fp32, on the fp32 copy as a VideoLLaMA: the image
     (cfg 5, top-k 8192, 257 tokens) and a 3-frame video on it (cfg 1,
     top-k 100), exact K1/K4 fp32 counts, EOF every 257th token, ms a step,
     tokens/s, peak; the first step's guided logits held to the plain fp32
     path at 1e-3 of the largest, a top-k 1 image's tokens to its tokens;
     the frames decoded to uint8 pixels.
  8. The same weights quantized on the card (`quantize_params_int8`, the
     run_serve.sh QUANTIZE=1 bundle): serve the 12 requests with
     quant_dense="int8" (K5 for every dense product) and 4 with
     "int8_w8a8" and an int8 cache (K6, K5 for lm_head); exact launch
     counts, K5's and K6's admission GEMMs counted apart; admission logits
     of K5 against the "int8_xla" dequant arm on the same int8 tensors,
     and of both (and W8A8) against an fp32 copy of the dequantized
     weights.
     Then the CLIs, each once as a `python -m` subprocess (the module entry
     point on the card, its wall time split into imports, the params
     stream's read and the work) and its other runs through its `main` in
     this process: the serving CLI (`lwm_tpu_torch.apps.serve`) three times
     over a 7b-width 4-layer params stream written by the port: a prefix
     document, its index saved then loaded (the same completions), lookup
     verify; and with --quantize_weights. The video QA CLI
     (`apps.serve_vision`) three times over a 4-layer VideoLLaMA stream and
     an 8-frame codes file: its video index saved, then loaded (the same
     answers), lookup verify. Both needle eval CLIs (`apps.eval_needle`,
     `eval_needle_multi`) at fp32 over a 7b-width 4-layer stream and a
     generated haystack, contexts 1000-4000 x 2 depths x 1 round, each run
     twice: one results row a grid point, and the rerun adds none. The
     text-to-image CLI (`apps.vision_generation`) over a 4-layer VideoLLaMA
     stream and phase_vqgan's model as the released pickle, both written by
     the port: the subprocess's PNG equals the in-process run's, pixel for
     pixel, with exact K1/K4 fp32 counts.
  9. Train step at 7b width (2 layers, seq 4096): loss and per-parameter
     grads of the kernel path against an attn_impl="plain" bf16 model and
     an fp32 copy (the noise floor), on the same weights and batch; and the
     kernel path at fp32 compute (K1's and the backward's fp32 routes) held
     to that fp32 copy (loss 1e-6 relative, each grad 1e-5 of its largest
     element).
 10. Train the 7b width at 16 of its 32 layers (fp32 master weights, bf16
     compute, remat save_flash, AdamW as scripts/run_train_text.sh), batch
     2 x 4096, 6 steps on one fixed batch from the seed: finite, falling
     loss, and K1 and the backward launched layers x steps times on that
     path. The same at fp32 compute (phase_train_f32, the trainers'
     default --dtype): K1's and the backward's fp32 routes launched
     exactly layers x steps; and 4 steps of run_context_extension.sh's 32K
     stage (phase_train_ctx32k: hidden 768, 6 layers, 1 x 32768, fp32,
     remat nothing_saveable; exact fp32 counts), its step time beside the
     backward's share. Then scripts/run_spec_natural.sh's path
     (phase_spec_cli): the training CLI at fp32 with its target and draft
     configs, BPE fixture tokenizer and `[question],answer,[postpad]`
     fields (the target's copy run, a second run warm-started from it with
     params::, the draft's run; exact fp32 launch counts), then both saved
     streams loaded and decoded by speculative_generate and
     prompt_lookup_generate: greedy tokens equal to generate's.
 11. The training CLI (`lwm_tpu_torch.train.main`, in-process) on a JSONL
     from the seed and the fixture tokenizer: the same width and depth for
     6 steps (finite, falling loss; K1 and the backward launched exactly
     16 x 6 times; step time beside phase 10's, tokens/s, model-FLOPs
     share, peak memory, the data pipeline's rate), 2 steps with
     --fused_lm_loss (step 1's loss held to the bf16 noise floor of the
     default run's, against an fp32 run of the same weights and batch), and
     the checkpoint round trip at 1 layer with an fp32 train state: 2 steps
     and a save, an autoresumed run to step 4 and an uninterrupted one (the
     resumed steps read the same data and land within a stated tolerance;
     save and load seconds).
 12. Vision-text training (phase_train_vision): the training CLI with
     --modality=vision,text as scripts/run_train_vision_torch.sh runs it,
     over a JSONL of clips of 8-30 frames of random codes and random-word
     captions from the seed: the 7b width as a VideoLLaMA at 16 layers, one
     row of 32768 tokens (`no_pad`), 6 AdamW steps (finite, falling loss;
     K1 and the backward launched exactly 16 x 6 times; step time,
     tokens/s, model-FLOPs share with both heads, peak memory), 2 with
     --freeze_base at 4 layers (every frozen param bit-unchanged, vte and
     vision_head moved), 2 with the PaLM optimizer at 4 layers, the
     1-layer round trip under both
     (`pad` rows), the 6 AdamW steps again at --loss_chunk_size=32768,
     whose peak may be at most 1 GiB over the default run's (ROADMAP C5:
     the dual loss takes any chunk in 2048-row pieces), and a
     kernel-vs-plain VideoLLaMA train step (7b width,
     2 layers, seq 4096, held to the fp32 noise floor). Its attention, K1
     and the fused backward at b1 S32768 h32 causal, is timed beside SDPA
     (is_causal) with the kernel phases and held to the plain twins at 2
     heads (phase_train_vision_kernels).
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
import io
import itertools
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from lwm_tpu_torch import checkpoint, generation, speculative, train
from lwm_tpu_torch import serve as serve_module
from lwm_tpu_torch.apps import eval_needle, eval_needle_multi
from lwm_tpu_torch.apps import serve as serve_cli
from lwm_tpu_torch.apps import sampler as sampler_module
from lwm_tpu_torch.apps import serve_vision as vision_cli
from lwm_tpu_torch.apps import vision_generation as vision_app
from lwm_tpu_torch.apps.sampler import TextSampler
from lwm_tpu_torch.models import llama as llama_module
from lwm_tpu_torch.models.llama import LLaMAConfig, LLaMAForCausalLM, quantize_kv
from lwm_tpu_torch.models.vision_llama import (
    EOF,
    EOV,
    TOKENS_PER_FRAME,
    VideoLLaMAConfig,
    VideoLLaMAForCausalLM,
)
from lwm_tpu_torch.models.vqgan import VQGAN, VQGANConfig, VQGANModel, full_fp32
from lwm_tpu_torch.ops import _build, decode, flash, quant
from lwm_tpu_torch.ops import prefix as prefix_ops
from lwm_tpu_torch.ops.reference import BIG_NEG, MASK_GUARD
from lwm_tpu_torch.serve import InflightServer, _lookup_proposal, build_prefix_cache, prefill_logits
from lwm_tpu_torch.utils.convert import flax_params_tree, save_vqgan_pickle
from lwm_tpu_torch.utils.image import read_png
from lwm_tpu_torch.utils.rng import set_random_seed
from lwm_tpu_torch.utils.tokenizer import Tokenizer

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
# 1024 bucket's admission over it is held too. One more is timed at the
# video QA path's shape (phase_serve_vision): a question's 256-query
# admission over the video block (VIDEO_P_STORE keys, VIDEO_P_TRUE valid),
# not causal
K1_TRAIN_REPORT = "train_b2_S4096_h32_causal_padkeys"
K1_TIMED = ("bucket2048_T4096_perkey", K1_TRAIN_REPORT, "prefix_build_q2048_qoff30720_T32768",
            "prefix_admit_q256_T32768_noncausal", "video_admit_q256_T30976_noncausal")
# the video prefix of phase_serve_vision: VIDEO_FRAMES frames of 256 codes, EOF
# after each and EOV after the last, inside the CLI's prompt layout (19 text
# tokens with the fixture tokenizer): VIDEO_P_TRUE tokens, stored as
# VIDEO_P_STORE rows (a multiple of 128)
VIDEO_FRAMES = 120
VIDEO_P_TRUE, VIDEO_P_STORE = 30859, 30976
K1_CASES = [
    ("bucket2048_T4096_perkey", 1, 32, 128, 2048, 4096, True, 0, 0, True, "prompt"),
    (K1_TRAIN_REPORT, 2, 32, 128, 4096, 4096, True, 0, 0, False, "per_key"),
    ("prefix_build_q2048_qoff30720_T32768", 1, 32, 128, 2048, 32768, True, 30720, 0, True,
     "written"),
    ("prefix_admit_q256_T32768_noncausal", 1, 32, 128, 256, 32768, False, 0, 0, True, "prefix"),
    ("prefix_admit_q1024_T32768_noncausal", 1, 32, 128, 1024, 32768, False, 0, 0, True, "prefix"),
    ("video_admit_q256_T30976_noncausal", 1, 32, 128, 256, VIDEO_P_STORE, False, 0, 0, True,
     "video"),
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
    prefix-validity bias, all but the last 68 keys; "video": the video
    block's, its first VIDEO_P_TRUE keys; "per_key" and "full": the
    backward's (_bwd_bias); "frontier": per-row frontiers with 20% random
    holes over a full tile, and "no_keys" the same with K1_EMPTY_ROWS
    masked whole."""
    keys = torch.arange(T, device="cuda")
    if kind in ("prompt", "written", "prefix", "video"):
        valid = keys < {"prompt": sq - 37, "written": q_off + sq, "prefix": T - 68,
                        "video": VIDEO_P_TRUE}[kind]
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
# a prefix whose last 68 stored keys are padding; and the video QA path's
# fold (phase_serve_vision): 4 slots (group 4) over the video block
K4_FOLD_CASES = [
    ("fold_g8_bf16_P32768", 1, 32, 32768, False, 256, 32768),
    ("fold_g8_int8_P32768", 1, 32, 32768, True, 256, 32768),
    ("fold_g16_bf16_P32768", 1, 32, 32768, False, 512, 32768),
    ("fold_g32_bf16_hkv8_P32768", 1, 8, 32768, False, 256, 32768),
    ("fold_g6_bf16_P32700", 1, 32, 32768, False, 192, 32700),
    ("fold_g12_bf16_P32700", 1, 32, 32768, False, 384, 32700),
    ("fold_g12_int8_P32700", 1, 32, 32768, True, 384, 32700),
    ("fold_g4_bf16_video_P30976", 1, 32, VIDEO_P_STORE, False, 128, VIDEO_P_TRUE),
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


# K1's and K4's fp32 routes (csrc/flash_fwd_f32.cu, csrc/flash_decode.cu's
# fp32 instance), which the needle evals run (scripts/run_eval_needle.sh:
# --dtype=fp32): held to the plain twins at fp32 within F32_REL_TOL of the
# twin's largest |value| (fp32 sums over thousands of keys in another
# order; no TF32 on either side) and timed beside SDPA at fp32 and the
# bound, the larger of the bytes over the HBM rate and the flops: K1's at
# three TF32 products a product over the H100 SXM's TF32 rate
# (H100_TF32_PEAK, its design since the three-product redesign), its fp32
# FMA bound (H100_F32_PEAK, the rate outside the tensor cores) beside as
# fma_bound_ms; K4's at H100_F32_PEAK.
# K1: name, b, h_kv, d, sq, T, causal, q_offset, head-major, bias kind. The
# first is the shape phase_generate_f32's needle batch gives K1 (a 4000-token
# context: max_input_length 5120 over its 6144-slot cache, per-key bias with
# 80 left-pad keys); the second is the 32k needle bundle's prefill
# (max_input_length 33792 over a 34816-slot cache), where the twin, whole,
# would materialise 150 GB of scores: it runs in F32_TWIN_CHUNK-query
# chunks (a row's softmax is its own, so the chunks compute the same
# function), for the hold and for plain_ms; then the CFG prefills, and the
# speculative verify (phase_speculative's shape: 8 queries at the cache
# index 1088 of SPEC_ROWS rows over the 2048-slot cache, the full-tile bias
# of the mask's frontier; timed from CUDA-graph replays, as there); the
# rest hold the edges: a 16-row prompt
# over a full-tile bias (generate's prefill of a short prompt), GQA, d 64,
# a ragged tile with offsets, not causal, seq-major, rows with no valid key.
F32_REL_TOL = 1e-5
# the first real key of the CFG pair's rows: the cond prompt and the uncond
# "<s><vision>" left-padded to 128 tokens (phase_vision_generation's batch)
CFG_FIRST_KEYS = (90, 122)
H100_F32_PEAK = 67e12     # fp32 FLOP/s outside the tensor cores, H100 SXM data sheet
H100_TF32_PEAK = 495e12   # dense TF32 FLOP/s on the tensor cores, H100 SXM data sheet
F32_TWIN_CHUNK = 1024     # queries a twin call over the bundle's 34816 keys: 4.6 GB of scores
K1_F32_REPORT = "f32_needle_q5120_T6144"
K1_F32_BUNDLE = "f32_bundle_q33792_T34816"
K1_F32_CFG = ("f32_cfg_image_b2_q128_T385", "f32_cfg_video_b2_q385_T3072")
K1_F32_VERIFY = "f32_verify_b4_q8_qoff1088_T2048"   # phase_speculative: f32_verify_b4_q8_T2048
K1_F32_TIMED = (K1_F32_REPORT, K1_F32_BUNDLE, *K1_F32_CFG, K1_F32_VERIFY)
K1_F32_CASES = [
    (K1_F32_REPORT, 1, 32, 128, 5120, 6144, True, 0, True, "needle"),
    (K1_F32_BUNDLE, 1, 32, 128, 33792, 34816, True, 0, True, "needle"),
    # vision_generation's prefills (the bundles' CFG batch: the cond row's
    # prompt over the uncond "<s><vision>"'s, left-padded to 128): the image
    # over round_cache_length(128 + 257) slots, the 8-frame video's prompt
    # and first frame over the 3072 slots of 128 + 257 + 7 x 257 tokens
    (K1_F32_CFG[0], 2, 32, 128, 128, 385, True, 0, True, "cfg"),
    (K1_F32_CFG[1], 2, 32, 128, 385, 3072, True, 0, True, "cfg"),
    (K1_F32_VERIFY, 4, 32, 128, 8, 2048, True, 1088, True, "verify"),
    ("f32_q16_fulltile", 2, 32, 128, 16, 1024, True, 0, True, "frontier"),
    ("f32_gqa_hkv8_q1000", 1, 8, 128, 1000, 2048, True, 0, True, "needle"),
    ("f32_d64_S1000_offsets", 2, 8, 64, 1000, 1000, True, 700, False, "full"),
    ("f32_noncausal_q300_T1000", 1, 32, 128, 300, 1000, False, 0, True, "needle"),
    ("f32_q300_rows_without_keys", 1, 32, 128, 300, 4096, True, 3000, True, "no_keys"),
]
# K4: name, b, h_kv, T, kv_len, the rows' first real key (left padding). The
# needle batch's decode over its cache (4 rows, 6144 slots, after 1 to 128
# steps), GQA, and one row of the 32k bundle's cache (34816 slots)
K4_F32_CASES = [
    ("f32_needle_b4_T6144", 4, 32, 6144, 5248, [0, 80, 700, 2000]),
    # vision_generation's steps: the CFG pair (CFG_FIRST_KEYS) at the image's
    # last step and at the 8-frame video's
    ("f32_cfg_image_b2_T385", 2, 32, 385, 385, list(CFG_FIRST_KEYS)),
    ("f32_cfg_video_b2_T3072", 2, 32, 3072, 2184, list(CFG_FIRST_KEYS)),
    ("f32_gqa_hkv8_b4_T6144", 4, 8, 6144, 5121, [0, 80, 700, 2000]),
    ("f32_bundle_b1_T34816", 1, 32, 34816, 34816, [300]),
]


def _f32_hold(name, got, want):
    """max|got - want| over max|want|, held to F32_REL_TOL; returns it."""
    err = (got - want).abs().max().item()
    rel = err / max(want.abs().max().item(), 1e-30)
    log(f"{name}: max|Δ| {err:.3e}, over max|plain| {rel:.3e} (tol {F32_REL_TOL})")
    if not rel <= F32_REL_TOL:
        raise AssertionError(f"{name} disagrees with its plain twin at fp32")
    return err


def tf32_bounds(n_bytes, pair_flops):
    """An fp32 route's bounds at a case (K1's and the backward's): the bytes
    over the HBM rate against three TF32 products of `pair_flops` at
    H100_TF32_PEAK (the routes' design), and against `pair_flops` at
    H100_F32_PEAK (the fp32 FMA bound of the rows before it). Returns
    (bound_ms, bound_by, fma_bound_ms)."""
    bnd, by = bound_ms(n_bytes, 3 * pair_flops, H100_TF32_PEAK)
    return bnd, by, bound_ms(n_bytes, pair_flops, H100_F32_PEAK)[0]


def k1_f32_inputs(case, gen):
    """q, k, v, bias, kw and the valid keys ([T], [b, T] or, for "verify",
    [sq, T]) of a K1_F32_CASES case."""
    name, b, h_kv, d, sq, T, causal, q_off, head_major, kind = case
    f32, h = torch.float32, 32
    q = _randn((b, sq, h, d), gen, f32)
    kv_shape = (b, h_kv, T, d) if head_major else (b, T, h_kv, d)
    k, v = _randn(kv_shape, gen, f32), _randn(kv_shape, gen, f32)
    keys = torch.arange(T, device="cuda")
    if kind == "needle":
        valid = (keys >= 80) & (keys < q_off + sq) if causal else keys < T - 68
        bias = torch.where(valid, 0.0, BIG_NEG)[None, None, None, :]
    elif kind == "cfg":   # each row's left padding, its keys up to the last query
        first = torch.tensor(CFG_FIRST_KEYS, device="cuda")[:, None]
        valid = (keys[None] >= first) & (keys[None] < q_off + sq)
        bias = torch.where(valid, 0.0, BIG_NEG)[:, None, None, :]
    elif kind == "verify":   # the mask's frontier: query i sees keys <= q_off + i
        valid = keys[None] <= q_off + torch.arange(sq, device="cuda")[:, None]
        bias = torch.where(valid, 0.0, BIG_NEG)[None, None]
    else:
        bias, valid = _k1_bias(kind, b, sq, T, q_off, gen)
    kw = dict(causal=causal, q_offset=q_off, kv_head_major=head_major)
    if kind == "full":
        kw["kv_offset"] = 300
    return q, k, v, bias, kw, valid


def k1_f32_work(case, q, bias, valid):
    """(bytes, flops) of a timed K1_F32_CASES case: q read and out written,
    the keys the rows see read once from k and v, lse written, the bias
    read; 4·d flops a (query, key) pair and head, each product once
    (tf32_bounds counts the route's three)."""
    name, b, h_kv, d, sq, T, causal, q_off, head_major, kind = case
    h = q.shape[2]
    if kind == "verify":
        pairs, kv_rows = int(valid.sum()) * b, (q_off + sq) * b
    else:
        pairs, kv_rows = attn_pairs(valid, sq, q_off if causal else T), int(valid.sum())
    n_bytes = 2 * q.numel() * 4 + 2 * kv_rows * h_kv * d * 4 + b * h * sq * 4
    return n_bytes + bias.numel() * 4, 4 * d * h * pairs


def _k1_twin(q, k, v, bias, kw, chunk=None):
    """K1's plain twin (out, lse), over `chunk` queries a call when given
    (q_offset moved along; `bias` per key)."""
    if chunk is None:
        return flash.flash_attention_fwd_plain(q, k, v, bias, **kw)
    parts = [flash.flash_attention_fwd_plain(q[:, i:i + chunk], k, v, bias,
                                             **dict(kw, q_offset=kw["q_offset"] + i))
             for i in range(0, q.shape[1], chunk)]
    return torch.cat([o for o, _ in parts], 1), torch.cat([lse for _, lse in parts], 2)


def phase_f32_kernels(gen):
    """K1's and K4's fp32 routes at K1_F32_CASES and K4_F32_CASES. Returns
    ({name: times} for flash_fwd, {name: times} for flash_decode, worst
    max|Δ| of each), times as dict(ms, plain_ms, library_ms, bound_ms,
    bound_by), K1's also with fma_bound_ms and its max_abs_err."""
    f32 = torch.float32
    k1, k4, worst = {}, {}, {"flash_fwd": 0.0, "flash_decode": 0.0}
    for case in K1_F32_CASES:
        name, b, h_kv, d, sq, T, causal, q_off, head_major, kind = case
        q, k, v, bias, kw, valid = k1_f32_inputs(case, gen)
        h = q.shape[2]
        n0 = flash.flash_attention_fwd.f32_launches
        out, lse = flash.flash_attention_fwd(q, k, v, bias, **kw)
        torch.cuda.synchronize()
        if flash.flash_attention_fwd.f32_launches != n0 + 1:
            raise AssertionError(f"K1 {name}: the fp32 route was not launched")
        chunk = F32_TWIN_CHUNK if name == K1_F32_BUNDLE else None
        ref, ref_lse = _k1_twin(q, k, v, bias, kw, chunk)
        err = _f32_hold(f"K1 {name} out", out, ref)
        worst["flash_fwd"] = max(worst["flash_fwd"], err)
        live = ref_lse > BIG_NEG / 2
        _f32_hold(f"K1 {name} lse", lse[live], ref_lse[live])
        if kind == "no_keys":
            rows = list(K1_EMPTY_ROWS)
            if not (torch.all(out[:, rows] == 0) and torch.all(lse[:, :, rows] == BIG_NEG)):
                raise AssertionError(f"K1 {name}: rows with no valid key are not 0 / BIG_NEG")
        del ref, ref_lse, live
        if name in K1_F32_TIMED:
            # the verify's 8 queries from CUDA-graph replays (a few us of
            # work), as phase_speculative times it; the rest eager
            graph = kind == "verify"
            iters = 50 if graph else 3 if chunk else 10
            ms = time_ms(lambda: flash.flash_attention_fwd(q, k, v, bias, **kw), iters,
                         graph=graph)
            plain_ms = time_ms(lambda: _k1_twin(q, k, v, bias, kw, chunk), 1 if chunk else 2)
            # SDPA's memory-efficient kernel takes fp32 and an additive mask
            # (4.7 GB at the bundle's shape); its math fallback would need
            # the 150 GB of scores, so it is not allowed to fall back
            from torch.nn.attention import SDPBackend, sdpa_kernel

            pos = q_off + torch.arange(sq, device="cuda")
            mask = torch.where(torch.arange(T, device="cuda")[None] <= pos[:, None], bias,
                               BIG_NEG)
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k, v, attn_mask=mask, enable_gqa=h_kv != h), iters,
                    graph=graph)
            del mask
            n_bytes, flops = k1_f32_work(case, q, bias, valid)
            bnd, by, fma = tf32_bounds(n_bytes, flops)
            k1[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd,
                            bound_by=by, fma_bound_ms=fma, max_abs_err=err)
            log(f"K1 {name}: kernel {ms:.4f} ms{' (graph)' if graph else ''} "
                f"({100 * bnd / ms:.1f}% of the bound, {100 * fma / ms:.1f}% of the FMA "
                f"bound), plain {plain_ms:.3f} ms"
                f"{f' (in {chunk}-query chunks)' if chunk else ''}, SDPA fp32 "
                f"(memory-efficient) {lib_ms:.4f} ms, bound {bnd:.4f} ms ({by}; three TF32 "
                f"products of {flops / 1e12:.3f} TFLOP at 495 TFLOP/s), FMA bound {fma:.4f} "
                f"ms (67 TFLOP/s) [{card()}]")
        del q, k, v, out, lse, bias
        torch.cuda.empty_cache()

    for name, b, h_kv, T, kv_len, firsts in K4_F32_CASES:
        h, d = 32, 128
        q = _randn((b, 1, h, d), gen, f32)
        k, v = _randn((b, h_kv, T, d), gen, f32), _randn((b, h_kv, T, d), gen, f32)
        keys = torch.arange(T, device="cuda")
        mask = (keys[None] >= torch.tensor(firsts, device="cuda")[:, None]) & (keys[None] < kv_len)
        args = (q, k, v, mask, kv_len)
        n0 = decode.flash_decode.f32_launches
        out = decode.flash_decode(*args)
        o, m, l = decode.flash_decode(*args, return_partials=True)
        torch.cuda.synchronize()
        if decode.flash_decode.f32_launches != n0 + 2:
            raise AssertionError(f"K4 {name}: the fp32 route was not launched")
        ref = decode.flash_decode_plain(*args)
        ro, rm, rl = decode.flash_decode_plain(*args, return_partials=True)
        worst["flash_decode"] = max(worst["flash_decode"], _f32_hold(f"K4 {name} out", out, ref))
        _f32_hold(f"K4 {name} partials m", m, rm)
        _f32_hold(f"K4 {name} partials l", l, rl)
        if not torch.equal(o, out):
            raise AssertionError(f"K4 {name}: o with partials differs from the plain output")
        bnd, by, kv_bytes = k4_bound(q, k, mask, kv_len)
        bnd, by = bound_ms(kv_bytes + 2 * q.numel() * 4 + b * kv_len,
                           4 * int(mask.sum()) * h * d, H100_F32_PEAK)
        sets = k4_arg_sets((q, k, v, mask, kv_len, None, None), kv_bytes)
        ms = time_ms(lambda *a: decode.flash_decode(*a), 50, sets, graph=True)
        plain_ms = time_ms(lambda: decode.flash_decode_plain(*args), 3)
        seen = mask[:, None, None, :]
        lib_ms = time_ms(lambda q, k, v, *_: F.scaled_dot_product_attention(
            q.transpose(1, 2), k, v, attn_mask=seen, enable_gqa=h_kv != h), 50, sets, graph=True)
        k4[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd, bound_by=by)
        log(f"K4 {name}: kernel {ms:.4f} ms (graph; {100 * bnd / ms:.1f}% of the bound), plain "
            f"{plain_ms:.3f} ms, SDPA fp32 {lib_ms:.4f} ms (graph), bound {bnd:.4f} ms ({by}) "
            f"(b={b} h={h} h_kv={h_kv} T={T} kv_len={kv_len}; {len(sets)} cache copies "
            f"cycled) [{card()}]")
        del q, k, v, mask, args, sets, seen
        torch.cuda.empty_cache()
    return k1, k4, worst


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


# The fused backward's fp32 route (csrc/flash_bwd_f32.cu), which the
# trainers run at their default --dtype=fp32: held to the plain twin at fp32,
# each of dq, dk and dv within F32_REL_TOL of its largest |value| (every
# product as three TF32 products on the tensor cores and fp32 sums in
# another order, dq's across key tiles by atomics; the twin takes no TF32).
# Cases: name, b, h_kv, d, sq, skv, causal, q_offset, kv_offset, bias kind
# ("per_key": the model's, 300 right-padded keys in row 1; "zero": the
# all-ones mask's; "full": a full-tile bias with 20% holes; "late_keys":
# the same with holes at key 0 too, and the keys start at kv_offset 64, so
# the first 64 rows causally see none and their dq is 0), at 32 query
# heads unless BWD_F32_HEADS says otherwise. The first is the train step's
# attention (7b width, 2 x 4096); the second and third are the 8K and 32K
# stages of scripts/run_context_extension.sh (one row of 8192 at the 7b's 32
# heads; one row of 32768 at its BASE_CFG's 6 heads, on BWD_F32_TWIN_HEADS of
# them: the twin's fp32 [h, S, S] intermediates do not fit at 6). At 32768
# the fp32 twin's own sums over the queries sit 1.1e-5 (dk) and 1.3e-5 (dv)
# of their largest value from float64 (an H100 80GB HBM3 at 700 W, PERF.md),
# so that case is held to the twin's arithmetic in float64 (_bwd_f64), the
# fp32 twin's distance logged beside. These three are timed beside the
# bound of the route's design (three TF32 products a product at
# H100_TF32_PEAK; the fp32 FMA bound beside as fma_bound_ms), SDPA's fp32
# backward (memory-efficient, the same float mask) and the twin. K1's fp32
# route is held to its twin and timed at the first too (the forward of the
# same step)
BWD_F32_REPORT, BWD_F32_8K = "f32_b2_S4096_h32_causal_padkeys", "f32_b1_S8192_h32_causal"
BWD_F32_32K = "f32_b1_S32768_h6_causal"
BWD_F32_TIMED = (BWD_F32_REPORT, BWD_F32_8K, BWD_F32_32K)
BWD_F32_HEADS, BWD_F32_TWIN_HEADS = {BWD_F32_32K: 6}, 2
BWD_F32_CASES = [
    (BWD_F32_REPORT, 2, 32, 128, 4096, 4096, True, 0, 0, "per_key"),
    (BWD_F32_8K, 1, 32, 128, 8192, 8192, True, 0, 0, "zero"),
    (BWD_F32_32K, 1, 6, 128, 32768, 32768, True, 0, 0, "zero"),
    ("f32_gqa_hkv8_S4096", 2, 8, 128, 4096, 4096, True, 0, 0, "per_key"),
    ("f32_ragged_sq1000_skv1100_causal_offsets_fulltile", 2, 8, 128, 1000, 1100, True, 700,
     300, "full"),
    ("f32_ragged_sq1000_skv1100_noncausal_offsets", 2, 32, 128, 1000, 1100, False, 700, 300,
     "full"),
    ("f32_d64_hkv8_S4096", 2, 8, 64, 4096, 4096, True, 0, 0, "per_key"),
    ("f32_rows_without_keys_sq200_skv300", 2, 32, 128, 200, 300, True, 0, 64, "late_keys"),
]


def _bwd_f64(q, k, v, g, lse, delta, bias, *, causal, q_offset, kv_offset, chunk=2048):
    """The twin's arithmetic in float64, `chunk` queries at a time: (dq, dk,
    dv) of MHA inputs with a per-key bias (inputs as the twin's)."""
    b, sq, h, d = q.shape
    if k.shape[2] != h or bias.shape[2] != 1:
        raise ValueError("_bwd_f64 takes MHA inputs and a per-key bias")
    f64, scale = torch.float64, d ** -0.5
    dq, dk, dv = (torch.zeros(x.shape, dtype=f64, device=x.device) for x in (q, k, v))
    keys = kv_offset + torch.arange(k.shape[1], device=q.device)
    for bi, hh in itertools.product(range(b), range(h)):
        kk, vv = k[bi, :, hh].to(f64), v[bi, :, hh].to(f64)
        kb = bias[bi if bias.shape[0] > 1 else 0, 0, 0].to(f64)
        for c0 in range(0, sq, chunk):
            qq, gg = q[bi, c0:c0 + chunk, hh].to(f64), g[bi, c0:c0 + chunk, hh].to(f64)
            x = qq @ kk.T * scale + kb
            if causal:
                pos = q_offset + c0 + torch.arange(qq.shape[0], device=q.device)
                x = x.masked_fill(keys[None] > pos[:, None], BIG_NEG)
            p = torch.where(x > MASK_GUARD, torch.exp(x - lse[bi, hh, c0:c0 + chunk, None]), 0.0)
            ds = p * (gg @ vv.T - delta[bi, hh, c0:c0 + chunk, None]) * scale
            dq[bi, c0:c0 + chunk, hh] = ds @ kk
            dk[bi, :, hh] += ds.T @ qq
            dv[bi, :, hh] += p.T @ gg
    return dq, dk, dv


def bwd_f32_work(q, k, bias, pairs):
    """(bytes, flops) of the fp32 backward at a case: q, g, k, v read, dq,
    dk, dv written, dq's buffer zeroed, all fp32; lse, delta and the bias
    read; five products of 2·d flops a (query, key) pair and head, each once
    (tf32_bounds counts the route's three)."""
    b, sq, h, d = q.shape
    n_bytes = (2 * q.numel() + 2 * k.numel()) * 4 * 2 + q.numel() * 4
    return n_bytes + 2 * b * h * sq * 4 + bias.numel() * 4, 10 * d * h * pairs


def _bwd_f32_bias(kind, b, sq, skv, gen):
    """(bias, valid keys [b, skv] or None) of a BWD_F32_CASES kind."""
    if kind == "per_key":
        return _bwd_bias(kind, b, skv, gen)
    if kind == "zero":
        return (torch.zeros((b, 1, 1, skv), device="cuda"),
                torch.ones((b, skv), dtype=torch.bool, device="cuda"))
    holes = torch.rand((b, sq, skv), generator=gen, device="cuda") < 0.2
    if kind == "full":
        holes[:, :, 0] = False
    vals = torch.randn((b, sq, skv), generator=gen, device="cuda")
    return torch.where(holes, BIG_NEG, vals)[:, None], None


def phase_bwd_f32(gen):
    """The backward's fp32 route at BWD_F32_CASES against its twin, and K1's
    fp32 route held and timed at the train shape. Returns (max_abs_err, {case:
    times} of the backward, times of K1 at the train shape), times as
    dict(ms, plain_ms, library_ms, bound_ms, bound_by, fma_bound_ms), the
    32K case's also with plain_heads."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    f32 = torch.float32
    worst, timed, k1_train = 0.0, {}, None
    for name, b, h_kv, d, sq, skv, causal, q_off, kv_off, kind in BWD_F32_CASES:
        h = BWD_F32_HEADS.get(name, 32)
        q, g = _randn((b, sq, h, d), gen, f32), _randn((b, sq, h, d), gen, f32)
        k, v = _randn((b, skv, h_kv, d), gen, f32), _randn((b, skv, h_kv, d), gen, f32)
        bias, valid = _bwd_f32_bias(kind, b, sq, skv, gen)
        kw = dict(causal=causal, q_offset=q_off, kv_offset=kv_off)
        out, lse = flash.flash_attention_fwd(q, k, v, bias, **kw)
        delta = torch.einsum("bqhd,bqhd->bhq", g, out).contiguous()
        args = (q, k, v, g, lse, delta, bias)
        n0 = flash.flash_attention_bwd.f32_launches
        got = flash.flash_attention_bwd(*args, **kw)
        torch.cuda.synchronize()
        if flash.flash_attention_bwd.f32_launches != n0 + 1:
            raise AssertionError(f"flash_bwd {name}: the fp32 route was not launched")
        # the twin over all heads, or (MHA, each head its own) over the
        # first BWD_F32_TWIN_HEADS
        twin_args, twin_h = args, h
        if name in BWD_F32_HEADS:
            twin_h = BWD_F32_TWIN_HEADS
            twin_args = (*(x[:, :, :twin_h].contiguous() for x in (q, k, v, g)),
                         *(x[:, :twin_h].contiguous() for x in (lse, delta)), bias)
            got = tuple(x[:, :, :twin_h] for x in got)
        want = flash.flash_attention_bwd_plain(*twin_args, **kw)
        if name in BWD_F32_HEADS:   # held to float64 (above), the fp32 twin beside
            ref = _bwd_f64(*twin_args, **kw)
            for oname, a, w, r in zip(("dq", "dk", "dv"), got, want, ref):
                twin_rel = ((w - r).abs().max() / r.abs().max()).item()
                route_rel = ((a - w).abs().max() / w.abs().max()).item()
                log(f"flash_bwd {name} {oname}: the fp32 twin's max|Δ| from float64 over "
                    f"max|float64| {twin_rel:.3e}, the route's from the fp32 twin {route_rel:.3e}")
            want = ref
            del ref
        for oname, a, r in zip(("dq", "dk", "dv"), got, want):
            if a.dtype != f32 or a.shape != r.shape:
                raise AssertionError(f"flash_bwd {name} {oname}: {a.dtype} {tuple(a.shape)}")
            worst = max(worst, _f32_hold(f"flash_bwd {name} {oname}", a, r))
        if kind == "late_keys":
            empty = got[0][:, :kv_off - q_off]
            if not torch.all(empty == 0):
                raise AssertionError(f"flash_bwd {name}: rows with no valid key have dq "
                                     f"{empty.abs().max().item():.3e}, want 0")
            log(f"flash_bwd {name}: the {kv_off - q_off} rows with no valid key have dq 0")
        del got, want
        torch.cuda.empty_cache()
        if name in BWD_F32_TIMED:
            # yardsticks: SDPA's memory-efficient kernel (fp32, additive
            # mask; the math fallback is not allowed), forward and backward
            pos = torch.arange(sq, device="cuda")
            mask = torch.where(pos[None] <= pos[:, None], bias, BIG_NEG)
            qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                   enable_gqa=h_kv != h)
                gt = g.transpose(1, 2)
                lib_ms = time_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), gt,
                                                             retain_graph=True), 5)
                if name == BWD_F32_REPORT:
                    fwd_lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                        qt.detach(), kt.detach(), vt.detach(), attn_mask=mask,
                        enable_gqa=h_kv != h), 5)
            del qt, kt, vt, o, mask
            ms = time_ms(lambda: flash.flash_attention_bwd(*args, **kw), 5)
            plain_ms = time_ms(lambda: flash.flash_attention_bwd_plain(*twin_args, **kw), 2)
            torch.cuda.empty_cache()
            pairs = attn_pairs(valid, sq, q_off)
            n_bytes, flops = bwd_f32_work(q, k, bias, pairs)
            bnd, by, fma = tf32_bounds(n_bytes, flops)
            timed[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd,
                               bound_by=by, fma_bound_ms=fma)
            if twin_h != h:
                timed[name]["plain_heads"] = twin_h
            log(f"flash_bwd {name}: kernel {ms:.3f} ms ({100 * bnd / ms:.1f}% of the bound, "
                f"{100 * fma / ms:.1f}% of the FMA bound), plain backward {plain_ms:.3f} ms"
                f"{f' at {twin_h} heads' if twin_h != h else ''}, SDPA fp32 backward "
                f"(memory-efficient) {lib_ms:.3f} ms, bound {bnd:.3f} ms ({by}; three TF32 "
                f"products of {flops / 1e12:.3f} TFLOP at 495 TFLOP/s), FMA bound {fma:.3f} "
                f"ms (67 TFLOP/s) [{card()}]")
            if name == BWD_F32_REPORT:
                # K1's out and lse (the backward's inputs above) held to the
                # twin at this shape, lse on the rows with a valid key
                ref, ref_lse = flash.flash_attention_fwd_plain(q, k, v, bias, **kw)
                f_err = _f32_hold(f"K1 {name} out", out, ref)
                live = ref_lse > BIG_NEG / 2
                _f32_hold(f"K1 {name} lse", lse[live], ref_lse[live])
                del ref, ref_lse, live
                f_ms = time_ms(lambda: flash.flash_attention_fwd(q, k, v, bias, **kw), 5)
                f_plain = time_ms(lambda: flash.flash_attention_fwd_plain(q, k, v, bias, **kw), 2)
                n_bytes = 2 * q.numel() * 4 + 2 * int(valid.sum()) * h_kv * d * 4
                n_bytes += b * h * sq * 4 + bias.numel() * 4
                fb, fby, fma = tf32_bounds(n_bytes, 4 * d * h * pairs)
                k1_train = dict(ms=f_ms, plain_ms=f_plain, library_ms=fwd_lib_ms, bound_ms=fb,
                                bound_by=fby, fma_bound_ms=fma, max_abs_err=f_err)
                log(f"K1 {name}: kernel {f_ms:.3f} ms ({100 * fb / f_ms:.1f}% of the bound, "
                    f"{100 * fma / f_ms:.1f}% of the FMA bound), plain {f_plain:.3f} ms, SDPA "
                    f"fp32 (memory-efficient) {fwd_lib_ms:.3f} ms, bound {fb:.3f} ms ({fby}; "
                    f"three TF32 products at 495 TFLOP/s), FMA bound {fma:.3f} ms [{card()}]")
        del q, k, v, g, out, lse, delta, args, twin_args, bias
        torch.cuda.empty_cache()
    return worst, timed, k1_train


# The vision-text bundle's attention (scripts/run_train_vision_text.sh: one
# row of 32768 tokens, 7b width, causal; its all-ones attention mask gives
# a zero per-key bias): K1 and the fused backward timed at h32 with SDPA
# (is_causal) beside them, and held to their plain twins at
# VISION_TWIN_HEADS heads (the twins materialise [h, S, S] fp32 scores:
# 8.6 GB a head pair, ~40 GB at the backward's peak; h32 would not fit)
VISION_TRAIN_REPORT = "train_vision_b1_S32768_h32_causal"
VISION_TRAIN_SEQ, VISION_TWIN_HEADS = 32768, 2
# K1's output at that length: a row over n random keys has |out| ~
# sqrt(e/n) (0.009 at n 32768), below BF16_TOL, and lse does not read v.
# So out is also held by cosine to the twin (BWD_COS_MIN) and per (query,
# head) row by |out - plain| / |plain| (bf16 rounding of out and of p:
# 4.3e-3 at worst on an H100 80GB HBM3, 700 W, PERF.md); two planted faults
# that leave lse exact must fail the hold
FWD_ROW_REL_TOL = 1e-2


def _k1_out_hold(out, ref):
    """(max|out - ref|, cosine, the largest per-row relative error) of K1's
    output [b, s, h, d] against its twin's."""
    diff = (out.float() - ref.float())
    rows = diff.norm(dim=-1) / ref.float().norm(dim=-1).clamp_min(1e-30)
    return diff.abs().max().item(), _cosine(out, ref), rows.max().item()


def _k1_out_held(err, cos, row_rel):
    return err <= BF16_TOL and cos >= BWD_COS_MIN and row_rel <= FWD_ROW_REL_TOL


def phase_train_vision_kernels(gen):
    """K1 and the fused backward at VISION_TRAIN_SEQ (see above). Returns
    ({ms, plain_ms, library_ms, bound_ms, bound_by, max_abs_err,
    plain_heads} of K1, the same of the backward); plain_ms is the twin's
    at VISION_TWIN_HEADS heads."""
    S, d, b = VISION_TRAIN_SEQ, 128, 1
    kw = dict(causal=True, q_offset=0, kv_offset=0)
    bias = torch.zeros((b, 1, 1, S), device="cuda")   # the all-ones mask's per-key bias
    valid = torch.ones((b, S), dtype=torch.bool, device="cuda")
    rows = {}
    h = VISION_TWIN_HEADS
    q, k, v, g = (_randn((b, S, h, d), gen) for _ in range(4))
    out, lse = flash.flash_attention_fwd(q, k, v, bias, **kw)
    ref, ref_lse = flash.flash_attention_fwd_plain(q, k, v, bias, **kw)
    torch.cuda.synchronize()
    err, cos, row_rel = _k1_out_hold(out, ref)
    lse_err = (lse - ref_lse).abs().max().item()
    log(f"K1 {VISION_TRAIN_REPORT} at h{h}: max|out-plain| {err:.3e} (tol {BF16_TOL}), "
        f"cosine {cos:.7f} (min {BWD_COS_MIN}), largest row |out-plain|/|plain| "
        f"{row_rel:.3e} (tol {FWD_ROW_REL_TOL}), max|lse-plain| {lse_err:.3e} (tol {LSE_TOL})")
    if not (_k1_out_held(err, cos, row_rel) and lse_err <= LSE_TOL):
        raise AssertionError(f"K1 {VISION_TRAIN_REPORT} disagrees with its plain twin")
    # planted faults, the kernel fed what a faulty kernel would read: v of
    # the other head, and one 128-key tile of v (keys 16384-16511) read
    # from the next tile; lse stays exact, so the output hold must fail
    tile = S // 2
    v_tile = v.clone()
    v_tile[:, tile:tile + 128] = v[:, tile + 128:tile + 256]
    for fault, v_bad in (("v of the other head", v.flip(2)),
                         (f"v's tile at key {tile} read from the next", v_tile)):
        bad, bad_lse = flash.flash_attention_fwd(q, k, v_bad, bias, **kw)
        reading = _k1_out_hold(bad, ref)
        log(f"K1 {VISION_TRAIN_REPORT} planted fault ({fault}): max|out-plain| "
            f"{reading[0]:.3e}, cosine {reading[1]:.7f}, largest row relative error "
            f"{reading[2]:.3e}, max|lse-plain| {(bad_lse - ref_lse).abs().max().item():.3e}: "
            f"{'passes' if _k1_out_held(*reading) else 'fails'} the hold")
        if _k1_out_held(*reading):
            raise AssertionError(f"K1 {VISION_TRAIN_REPORT}: the hold passed a planted fault "
                                 f"({fault})")
        del bad, bad_lse
    del ref, ref_lse, v_tile
    torch.cuda.empty_cache()
    fwd_plain_ms = time_ms(lambda: flash.flash_attention_fwd_plain(q, k, v, bias, **kw), 2)
    torch.cuda.empty_cache()
    delta = torch.einsum("bqhd,bqhd->bhq", g.float(), out.float()).contiguous()
    args = (q, k, v, g, lse, delta, bias)
    got = flash.flash_attention_bwd(*args, **kw)
    want = flash.flash_attention_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    bwd_err, parts = 0.0, []
    for oname, a, r in zip(("dq", "dk", "dv"), got, want):
        diff = (a.float() - r.float()).abs().max().item()
        rel, cos = diff / r.float().abs().max().item(), _cosine(a, r)
        parts.append(f"{oname} max|Δ|/max|ref| {rel:.3e} cos {cos:.6f}")
        if not (rel <= BWD_REL_TOL and cos >= BWD_COS_MIN):
            raise AssertionError(f"flash_bwd {VISION_TRAIN_REPORT} {oname} disagrees with the twin")
        bwd_err = max(bwd_err, diff)
    log(f"flash_bwd {VISION_TRAIN_REPORT} at h{h}: " + "; ".join(parts) +
        f" (bounds {BWD_REL_TOL}, cos {BWD_COS_MIN})")
    del got, want
    torch.cuda.empty_cache()
    bwd_plain_ms = time_ms(lambda: flash.flash_attention_bwd_plain(*args, **kw), 2)
    del q, k, v, g, out, lse, delta, args
    torch.cuda.empty_cache()

    h = 32
    q, k, v, g = (_randn((b, S, h, d), gen) for _ in range(4))
    fwd_ms = time_ms(lambda: flash.flash_attention_fwd(q, k, v, bias, **kw), 10)
    fwd_lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True), 10)
    bnd = k1_bound(q, k, bias, valid, dict(kw, kv_head_major=False))
    rows["flash_fwd"] = dict(ms=fwd_ms, plain_ms=fwd_plain_ms, library_ms=fwd_lib_ms,
                             bound_ms=bnd[0], bound_by=bnd[1], max_abs_err=err,
                             plain_heads=VISION_TWIN_HEADS)
    out, lse = flash.flash_attention_fwd(q, k, v, bias, **kw)
    delta = torch.einsum("bqhd,bqhd->bhq", g.float(), out.float()).contiguous()
    args = (q, k, v, g, lse, delta, bias)
    bwd_ms = time_ms(lambda: flash.flash_attention_bwd(*args, **kw), 5)
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    gt = g.transpose(1, 2)
    bwd_lib_ms = time_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), gt, retain_graph=True), 5)
    # as phase_bwd counts: q, g, k, v read and dq, dk, dv written in bf16,
    # lse, delta and the bias read, dq's fp32 sum zeroed and read; five
    # products of 2·d flops a (query, key) pair and head
    pairs = attn_pairs(valid, S, 0)
    n_bytes = (2 * q.numel() + 2 * k.numel()) * 2 * 2 + 2 * b * h * S * 4 + b * S * 4
    n_bytes += q.numel() * 4 * 2
    bbnd = bound_ms(n_bytes, 10 * d * h * pairs, H100_BF16_PEAK)
    rows["flash_bwd"] = dict(ms=bwd_ms, plain_ms=bwd_plain_ms, library_ms=bwd_lib_ms,
                             bound_ms=bbnd[0], bound_by=bbnd[1], max_abs_err=bwd_err,
                             plain_heads=VISION_TWIN_HEADS)
    for name, r in rows.items():
        log(f"{name} {VISION_TRAIN_REPORT}: kernel {r['ms']:.3f} ms "
            f"({100 * r['bound_ms'] / r['ms']:.1f}% of the bound), SDPA (is_causal) "
            f"{r['library_ms']:.3f} ms, plain twin at "
            f"h{VISION_TWIN_HEADS} {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']}) [{card()}]")
    del q, k, v, g, qt, kt, vt, o, out, lse, delta, args
    torch.cuda.empty_cache()
    return rows["flash_fwd"], rows["flash_bwd"]


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
                int8_matmul_gemm=k5 * admitted, w8a8_matmul_gemm=k6 * admitted,
                flash_fwd_f32=0, flash_bwd_f32=0, flash_decode_f32=0)


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


def plain_arms(model, fp32=None):
    """The noise floor's arms on `model`'s weights: "plain", the same
    tensors through attn_impl="plain", and "fp32", an fp32 upcast copy
    through it (`fp32`, when given: `fp32_weights` of them), the truth both
    bf16 paths are held to."""
    cfg = model.config.replace(attn_impl="plain")
    fp32 = fp32_weights(model) if fp32 is None else fp32
    return {"plain": type(model).on_tensors(cfg, model.state_dict(), model.dtype),
            "fp32": type(model).on_tensors(cfg, fp32, torch.float32)}


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


def serve_modes_run(srv, prompts, budgets, temps, name, want_launches, masks=None,
                    on_token=None):
    """Submit (with each prompt's vision `masks`, when given, and
    `on_token`), run with the counts set to 0 just before and read just
    after, check every request and the exact launch counts
    (`want_launches(stats)`). Returns (launches, summary)."""
    cfg = srv.model.config
    masks = masks or [None] * len(prompts)
    rids = [srv.submit(p, n, t, on_token=on_token, vision_masks=vm)
            for p, n, t, vm in zip(prompts, budgets, temps, masks)]
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
                          decode_tok_s=decode_tokens / s["decode_s"], wall=wall, rids=rids)


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


# ------------------------------------------------------------- video QA
# phase_serve_vision: the bf16 phase's weights as a VideoLLaMA (sample_mode
# "text"; vte and vision_head new, from the seed) serving the CLI's bundle
# (scripts/run_serve_vision_torch.sh: 4 slots, cache 1024, buckets
# 64/128/256) over a VIDEO_FRAMES-frame video built in PREFIX_CHUNK-token
# chunks: VIDEO_QUESTION_LENS text questions with VIDEO_BUDGETS new tokens.
# Then a pool without a prefix (4 slots, cache 4096, bucket 2048) serving
# INLINE_FRAMES-frame videos inline with 4 questions.
VISION_SLOTS, VISION_CACHE, VISION_BUCKETS = 4, 1024, (64, 128, 256)
VIDEO_QUESTION_LENS = [20, 250, 64, 130, 200, 45, 100, 180]
VIDEO_BUDGETS = [64, 128, 96, 64, 128, 80, 112, 72]
INLINE_FRAMES, INLINE_QUESTION_LENS, INLINE_BUDGETS = 4, [20, 60, 35, 48], [32, 48, 40, 32]
# The video block built again without a kernel (K1's plain twin), in chunks
# of TWIN_CHUNK: ~4 GB of fp32 scores a chunk, beside the weights and both blocks.
TWIN_CHUNK = 1024
TWIN_LAYERS = 4   # the layers of the video block built again without kernels


def _first_layers(model, n):
    """`model` cut to its first n layers, on its own tensors."""
    sd = {k: v for k, v in model.state_dict().items()
          if not k.startswith("h.") or int(k.split(".")[1]) < n}
    return type(model).on_tensors(model.config.replace(num_hidden_layers=n), sd, model.dtype)
FIXTURE_TOKENIZER = Path(__file__).resolve().parent / "tests" / "fixtures" / "tokenizer_bpe"


def vision_model(model):
    """A VideoLLaMA (sample_mode "text") on `model`'s own tensors, plus a
    vision embedding and vision head drawn from the seed."""
    cfg = VideoLLaMAConfig.from_dict({**vars(model.config), "sample_mode": "text"})
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    sd = dict(model.state_dict())
    for name in ("vte.weight", "vision_head.weight"):
        sd[name] = (torch.randn((cfg.vision_vocab_size, cfg.hidden_size), generator=gen,
                                device="cuda") * cfg.initializer_range).to(BF16)
    return VideoLLaMAForCausalLM.on_tensors(cfg, sd, BF16)


def video_codes(rng, frames):
    """`frames` frames of 256 VQ codes, EOF after each but the last, EOV
    after it; (tokens, masks)."""
    tokens = []
    for f in range(frames):
        tokens += rng.integers(0, 8192, 256).tolist() + [EOV if f == frames - 1 else EOF]
    return tokens, [True] * len(tokens)


def one_shot_logits(model, ids, vision_masks):
    """The fp32 last-token logits of one forward of the whole sequence
    without a cache (K1 over it at once; no prefix block, no chunks)."""
    m = type(model).on_tensors(model.config.replace(
        prefix_len=0, prefix_tokens=0, logits_tail=1, attn_impl="auto",
        max_sequence_length=max(model.config.max_sequence_length, len(ids))),
        model.state_dict(), model.dtype)
    dev = model.wte.weight.device
    with torch.no_grad():
        out = m(torch.tensor([ids], device=dev),
                vision_masks=None if vision_masks is None else torch.tensor([vision_masks],
                                                                            device=dev))
    return out[0, -1].float()


def phase_serve_vision(model):
    """Video QA on the bf16 phase's weights (`vision_model`): the video
    prefix built through the server in the CLI's prompt layout (K1 once a
    layer a chunk), 8 questions served over it (K1 twice a layer an
    admission, K4 twice a layer a round, the fold at group 4), exact launch
    counts, build seconds, each admission's seconds and each question's
    time to first token, decode tok/s, peak memory. Then admission and
    decode-round logits of 4 questions over the video held to the noise
    floor (hold_over_prefix: the attention_twins arm, the plain concat
    oracle, an fp32 copy reading the same bf16 block), and to the same
    logits through the plain concat oracle over a second block that K1's
    plain twin built (TWIN_CHUNK-token chunks) at TWIN_LAYERS layers,
    against the kernels' block of those layers: no kernel on that arm's
    path. One admission held at that floor to one forward of video +
    question without a cache (and the same forward with the masks cleared
    must land off that floor).
    Then the inline pool: 4 requests each with its own video through
    submit(vision_masks=), exact launches, two admissions held to the
    noise floor against the plain and fp32 arms. Returns the launches of
    the build and the two serving runs."""
    vmodel = vision_model(model)
    cfg = vmodel.config
    L = cfg.num_hidden_layers
    rng = np.random.default_rng(SEED + 9)
    enc = Tokenizer(str(FIXTURE_TOKENIZER))
    codes, _ = video_codes(rng, VIDEO_FRAMES)
    prefix, prefix_vm = vision_cli.video_prefix(enc, vision_cli.parse_flags([]), codes)
    if len(prefix) != VIDEO_P_TRUE:
        raise AssertionError(f"the video prefix holds {len(prefix)} tokens, VIDEO_P_TRUE says "
                             f"{VIDEO_P_TRUE}")
    questions = [rng.integers(2, cfg.vocab_size, n).tolist() for n in VIDEO_QUESTION_LENS]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = time.perf_counter()
    srv = InflightServer(vmodel, slots=VISION_SLOTS, cache_len=VISION_CACHE,
                         prompt_buckets=VISION_BUCKETS, stop_tokens=(cfg.eos_token_id,), seed=SEED,
                         prefix_ids=prefix, prefix_vision_masks=prefix_vm,
                         prefix_chunk=PREFIX_CHUNK)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build = _launch_counts()
    n_chunks = -(-VIDEO_P_TRUE // PREFIX_CHUNK)
    want = dict(expected_launches(cfg, 0, 0), flash_fwd=L * n_chunks)
    if build != want:
        raise AssertionError(f"video prefix build: launches {build}, want {want}")
    log(f"video prefix build: {VIDEO_FRAMES} frames, {VIDEO_P_TRUE} tokens ({len(codes)} vision; "
        f"P_store {srv.model.config.prefix_len}) in {n_chunks} chunks of {PREFIX_CHUNK}, "
        f"{build_s:.3f}s (host clock, synced); launches {build} [{card()}]")

    admit_s, first_at = [], {}
    prefill = serve_module.prefill_logits

    def timed_prefill(*a, **kw):   # each admission's seconds, synced
        t = time.perf_counter()
        out = prefill(*a, **kw)
        torch.cuda.synchronize()
        admit_s.append(time.perf_counter() - t)
        return out

    def on_token(rid, tok):
        first_at.setdefault(rid, time.perf_counter())

    def want_video(s):   # K1 twice a layer an admission, K4 twice a layer a round
        return dict(expected_launches(cfg, 0, 0), flash_fwd=2 * L * s["admitted"],
                    flash_decode=2 * L * s["rounds"])

    temps = [0.0] * len(questions)
    temps[5] = 0.8
    serve_module.prefill_logits = timed_prefill
    try:
        t0 = time.perf_counter()
        launches, summary = serve_modes_run(srv, questions, VIDEO_BUDGETS, temps, "video",
                                            want_video, on_token=on_token)
    finally:
        serve_module.prefill_logits = prefill
    peak = torch.cuda.max_memory_allocated() / 2**30
    ttft = [first_at[r] - t0 for r in summary["rids"]]
    log(f"serve video: {len(questions)} questions of {VIDEO_QUESTION_LENS} tokens over "
        f"{VISION_SLOTS} slots; admission s (time to first token once a slot is free) "
        f"{[round(x, 4) for x in admit_s]}; time to first token from the run's start "
        f"{[round(x, 3) for x in ttft]}; decode {summary['decode_tok_s']:.1f} tok/s over "
        f"{summary['rounds']} rounds; build {build_s:.3f}s; peak {peak:.1f} GiB [{card()}]")

    kernel, block, p_true = srv.model, srv._prefix, srv._pos0
    srv.cache = None
    del srv
    torch.cuda.empty_cache()
    check = questions[:VISION_SLOTS]
    adm = prefix_logits({"kernel": kernel}, block, p_true, check, [0] * len(check))
    tokens = [int(x.argmax()) for x in adm["kernel"][:len(check)]]
    # the block built without kernels, at TWIN_LAYERS of the layers (a
    # layer's keys depend on the layers below it alone, so the kernels'
    # block's first TWIN_LAYERS layers are that shallow model's block):
    # before the fp32 copy, which would leave no room for a second block
    shallow = {name: _first_layers(m, TWIN_LAYERS) for name, m in
               (("base", vmodel), ("kernel", kernel))}
    t0 = time.perf_counter()
    with attention_twins():
        twin_block = build_prefix_cache(shallow["base"], prefix, TWIN_CHUNK,
                                        prefix_vm)[0].layers
    torch.cuda.synchronize()
    log(f"video block built again through K1's plain twin in chunks of {TWIN_CHUNK}, "
        f"{TWIN_LAYERS} of {L} layers: {time.perf_counter() - t0:.3f}s")
    k = shallow["kernel"]
    oracle = type(k).on_tensors(k.config.replace(attn_impl="plain"), k.state_dict(), k.dtype)
    twin = prefix_logits({"twin_build": oracle}, twin_block, p_true, check, tokens)
    twin.update(prefix_logits({"kernel": k, "fp32": plain_arms(k)["fp32"]},
                              block[:TWIN_LAYERS], p_true, check, tokens))
    del twin_block, oracle, shallow, k
    torch.cuda.empty_cache()
    fp32 = fp32_weights(vmodel)
    models = {"kernel": kernel, **plain_arms(kernel, fp32)}
    logits = prefix_logits(models, block, p_true, check, tokens)
    with attention_twins():
        logits.update(prefix_logits({"split": kernel}, block, p_true, check, tokens))
    labels = [f"{len(q)} (video {p_true})" for q in check]
    n = len(check)
    for what, rows in (("video admission", slice(0, n)), ("video decode", slice(n, 2 * n))):
        hold_over_prefix({k: v[rows] for k, v in logits.items()}, "kernel", labels, what)
        # fp32 reads the kernels' block, so the distance ratio favours them:
        # logged; cosine and argmax held
        hold_to_noise_floor({k: v[rows] for k, v in twin.items()}, "kernel", "twin_build",
                            "fp32", labels=labels, argmax_of_truth=True, floor_ratio=None,
                            what=f"{what} (block built without kernels, {TWIN_LAYERS} layers)")
    del models, block, twin
    torch.cuda.empty_cache()

    # one admission against one forward of the whole sequence, no cache
    seq, seq_vm = prefix + check[0], prefix_vm + [False] * len(check[0])
    one = {"one_shot": [one_shot_logits(kernel, seq, seq_vm)],
           "kernel": [logits["kernel"][0]], "fp32": [logits["fp32"][0]]}
    hold_to_noise_floor(one, "kernel", "one_shot", "fp32", argmax_of_truth=True,
                        labels=[f"{len(check[0])} (video {p_true})"],
                        what="video admission vs one forward without a cache")
    cleared = one_shot_logits(kernel, seq, None)
    c = _cos(cleared, one["one_shot"][0])
    log(f"video masks: the same sequence with its masks cleared, logits cosine {c:.6f} to the "
        f"masked one (must be below {COS_MIN}), argmax {int(cleared.argmax())} vs "
        f"{int(one['one_shot'][0].argmax())}")
    if not c < COS_MIN:
        raise AssertionError("clearing the video's vision masks left the logits on the noise floor")
    del kernel, one, logits
    torch.cuda.empty_cache()

    # videos inline with each request, no shared prefix
    prompts, masks = [], []
    for n_q in INLINE_QUESTION_LENS:
        vid, vid_vm = video_codes(rng, INLINE_FRAMES)
        q = rng.integers(2, cfg.vocab_size, n_q).tolist()
        prompts.append(vid + q)
        masks.append(vid_vm + [False] * n_q)
    srv = InflightServer(vmodel, slots=4, cache_len=4096, prompt_buckets=(2048,),
                         stop_tokens=(cfg.eos_token_id,), seed=SEED)

    def want_inline(s):
        return dict(expected_launches(cfg, 0, 0), flash_fwd=L * s["admitted"],
                    flash_decode=L * s["rounds"])

    inline, inline_sum = serve_modes_run(srv, prompts, INLINE_BUDGETS, [0.0] * 4, "inline video",
                                         want_inline, masks=masks)
    log(f"serve inline video: 4 requests of {[len(p) for p in prompts]} tokens "
        f"({INLINE_FRAMES} frames each); prefill {inline_sum['prefill_s']:.3f}s over 4 "
        f"admissions, decode {inline_sum['decode_tok_s']:.1f} tok/s [{card()}]")
    del srv
    torch.cuda.empty_cache()
    arms = {"kernel": vmodel, **plain_arms(vmodel, fp32)}
    inl = {name: [prefill_logits(m, m.init_cache(1, 4096), p, 2048, vision_masks=vm)
                  for p, vm in zip(prompts[:2], masks[:2])] for name, m in arms.items()}
    hold_to_noise_floor(inl, "kernel", "plain", "fp32", argmax_of_truth=True,
                        labels=[f"{len(p)} (inline video)" for p in prompts[:2]],
                        what="inline video admission")
    del arms, fp32, inl
    torch.cuda.empty_cache()
    return [build, launches, inline]


# The CLI on the card: a 7b-width model of CLI_LAYERS layers from the seed,
# saved as a params stream by the port's writer, served by
# `python -m lwm_tpu_torch.apps.serve` with the vendored BPE tokenizer, a
# shared prefix document, a prefix index and lookup verify; run twice (the
# second loads the index) and once more with --quantize_weights. Each CLI
# runs once as a subprocess, which pays ~21 s (~15 s of it imports) for 1-6 s
# of work on an H100; its other runs go through its `main` in this process.
CLI_PRESET, CLI_LAYERS, CLI_NEW = "7b", 4, 32
CLI_FLAGS = ()   # more flags for every CLI run (a rehearsal on the CPU adds --device=cpu)
CLI_WORDS = ("the grass is green and the sky is blue here we go there and back again "
             "special magic number city sun yellow river stone one two three").split()


def _cli_log_split(what, wall, stderr, imports=None):
    """Log a CLI run's wall time split into its imports (a subprocess's, from
    `-X importtime`: all, torch's part), reading the params stream (the
    CLI's own "loaded ... in Ns" lines) and the rest, the work."""
    stream = sum(float(m) for m in re.findall(r"\] loaded \S+ in ([0-9.]+)s", stderr))
    parts = dict(imports or {}, stream=stream)
    parts["work"] = wall - stream - (imports or {}).get("imports", 0.0)
    log(f"{what}: {wall:.1f}s of wall = " + ", ".join(f"{k} {v:.1f}s" for k, v in parts.items())
        + f" [{card()}]")


def run_cli_process(module, args, what):
    """`python -m <module> <args>` in a fresh process (the module entry point
    on the card), its wall time split by `_cli_log_split` (the imports'
    share from `-X importtime`; the kernel library's load, 0.0-0.1 s a
    process when measured apart, falls in the work). Raises on a non-zero
    exit; returns the CompletedProcess."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-X", "importtime", "-m", module, *args],
                          capture_output=True, text=True, timeout=600,
                          cwd=Path(__file__).resolve().parent)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{what}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    top, own = {}, {}   # "import time: self [us] | cumulative | name", nested names indented
    for ln in proc.stderr.splitlines():
        m = re.match(r"import time:\s+(\d+) \|\s+(\d+) \| ( *)(\S+)$", ln)
        if m:
            own[m.group(4)] = int(m.group(1)) / 1e6
            if not m.group(3):
                top[m.group(4)] = int(m.group(2)) / 1e6
    _cli_log_split(what, wall, proc.stderr,
                   dict(imports=sum(top.values()), torch=top.get("torch", 0.0)))
    log(f"{what}: slowest imports by own time " + ", ".join(
        f"{k} {v:.2f}s" for k, v in sorted(own.items(), key=lambda kv: -kv[1])[:6]))
    proc.stderr = "\n".join(ln for ln in proc.stderr.splitlines()
                             if not ln.startswith("import time:"))
    return proc


def run_cli_in_process(main, args, what):
    """`main(args)` of a CLI in this process, its stdout and stderr captured
    (and returned, as (stdout, stderr)) and its wall time split as
    `run_cli_process` splits a subprocess's (no imports to pay here)."""
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main(list(args))
    torch.cuda.synchronize()
    _cli_log_split(f"{what} (in-process)", time.perf_counter() - t0, err.getvalue())
    torch.cuda.empty_cache()
    return out.getvalue(), err.getvalue()


def _cli_text(rng, n_words, quote=None):
    words = [CLI_WORDS[i] for i in rng.integers(0, len(CLI_WORDS), n_words)]
    digits = [str(x) for x in rng.integers(0, 10**7, n_words // 8)]
    for i, d in enumerate(digits):
        words.insert((i * 8 + 3) % len(words), d)
    text = " ".join(words)
    return f"{quote} {text} {quote}" if quote else text


def phase_cli():
    """The serving CLI on the card, three runs over one saved checkpoint
    (see CLI_LAYERS): the first a `python -m` subprocess, the others
    through its main in this process. Checks each output file has one line
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
        checkpoint.save_tree(flax_params_tree(model.state_dict(), cfg), str(tmp / "params"))
        del model
        torch.cuda.empty_cache()
        log(f"cli: {CLI_PRESET} width x {CLI_LAYERS} layers saved as a params stream "
            f"({(tmp / 'params').stat().st_size / 1e9:.2f} GB) in {time.perf_counter() - t0:.1f}s")
        (tmp / "doc.txt").write_text(_cli_text(rng, 2500))
        quotes = [_cli_text(rng, 12) for _ in range(8)]
        prompts = [_cli_text(rng, 20 + 10 * i, quote=q) for i, q in enumerate(quotes)]
        (tmp / "requests.jsonl").write_text("".join(json.dumps({"prompt": p}) + "\n"
                                                    for p in prompts))
        base = [*CLI_FLAGS,
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
        for i, (name, extra) in enumerate(runs.items()):
            out = tmp / f"{name.replace(' ', '_')}.jsonl"
            argv = base + extra + [f"--output_file={out}"]
            if i == 0:   # the module entry point once; the other runs through its main
                err = run_cli_process("lwm_tpu_torch.apps.serve", argv, f"cli {name}").stderr
            else:
                err = run_cli_in_process(serve_cli.main, argv, f"cli {name}")[1]
            for ln in [ln for ln in err.splitlines() if ln.startswith("[")][-4:]:
                log(f"cli {name}: {ln}")
            lines = [json.loads(ln) for ln in out.read_text().splitlines()]
            if sorted(r["prompt"] for r in lines) != sorted(prompts):
                raise AssertionError(f"cli {name}: {len(lines)} lines for {len(prompts)} requests")
            outputs[name] = {r["prompt"]: r["completion"] for r in lines}
            log(f"cli {name}: {len(lines)} completions [{card()}]")
        if outputs["index loaded"] != outputs["index built"]:
            raise AssertionError("cli: the run that loaded the prefix index changed completions")
        log("cli: the run loading the saved prefix index gave the first run's completions")


# The video QA CLI on the card (phase_cli_vision): a 7b-width VideoLLaMA of
# CLI_LAYERS layers from the seed, saved as a params stream by the port's
# writer, served by `python -m lwm_tpu_torch.apps.serve_vision` at
# scripts/run_serve_vision_torch.sh's flags over a CLI_VIDEO_FRAMES-frame
# codes file (2075 prefix tokens, built in two 2048-token chunks) and a
# questions file: the video index saved, then loaded (the same answers),
# then lookup verify.
CLI_VIDEO_FRAMES = 8


def phase_cli_vision():
    """The video QA CLI on the card, three runs over one saved checkpoint:
    the first a `python -m` subprocess, the others through its main. Checks each answers file has one line per question
    and that the run loading the video index gives the first run's
    answers."""
    cfg = VideoLLaMAConfig.load_config(CLI_PRESET).replace(num_hidden_layers=CLI_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    model = VideoLLaMAForCausalLM(cfg, dtype=BF16, device="cuda")
    model.init_weights(gen)
    rng = np.random.default_rng(SEED + 10)
    with tempfile.TemporaryDirectory(prefix="lwm_cli_vision_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        checkpoint.save_tree(flax_params_tree(model.state_dict(), cfg), str(tmp / "params"))
        del model
        torch.cuda.empty_cache()
        log(f"cli vision: {CLI_PRESET} width x {CLI_LAYERS} layers VideoLLaMA saved as a params "
            f"stream ({(tmp / 'params').stat().st_size / 1e9:.2f} GB) in "
            f"{time.perf_counter() - t0:.1f}s")
        (tmp / "codes.jsonl").write_text("".join(
            json.dumps(rng.integers(0, 8192, 256).tolist()) + "\n"
            for _ in range(CLI_VIDEO_FRAMES)))
        questions = [_cli_text(rng, 6 + 4 * i) + "?" for i in range(8)]
        (tmp / "questions.jsonl").write_text("".join(json.dumps({"question": q}) + "\n"
                                                     for q in questions))
        base = [*CLI_FLAGS,
                f"--load_llama_config={CLI_PRESET}",
                f"--update_llama_config=dict(num_hidden_layers={CLI_LAYERS},scan_attention=False,"
                "scan_mlp=False,theta=50000000)",
                f"--tokenizer={FIXTURE_TOKENIZER}",
                f"--load_checkpoint=params::{tmp / 'params'}",
                f"--input_codes_file={tmp / 'codes.jsonl'}",
                f"--questions_file={tmp / 'questions.jsonl'}", f"--max_new_tokens={CLI_NEW}",
                "--slots=4", "--cache_len=1024", "--prompt_buckets=64,128,256"]
        runs = {"index built": [f"--prefix_cache={tmp / 'video.index'}"],
                "index loaded": [f"--prefix_cache={tmp / 'video.index'}"],
                "lookup": [f"--lookup_k={LOOKUP_K}"]}
        outputs = {}
        for i, (name, extra) in enumerate(runs.items()):
            out = tmp / f"{name.replace(' ', '_')}.jsonl"
            argv = base + extra + [f"--output_file={out}"]
            if i == 0:
                err = run_cli_process("lwm_tpu_torch.apps.serve_vision", argv,
                                      f"cli vision {name}").stderr
            else:
                err = run_cli_in_process(vision_cli.main, argv, f"cli vision {name}")[1]
            for ln in [ln for ln in err.splitlines() if ln.startswith("[")][-5:]:
                log(f"cli vision {name}: {ln}")
            lines = [json.loads(ln) for ln in out.read_text().splitlines()]
            if sorted(r["question"] for r in lines) != sorted(questions):
                raise AssertionError(f"cli vision {name}: {len(lines)} lines for "
                                     f"{len(questions)} questions")
            outputs[name] = {r["question"]: r["answer"] for r in lines}
            log(f"cli vision {name}: {len(lines)} answers [{card()}]")
        if outputs["index loaded"] != outputs["index built"]:
            raise AssertionError("cli vision: the run that loaded the video index changed answers")
        log("cli vision: the run loading the saved video index gave the first run's answers")


# Batched generation (`lwm_tpu_torch.generation`, ROADMAP A7a) as
# `apps.sampler.TextSampler` drives it, on phase_serve's bf16 7b weights
# (32 layers) as a shared-index model: four prompts of GEN_WORDS words of
# _cli_text (335-3598 tokens with the fixture tokenizer), cut and padded on
# the left to the next multiple of 1024 (the bundle's scan chunks), GEN_BLOCK
# new tokens (the sampler's block_size, through its scan chunks). The
# prefill's last logits are held on the bf16 noise floor to the plain path
# (attn_impl "plain", the same tensors and padding, one row at a time) with
# an fp32 copy through it as the truth, and to each prompt run alone,
# unpadded; greedy tokens against both are printed, not held (bf16 ties).
GEN_WORDS = (120, 500, 850, 1300)
GEN_BLOCK = 32
# The needle evals' dtype (phase_generate_f32): the same weights cast up to
# fp32, theta and max_sequence_length as scripts/run_eval_needle.sh, scan
# chunks NEEDLE_BLOCK (so 128 new tokens a prompt), one batch of the needle
# tester at context NEEDLE_CONTEXT over NEEDLE_DEPTHS depths (one row each):
# max_input_length 5120 over a 6144-slot cache, K1's and K4's fp32 routes.
# The prefill's last logits are held to the plain fp32 path on two rows at
# NEEDLE_REL_TOL of its largest |logit| (fp32 sums in other orders over 32
# layers; no TF32 on either side), and those rows' greedy tokens, every
# decode step's, to the plain fp32 path's exactly
NEEDLE_BLOCK, NEEDLE_CONTEXT, NEEDLE_DEPTHS = 128, 4000, 4
NEEDLE_REL_TOL = 1e-3


@contextlib.contextmanager
def timed_generation(model):
    """Record what `generation.generate` does on `model` while the block
    runs: the prefill's seconds and last logits (fp32), the whole call's
    seconds and new tokens (both timings closed by a synchronize), and the
    model's forwards (one prefill, then a step a token; a forward pre-hook)."""
    record = dict(forwards=0)
    real_prefill, real_generate = generation.prefill, sampler_module.generate

    def prefill(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, kw = real_prefill(*a, **k)
        torch.cuda.synchronize()
        record.update(prefill_s=time.perf_counter() - t0, prefill_logits=logits.clone())
        return logits, kw

    def generate(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_generate(*a, **k)
        torch.cuda.synchronize()
        record.update(generate_s=time.perf_counter() - t0, tokens=out.clone())
        return out

    def count(*_):
        record["forwards"] += 1

    hook = model.register_forward_pre_hook(count)
    generation.prefill, sampler_module.generate = prefill, generate
    try:
        yield record
    finally:
        generation.prefill, sampler_module.generate = real_prefill, real_generate
        hook.remove()


class RecordingSampler:
    """A sampler that records each call's (prompts, max_input_length) in
    `calls` and passes it on; its other attributes are the sampler's."""

    def __init__(self, sampler):
        self.sampler, self.calls = sampler, []

    def __getattr__(self, name):
        return getattr(self.sampler, name)

    def __call__(self, prompts, max_input_length):
        self.calls.append((prompts, max_input_length))
        return self.sampler(prompts, max_input_length)


def _generation_launches(cfg, record, f32=False):
    """A generate call's launches: K1 a layer for the prefill, K4 a layer a
    step after it; with `f32` all of them on the fp32 routes."""
    L, steps = cfg.num_hidden_layers, record["forwards"] - 1
    want = dict(expected_launches(cfg, 0, 0), flash_fwd=L, flash_decode=L * steps)
    if f32:
        want.update(flash_fwd_f32=L, flash_decode_f32=L * steps)
    return want


def _log_generation(what, record, batch, max_input, cache_len):
    steps = record["forwards"] - 1
    decode_s = record["generate_s"] - record["prefill_s"]
    log(f"{what}: {batch} rows x {max_input} tokens over a {cache_len}-slot cache: prefill "
        f"{record['prefill_s']:.3f}s ({batch * max_input / record['prefill_s']:.0f} tokens/s), "
        f"{steps} decode steps {decode_s:.3f}s ({1e3 * decode_s / max(steps, 1):.2f} ms a step, "
        f"{batch * steps / decode_s:.1f} tok/s); generate {record['generate_s']:.3f}s; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{card()}]")


def _row_logits(model, ids, mask, new_tokens):
    """The prefill's last logits of each row alone (its padding kept): [b, V]."""
    return torch.cat([generation.prefill(model, ids[i:i + 1], mask[i:i + 1], new_tokens)[0]
                      for i in range(ids.shape[0])])


def phase_generate(model, fp32):
    """Batched generation at bf16 (see GEN_*) over `model`'s tensors, `fp32`
    their fp32 upcast (the truth). Returns the launch counts."""
    cfg = model.config.replace(decode_index="shared", scan_query_chunk_size=GEN_BLOCK,
                               scan_key_chunk_size=GEN_BLOCK)
    gm = LLaMAForCausalLM.on_tensors(cfg, model.state_dict(), BF16)
    tok = Tokenizer(str(FIXTURE_TOKENIZER))
    rng = np.random.default_rng(SEED + 16)
    texts = [_cli_text(rng, n) for n in GEN_WORDS]
    lengths = [len(tok.encode(t)) for t in texts]
    max_input = -(-max(lengths) // 1024) * 1024
    sampler = TextSampler.from_model(gm, tok, greedy=True, seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    with timed_generation(gm) as rec:
        sampler(texts, max_input)
    launches = _launch_counts()
    want = _generation_launches(cfg, rec)
    log(f"generate bf16: prompts of {lengths} tokens; launches {launches}")
    if launches != want:
        raise AssertionError(f"generate bf16: launches {launches}, want {want}")
    _log_generation("generate bf16", rec, len(texts), max_input,
                    llama_module.round_cache_length(cfg, max_input + GEN_BLOCK))

    ids, mask = sampler.encode(texts, max_input)
    arms = {"plain": LLaMAForCausalLM.on_tensors(cfg.replace(attn_impl="plain"),
                                                 model.state_dict(), BF16),
            "fp32": LLaMAForCausalLM.on_tensors(cfg.replace(attn_impl="plain"), fp32,
                                                torch.float32)}
    logits = {"batched": list(rec["prefill_logits"])}
    for name, arm in arms.items():
        logits[name] = list(_row_logits(arm, ids, mask, GEN_BLOCK))
    logits["single"] = [generation.prefill(gm, torch.tensor([tok.encode(t)], device="cuda"),
                                           None, GEN_BLOCK)[0][0] for t in texts]
    hold_to_noise_floor(logits, "batched", "plain", "fp32", argmax_of_truth=True,
                        labels=lengths, what="generate prefill (left-padded batch)")
    hold_to_noise_floor(logits, "batched", "single", "fp32", argmax_of_truth=True,
                        labels=lengths, what="generate prefill (vs unpadded)", floor_ratio=None)
    batched = rec["tokens"]
    singles = torch.cat([generation.generate(
        gm, torch.tensor([tok.encode(t)], device="cuda"), None, sampler.generation_config())
        for t in texts])
    plain = torch.cat([generation.generate(arms["plain"], ids[i:i + 1], mask[i:i + 1],
                                           sampler.generation_config())
                       for i in range(len(texts))])
    for name, other in (("unpadded", singles), ("plain", plain)):
        same = (batched == other).float().mean(-1).tolist()
        log(f"generate bf16: greedy tokens shared with the {name} runs, a row: "
            f"{[round(x, 3) for x in same]} (of {GEN_BLOCK}; not held: bf16 near-ties)")
    del gm, arms, sampler
    torch.cuda.empty_cache()
    return launches


def phase_generate_f32(model, fp32):
    """One needle batch at the evals' fp32 (see NEEDLE_*) through
    eval_needle's tester and TextSampler over `fp32` (the upcast of
    `model`'s tensors). Returns the launch counts."""
    cfg = model.config.replace(
        decode_index="shared", scan_query_chunk_size=NEEDLE_BLOCK,
        scan_key_chunk_size=NEEDLE_BLOCK, theta=10_000_000, max_sequence_length=131072)
    m32 = LLaMAForCausalLM.on_tensors(cfg, fp32, torch.float32)
    tok = Tokenizer(str(FIXTURE_TOKENIZER))
    sampler = TextSampler.from_model(m32, tok, greedy=True, seed=SEED,
                                     stop_strings=("USER:", "\nUSER"))
    rng = np.random.default_rng(SEED + 17)
    with tempfile.TemporaryDirectory(prefix="lwm_needle_") as tmp:
        tmp = Path(tmp)
        haystack = tmp / "haystack.jsonl"
        haystack.write_text("".join(json.dumps({"text": _cli_text(rng, 300) + ". "}) + "\n"
                                    for _ in range(40)))
        max_input = -(-(NEEDLE_CONTEXT + 1024) // NEEDLE_BLOCK) * NEEDLE_BLOCK
        recorder = RecordingSampler(sampler)
        flags = SimpleNamespace(**dict(
            eval_needle.DEFAULTS, haystack_file=str(haystack), output_file=str(tmp / "r.json"),
            n_rounds=1, max_tokens_per_batch=NEEDLE_DEPTHS * (max_input + NEEDLE_BLOCK)))
        set_random_seed(SEED)
        tester = eval_needle.LLMNeedleHaystackTester(
            flags, haystack_file=str(haystack), context_lengths_min=NEEDLE_CONTEXT,
            context_lengths_max=NEEDLE_CONTEXT, context_lengths_num_intervals=1,
            document_depth_percent_intervals=NEEDLE_DEPTHS, sampler=recorder)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launch_counts()
        with timed_generation(m32) as rec:
            tester.run_test()
        launches = _launch_counts()
        prompts = recorder.calls
        results = json.loads((tmp / "r.json").read_text())
    want = _generation_launches(cfg, rec, f32=True)
    log(f"needle fp32: {len(results)} results, responses {[r['response'][:40] for r in results]}"
        f"; launches {launches}")
    if launches != want or len(prompts) != 1 or len(results) != NEEDLE_DEPTHS:
        raise AssertionError(f"needle fp32: launches {launches} (want {want}), "
                             f"{len(prompts)} batches, {len(results)} results")
    (batch, n), = prompts
    if n != max_input:
        raise AssertionError(f"needle fp32: max_input_length {n}, want {max_input}")
    _log_generation("needle fp32", rec, len(batch), n,
                    llama_module.round_cache_length(cfg, n + NEEDLE_BLOCK))
    ids, mask = sampler.encode(batch, n)
    rows = [0, len(batch) - 1]
    plain = LLaMAForCausalLM.on_tensors(cfg.replace(attn_impl="plain"), fp32, torch.float32)
    want_logits = _row_logits(plain, ids[rows], mask[rows], NEEDLE_BLOCK)
    got = rec["prefill_logits"][rows]
    rel = ((got - want_logits).abs().max() / want_logits.abs().max()).item()
    log(f"needle fp32: prefill logits of rows {rows}, kernel vs plain fp32 path max|Δ|/max|plain| "
        f"{rel:.3e} (tol {NEEDLE_REL_TOL}), argmax {got.argmax(-1).tolist()} / "
        f"{want_logits.argmax(-1).tolist()}")
    if not rel <= NEEDLE_REL_TOL:
        raise AssertionError("needle fp32: kernel-path logits disagree with the plain fp32 path")
    # the decode steps (K4's fp32 route over the shared-index cache): the
    # same rows' greedy tokens through the plain fp32 path, exactly (a row
    # at a time, as its logits: the plain prefill's scores are 7.5 GiB a row)
    want_tokens = torch.cat([generation.generate(plain, ids[i:i + 1], mask[i:i + 1],
                                                 sampler.generation_config()) for i in rows])
    got_tokens = rec["tokens"][rows]
    same = (got_tokens == want_tokens).float().mean(-1).tolist()
    log(f"needle fp32: greedy tokens of rows {rows} shared with the plain fp32 path: {same} "
        f"(of {got_tokens.shape[1]}; held exactly)")
    if not torch.equal(got_tokens, want_tokens):
        raise AssertionError("needle fp32: kernel-path greedy tokens differ from the plain fp32 "
                             "path's")
    del m32, plain, sampler
    torch.cuda.empty_cache()
    return launches


# Speculative decoding (lwm_tpu_torch.speculative) at the 7b preset, 32
# layers, on the serving weights' fp32 copy (phase_speculative): SPEC_ROWS
# rows of equal-length SPEC_PROMPT-token prompts, SPEC_NEW new tokens, k
# SPEC_K, greedy, in four arms over the fp32 target: the target as its own
# draft; a SPEC_DRAFT_LAYERS-layer draft at the 7b width (the target's first
# layers and its embedding and head); the bf16 serving weights as the draft
# (the same tensors, SPEC_NEW / 2 new tokens; bf16 and fp32 greedy tokens
# fork, so rounds accept part of their proposals and rewind into the verify
# window); prompt lookup, n-gram SPEC_NGRAM, on prompts that repeat a span.
# Each arm's tokens are held to `generation.generate`'s on the same
# weights: at fp32 the verify (K1 over k + 1 rows) and a one-token step
# (K4) differ by summation order alone, so a greedy token may flip only at
# a near tie, where the first differing position's top-2 logit gap (one
# forward without a cache) must be below SPEC_TIE_GAP, and is reported.
# Each arm's acceptance is held to the rounds a correct runner makes
# (_predicted_rounds): every emitted token is the verify's argmax, so the
# runner's own tokens and the draft's greedy tokens on their prefixes (the
# runner's own draft calls, teacher-forced; or the lookup's proposals) give
# each round's match length. Stale cache rows after a rewind would change
# the draft's proposals and fail it. The target as its own draft accepts
# every proposal but where its K4 step and the verify's K1 flip a near tie
# (SPEC_TIE_GAP on the step's logits). Then one bf16 arm over an int8 cache
# (K4's int8 route in the draft's steps), half the new tokens: its
# acceptance held the same way, its tokens reported beside bf16 generate's
# (bf16 paths fork)
SPEC_ROWS, SPEC_PROMPT, SPEC_NEW, SPEC_K, SPEC_NGRAM = 4, 1024, 128, 7, 3
SPEC_DRAFT_LAYERS = 2
# fp32 logits of two paths agreed to ~1.5e-5 of the largest on an H100 80GB
# HBM3 at 700 W (PERF.md, the needle batch): a gap below this is a near tie
SPEC_TIE_GAP = 1e-3


def _draft_of(model, layers, cfg):
    """The target's first `layers` layers with its embedding, norm and
    head, as a model of `cfg` on the same tensors (no copy)."""
    keep = {f"h.{i}." for i in range(layers)}
    sd = {k: v for k, v in model.state_dict().items()
          if not k.startswith("h.") or any(k.startswith(p) for p in keep)}
    return type(model).on_tensors(cfg.replace(num_hidden_layers=layers), sd, model.dtype)


def _top2_gap(model, seq, at):
    """The top-2 logit gap of each row at sequence position `at` (the
    logits that chose the token there), from one forward of seq [b, n]
    without a cache."""
    with torch.no_grad():
        logits = model(seq[:, :at], logits_tail=1)[:, -1].float()
    top = logits.topk(2, -1).values
    return (top[:, 0] - top[:, 1]).tolist()


def _spec_hold(what, got, want, model, prompt):
    """Tokens `got` [b, prompt + new] against generate's `want`: equal, or
    first differing at a near tie (SPEC_TIE_GAP)."""
    diff = (got != want).any(0).nonzero()
    if len(diff):
        at = int(diff[0])
        gaps = _top2_gap(model, want, at)
        log(f"{what}: tokens differ from generate's first at position {at - prompt} of the new "
            f"tokens; top-2 logit gaps there {[f'{g:.2e}' for g in gaps]} (near tie below "
            f"{SPEC_TIE_GAP})")
        rows = (got[:, at] != want[:, at]).nonzero()[:, 0].tolist()
        if not all(gaps[r] < SPEC_TIE_GAP for r in rows):
            raise AssertionError(f"{what}: greedy tokens differ from generate's off a near tie")


def _teacher_forced(draft, seq, prompt, cache_len):
    """The draft's greedy token at each position of seq [b, end] from seq's
    prefix, through the runner's own draft calls (the prompt's prefill, then
    one-token steps over a shared-index cache of cache_len slots, all-ones
    mask): [b, end] with -1 up to `prompt`; and the margin [b, end] of the
    draft's logit of its token over its logit of seq's."""
    b, end = seq.shape
    ones = torch.ones((b, cache_len), dtype=torch.bool, device=seq.device)
    cache = draft.init_cache(b, cache_len)
    props = torch.full((b, end), -1, dtype=seq.dtype, device=seq.device)
    margin = torch.zeros((b, end), device=seq.device)
    with torch.no_grad():
        pos = torch.arange(prompt, device=seq.device).expand(b, prompt)
        draft(seq[:, :prompt], ones, pos, cache, logits_tail=1)
        for p in range(prompt, end - 1):
            logits = draft(seq[:, p:p + 1], ones, torch.full((b, 1), p, device=seq.device),
                           cache)[:, -1]
            props[:, p + 1] = logits.argmax(-1)
            logits = logits.float()
            margin[:, p + 1] = logits.max(-1).values - logits.gather(-1, seq[:, p + 1:p + 2])[:, 0]
    return props, margin


def _predicted_rounds(seq, prompt, k, proposals_at):
    """The rounds a correct greedy runner makes, from its tokens seq [b,
    end] (each after `prompt` the verify's argmax) and proposals_at(n) →
    [b, k], the proposals for n + 1 .. n + k of a round that starts at n.
    Proposals past `end` cannot be checked, so the last round's match
    length is a range. Returns (rounds, accepted lo, accepted hi, the match
    length of each round)."""
    b, end = seq.shape
    target = torch.cat([seq, torch.full((b, k), -2, dtype=seq.dtype, device=seq.device)], 1)
    n, lo, hi, ms = prompt, 0, 0, []
    while n < end:
        match = proposals_at(n) == target[:, n + 1:n + k + 1]
        known = (n + 1 + torch.arange(k, device=seq.device)) < end
        m = int(match.long().cumprod(1).sum(1).min())
        lo, hi, n = lo + m, hi + int((match | ~known).long().cumprod(1).sum(1).min()), n + m + 1
        ms.append(m)
    return len(ms), lo, hi, ms


def _acceptance_hold(what, res, prompt, k, draft=None, ngram=None):
    """res's rounds and accepted count against _predicted_rounds, the
    proposals from `draft` teacher-forced or, without one, prompt lookup.
    Returns (match lengths, the draft's margins where its token is not the
    runner's, or None)."""
    seq = res.sequences
    b, end = seq.shape
    cache_len = speculative._cache_len(prompt, end - prompt, k, None)
    flips = None
    if draft is not None:
        props, margin = _teacher_forced(draft, seq, prompt, cache_len)
        flips = margin[:, prompt + 1:][props[:, prompt + 1:] != seq[:, prompt + 1:]]
        props = torch.cat([props, torch.full((b, k), -1, dtype=seq.dtype, device=seq.device)], 1)

        def proposals_at(n):
            return props[:, n + 1:n + k + 1]
    else:
        def proposals_at(n):
            cur = torch.zeros((b, cache_len), dtype=seq.dtype, device=seq.device)
            cur[:, :n + 1] = seq[:, :n + 1]
            return speculative._lookup_proposals(cur, n, seq[:, n], k, ngram)
    rounds, lo, hi, ms = _predicted_rounds(seq, prompt, k, proposals_at)
    partial = sum(0 < m < k for m in ms)
    log(f"{what}: {res.steps} rounds accepting {res.accepted}; a correct runner makes {rounds} "
        f"accepting {lo}" + (f"-{hi}" if hi != lo else "") + f" ({partial} rounds partial)")
    if res.steps != rounds or not lo <= res.accepted <= hi:
        raise AssertionError(f"{what}: {res.steps} rounds accepting {res.accepted}, a correct "
                             f"runner {rounds} accepting {lo}-{hi}")
    return ms, flips


def _spec_prompts(vocab, repeat=False):
    """SPEC_ROWS prompts of SPEC_PROMPT tokens from the seed; with `repeat`,
    each a 64-token span over and over (so that the lookup finds it)."""
    rng = np.random.default_rng(SEED + 21)
    if not repeat:
        return torch.from_numpy(rng.integers(2, vocab, (SPEC_ROWS, SPEC_PROMPT))).cuda()
    span = rng.integers(2, vocab, (SPEC_ROWS, 64))
    return torch.from_numpy(np.tile(span, (1, SPEC_PROMPT // 64))).cuda()


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _spec_arm(what, run, target, draft, ids, gen_s, gen_tokens, k=SPEC_K):
    """One arm: `run()` → SpecResult, timed, launch counts set to 0 just
    before and read just after, held to the exact counts the arm implies
    (K1 a target layer at the prefill and a round, a draft layer at its
    prefill; K4 a draft layer a step, k + 1 steps a round; the fp32 routes'
    share by each model's dtype), and logs ms a round beside the prefills.
    Returns (result, launches)."""
    _reset_launch_counts()
    res, wall = _timed(run)
    launches = _launch_counts()
    t32 = target.dtype == torch.float32
    d32 = draft is not None and draft.dtype == torch.float32
    k1t = target.config.num_hidden_layers * (1 + res.steps)
    k1d = 0 if draft is None else draft.config.num_hidden_layers
    k4 = k1d * (k + 1) * res.steps
    want = dict(expected_launches(target.config, 0, 0), flash_fwd=k1t + k1d, flash_decode=k4,
                flash_fwd_f32=k1t * t32 + k1d * d32, flash_decode_f32=k4 * d32)
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, want {want}")
    # the prefills alone (both models over the prompt), to split the wall
    ones = torch.ones((ids.shape[0], ids.shape[1] + 1), dtype=torch.bool, device="cuda")
    pos = torch.arange(ids.shape[1], device="cuda").expand_as(ids)

    def prefill():
        with torch.no_grad():
            for m in (target,) if draft is None else (target, draft):
                m(ids, ones, pos, m.init_cache(ids.shape[0], ids.shape[1] + 1), logits_tail=1)

    _, pre_s = _timed(prefill)
    round_ms = 1e3 * (wall - pre_s) / res.steps
    new = res.sequences.shape[1] - ids.shape[1]
    same = (res.sequences[:, ids.shape[1]:] == gen_tokens[:, :new]).float().mean().item()
    log(f"{what}: {res.steps} rounds, accepted {res.accepted} ({res.accepted / res.steps:.2f} a "
        f"round of k {k}), {wall:.3f}s ({ids.shape[0] * new / wall:.1f} tok/s; generate "
        f"{gen_tokens.numel() / gen_s:.1f} tok/s on the same rows at {gen_tokens.shape[1]} "
        f"new), a round {round_ms:.2f} ms "
        f"beside the prefills' {pre_s:.3f}s; tokens shared with generate {same:.3f}; launches "
        f"{launches} [{card()}]")
    return res, launches


def phase_speculative(model, fp32):
    """Speculative decoding on the serving weights (see SPEC_*): four fp32
    greedy arms held to generate's tokens and to a correct runner's rounds,
    then a bf16 arm over an int8 cache. Then K1 at the verify's shape and K4
    at the draft's steps, fp32, timed. Returns (each arm's launch counts,
    {case: times} of K1 and of K4)."""
    cfg = model.config.replace(decode_index="shared")
    m32 = LLaMAForCausalLM.on_tensors(cfg, fp32, torch.float32)
    drafts = {"self": m32, "draft": _draft_of(m32, SPEC_DRAFT_LAYERS, cfg),
              "bf16 draft": type(model).on_tensors(cfg, model.state_dict(), model.dtype),
              "lookup": None}
    paths = []
    gcfg = generation.GenerationConfig(max_new_tokens=SPEC_NEW, pad_token_id=0)
    for arm, draft in drafts.items():
        if arm in ("self", "lookup"):   # the draft arms decode the self arm's prompts
            ids = _spec_prompts(cfg.vocab_size, repeat=arm == "lookup")
            _reset_launch_counts()
            gen_tokens, gen_s = _timed(lambda: generation.generate(m32, ids, config=gcfg))
            L = cfg.num_hidden_layers
            want = dict(expected_launches(cfg, 0, 0), flash_fwd=L,
                        flash_decode=L * (SPEC_NEW - 1), flash_fwd_f32=L,
                        flash_decode_f32=L * (SPEC_NEW - 1))
            if _launch_counts() != want:
                raise AssertionError(f"speculative {arm}: generate's launches {_launch_counts()}")
            paths.append(want)
            want_seq = torch.cat([ids, gen_tokens], 1)
        new = SPEC_NEW // 2 if arm == "bf16 draft" else SPEC_NEW
        what = f"speculative fp32 {arm} ({SPEC_ROWS} x {SPEC_PROMPT}, {new} new, k {SPEC_K})"
        if draft is None:
            res, launches = _spec_arm(what, lambda: speculative.prompt_lookup_generate(
                m32, ids, new, k=SPEC_K, ngram=SPEC_NGRAM), m32, None, ids, gen_s, gen_tokens)
        else:
            res, launches = _spec_arm(what, lambda: speculative.speculative_generate(
                m32, draft, ids, new, k=SPEC_K), m32, draft, ids, gen_s, gen_tokens)
        paths.append(launches)
        _spec_hold(what, res.sequences, want_seq[:, :SPEC_PROMPT + new], m32, SPEC_PROMPT)
        ms, flips = _acceptance_hold(what, res, SPEC_PROMPT, SPEC_K, draft, SPEC_NGRAM)
        if arm == "self":
            # a miss only where the step (K4) and the verify (K1) flip a near tie
            log(f"{what}: {flips.numel()} positions where the step's token and the verify's "
                f"differ, margins {[f'{x:.2e}' for x in flips.tolist()]} (near tie below "
                f"{SPEC_TIE_GAP})")
            if not torch.all(flips < SPEC_TIE_GAP):
                raise AssertionError(f"{what}: the target as its own draft missed off a near tie")
        if arm == "bf16 draft" and not any(0 < m < SPEC_K for m in ms):
            raise AssertionError(f"{what}: no round accepted part of its proposals")
        del res
        torch.cuda.empty_cache()
    del gen_tokens, want_seq, drafts
    torch.cuda.empty_cache()

    # bf16 over an int8 cache: the target and a draft of its first layers
    icfg = model.config.replace(decode_index="shared", kv_cache_dtype="int8")
    m8 = type(model).on_tensors(icfg, model.state_dict(), model.dtype)
    d8 = _draft_of(m8, SPEC_DRAFT_LAYERS, icfg)
    ids = _spec_prompts(cfg.vocab_size)
    new = SPEC_NEW // 2   # tokens reported, not held: half the rounds suffice
    _reset_launch_counts()
    gen_tokens, gen_s = _timed(lambda: generation.generate(
        m8, ids, config=generation.GenerationConfig(max_new_tokens=new, pad_token_id=0)))
    paths.append(_launch_counts())
    what = f"speculative bf16 int8 cache ({new} new), draft of {SPEC_DRAFT_LAYERS} layers"
    res, launches = _spec_arm(what, lambda: speculative.speculative_generate(
        m8, d8, ids, new, k=SPEC_K), m8, d8, ids, gen_s, gen_tokens)
    paths.append(launches)
    _acceptance_hold(what, res, SPEC_PROMPT, SPEC_K, d8)
    del m8, d8, gen_tokens, res
    torch.cuda.empty_cache()

    # the kernels at this path's shapes, fp32: K1 as the verify calls it (k
    # + 1 queries at the cache index over the head-major 2048-slot cache,
    # the full-tile bias of the mask's frontier) and K4 as a draft step
    # (one query over the same cache)
    f32, h, d = torch.float32, cfg.num_attention_heads, cfg.head_dim
    T = speculative._cache_len(SPEC_PROMPT, SPEC_NEW, SPEC_K, None)
    n = SPEC_PROMPT + SPEC_NEW // 2     # a round halfway
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    q = _randn((SPEC_ROWS, SPEC_K + 1, h, d), gen, f32)
    k, v = (_randn((SPEC_ROWS, h, T, d), gen, f32) for _ in range(2))
    keys = torch.arange(T, device="cuda")
    frontier = n + torch.arange(SPEC_K + 1, device="cuda")
    valid = keys[None] <= frontier[:, None]                       # [q, T]
    bias = torch.where(valid, 0.0, BIG_NEG)[None, None]           # [1, 1, q, T]
    kw = dict(causal=True, q_offset=n, kv_head_major=True)
    out, lse = flash.flash_attention_fwd(q, k, v, bias, **kw)
    ref, ref_lse = flash.flash_attention_fwd_plain(q, k, v, bias, **kw)
    err = _f32_hold("K1 f32 verify", out, ref)
    ms = time_ms(lambda: flash.flash_attention_fwd(q, k, v, bias, **kw), 50, graph=True)
    plain_ms = time_ms(lambda: flash.flash_attention_fwd_plain(q, k, v, bias, **kw), 5)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k, v,
                                                            attn_mask=bias), 50, graph=True)
    pairs = int(valid.sum()) * SPEC_ROWS
    n_bytes = 2 * q.numel() * 4 + 2 * (n + SPEC_K + 1) * SPEC_ROWS * h * d * 4
    n_bytes += SPEC_ROWS * h * (SPEC_K + 1) * 4 + bias.numel() * 4
    bnd, by, fma = tf32_bounds(n_bytes, 4 * d * h * pairs)
    k1 = {f"f32_verify_b{SPEC_ROWS}_q{SPEC_K + 1}_T{T}": dict(
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd, bound_by=by,
        fma_bound_ms=fma, max_abs_err=err)}
    log(f"K1 f32 verify (b {SPEC_ROWS}, q {SPEC_K + 1} at {n} over {T} slots): kernel {ms:.4f} ms "
        f"(graph; {100 * bnd / ms:.1f}% of the bound), plain {plain_ms:.3f} ms, SDPA fp32 "
        f"{lib_ms:.4f} ms (graph), bound {bnd:.4f} ms ({by}), FMA bound {fma:.4f} ms "
        f"[{card()}]")
    dmask = keys[None].expand(SPEC_ROWS, T) < n
    args = (q[:, :1].contiguous(), k, v, dmask, n)
    got = decode.flash_decode(*args)
    err = _f32_hold("K4 f32 draft step", got, decode.flash_decode_plain(*args))
    bnd, by, kv_bytes = k4_bound(args[0], k, dmask, n)
    ms = time_ms(lambda: decode.flash_decode(*args), 50, graph=True)
    plain_ms = time_ms(lambda: decode.flash_decode_plain(*args), 5)
    seen = dmask[:, None, None, :]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        args[0].transpose(1, 2), k, v, attn_mask=seen), 50, graph=True)
    bnd, by = bound_ms(kv_bytes + 2 * args[0].numel() * 4 + SPEC_ROWS * n,
                       4 * int(dmask.sum()) * h * d, H100_F32_PEAK)
    k4 = {f"f32_draft_step_b{SPEC_ROWS}_T{T}": dict(
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd, bound_by=by, max_abs_err=err)}
    log(f"K4 f32 draft step (b {SPEC_ROWS}, kv_len {n} of {T}): kernel {ms:.4f} ms (graph; "
        f"{100 * bnd / ms:.1f}% of the bound), plain {plain_ms:.3f} ms, SDPA fp32 {lib_ms:.4f} ms "
        f"(graph), bound {bnd:.4f} ms ({by}) [{card()}]")
    del m32, q, k, v, out, lse, ref, ref_lse, args, got, seen, bias
    torch.cuda.empty_cache()
    return paths, k1, k4


# scripts/run_spec_natural.sh's path on the port (phase_spec_cli): the
# training CLI (`lwm_tpu_torch.train.main`, in-process) at the bundle's
# --dtype=fp32 with its TARGET_CFG and DRAFT_CFG (copied below), the BPE
# fixture tokenizer and its `[question],answer,[postpad]` fields joined by
# an empty separator, over a copy-task JSONL the phase writes ("{span}
# REPEAT: " then the span, then filler): the target's copy run (seq 512 x
# 64) for SPEC_CLI_STEPS steps, its second run warm-started from the first
# one's last params with `params::` (seq 2048 x 16), the draft's copy run;
# each with exact fp32 launch counts (remat nothing_saveable: K1 twice a
# layer a step, the backward once). Then both saved param streams are
# loaded at fp32, and speculative_generate and prompt_lookup_generate run
# over them on copy prompts: greedy tokens equal to generate's (or first
# apart at a near tie), rounds and acceptance a correct runner's
# (_acceptance_hold)
SPEC_TARGET_CFG = ("dict(vocab_size=2048,hidden_size=768,intermediate_size=2048,"
                   "num_hidden_layers=6,num_attention_heads=6,max_sequence_length=2048,"
                   "scan_attention=True,scan_query_chunk_size=256,scan_key_chunk_size=256,"
                   "scan_mlp=False,scan_layers=True,param_scan_axis=0,"
                   "remat_block='nothing_saveable',theta=10000)")
SPEC_DRAFT_CFG = ("dict(vocab_size=2048,hidden_size=256,intermediate_size=768,"
                  "num_hidden_layers=2,num_attention_heads=2,max_sequence_length=2048,"
                  "scan_attention=True,scan_query_chunk_size=256,scan_key_chunk_size=256,"
                  "scan_mlp=False,scan_layers=True,param_scan_axis=0,"
                  "remat_block='nothing_saveable',theta=10000)")
SPEC_CLI_STEPS, SPEC_CLI_LINES, SPEC_CLI_NEW = 4, 3000, 64


def spec_cli_argv(out_dir, name, cfg, data, seq, batch, *extra):
    """The bundle's `train` function's flags (run_spec_natural.sh:79-99)."""
    return [
        "--mesh_dim=1,1,1,1", "--dtype=fp32", f"--total_steps={SPEC_CLI_STEPS}", "--log_freq=1",
        f"--save_model_freq={SPEC_CLI_STEPS}", f"--update_llama_config={cfg}",
        f"--tokenizer={FIXTURE_TOKENIZER}", "--train_dataset.type=json",
        "--train_dataset.text_processor.fields=[question],answer,[postpad]",
        "--train_dataset.text_processor.subfield_separator=",
        f"--train_dataset.json_dataset.path={data}",
        f"--train_dataset.json_dataset.seq_length={seq}",
        f"--train_dataset.json_dataset.batch_size={batch}",
        "--optimizer.adamw_optimizer.lr=1e-3", "--optimizer.adamw_optimizer.end_lr=3e-4",
        "--optimizer.adamw_optimizer.lr_warmup_steps=100",
        "--optimizer.adamw_optimizer.lr_decay_steps=1500",
        f"--logger.output_dir={out_dir}", f"--logger.experiment_id={name}", *extra,
    ]


def _copy_jsonl(path, n_lines, seed):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n_lines):
            span = _cli_text(rng, int(rng.integers(10, 60)))
            f.write(json.dumps({"question": span + " REPEAT: ", "answer": span,
                                "postpad": " " + _cli_text(rng, int(rng.integers(5, 40)))})
                    + "\n")


def _spec_cfg(cfg_text):
    return eval(cfg_text, {"dict": dict})   # noqa: S307 (the JAX flag's spelling)


def _spec_cli_run(argv, layers, what):
    """One in-process CLI run at fp32 with remat nothing_saveable: K1's and
    the backward's fp32 routes launched exactly 2 x layers x steps and
    layers x steps. Returns (the last saved params stream, launches)."""
    _reset_launch_counts()
    t0 = time.perf_counter()
    summary = train.main(argv)
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    torch.cuda.empty_cache()
    recs = [json.loads(line) for line in open(Path(summary["output_dir"]) / "metrics.jsonl")]
    losses = [r["loss"] for r in recs]
    log(f"spec cli {what}: {len(recs)} steps in {wall:.1f}s of wall, losses "
        f"{[round(x, 4) for x in losses]}; launches {launches}")
    n = layers * SPEC_CLI_STEPS
    want = dict(flash_fwd=2 * n, flash_fwd_f32=2 * n, flash_bwd=n, flash_bwd_f32=n)
    if any(launches[k] != v for k, v in want.items()) or not all(map(math.isfinite, losses)):
        raise AssertionError(f"spec cli {what}: launches {launches} (want {want}), losses {losses}")
    saved = sorted(Path(summary["output_dir"]).glob("streaming_params*"))[-1]
    return saved, launches


def phase_spec_cli():
    """scripts/run_spec_natural.sh's trainer runs and speculative decoding
    over their checkpoints (see SPEC_CLI_*). Returns every run's launch
    counts."""
    paths = []
    with tempfile.TemporaryDirectory(prefix="lwm_spec_") as tmp:
        tmp = Path(tmp)
        data = tmp / "copy.jsonl"
        _copy_jsonl(data, SPEC_CLI_LINES, SEED + 23)
        t_layers = _spec_cfg(SPEC_TARGET_CFG)["num_hidden_layers"]
        d_layers = _spec_cfg(SPEC_DRAFT_CFG)["num_hidden_layers"]
        copy_a, launches = _spec_cli_run(spec_cli_argv(
            tmp / "run_target_copy", "c", SPEC_TARGET_CFG, data, 512, 64), t_layers,
            "target copy")
        paths.append(launches)
        target_ckpt, launches = _spec_cli_run(spec_cli_argv(
            tmp / "run_target", "m", SPEC_TARGET_CFG, data, 2048, 16,
            f"--load_checkpoint=params::{copy_a}"), t_layers, "target warm start (params::)")
        paths.append(launches)
        draft_ckpt, launches = _spec_cli_run(spec_cli_argv(
            tmp / "run_draft_copy", "c", SPEC_DRAFT_CFG, data, 512, 64), d_layers, "draft copy")
        paths.append(launches)

        tok = Tokenizer(str(FIXTURE_TOKENIZER))
        models = []
        for cfg_text, ckpt in ((SPEC_TARGET_CFG, target_ckpt), (SPEC_DRAFT_CFG, draft_ckpt)):
            cfg = train.build_model_config(update_llama_config=_spec_cfg(cfg_text))
            models.append(sampler_module.load_model(cfg, f"params::{ckpt}", "fp32", "cuda")[0])
    target, draft = models
    rng = np.random.default_rng(SEED + 24)
    rows = [tok.encode(_cli_text(rng, 40) + " REPEAT: ") for _ in range(SPEC_ROWS)]
    width = min(len(r) for r in rows)
    ids = torch.tensor([r[:width] for r in rows], device="cuda")
    gcfg = generation.GenerationConfig(max_new_tokens=SPEC_CLI_NEW, pad_token_id=0)
    _reset_launch_counts()
    want = torch.cat([ids, generation.generate(target, ids, config=gcfg)], 1)
    paths.append(_launch_counts())
    for what, run, by in (
            ("draft", lambda: speculative.speculative_generate(target, draft, ids, SPEC_CLI_NEW),
             draft),
            ("lookup", lambda: speculative.prompt_lookup_generate(target, ids, SPEC_CLI_NEW),
             None)):
        _reset_launch_counts()
        res = run()
        paths.append(_launch_counts())
        log(f"spec cli {what} over the saved checkpoints ({SPEC_ROWS} x {width}, "
            f"{SPEC_CLI_NEW} new, k 7): {res.steps} rounds, accepted {res.accepted}; launches "
            f"{paths[-1]}")
        _spec_hold(f"spec cli {what}", res.sequences, want, target, width)
        _acceptance_hold(f"spec cli {what}", res, width, 7, by, 3)
    del target, draft, models
    torch.cuda.empty_cache()
    return paths


# Both eval CLIs (`python -m lwm_tpu_torch.apps.eval_needle` and
# `eval_needle_multi`) at their default fp32, at the 7b width
# and CLI_LAYERS layers over a params stream the port writes, over a
# haystack of _cli_text lines and the fixture tokenizer: contexts 1000 and
# 4000, 2 depths, 1 round (the multi eval: 2 needles, both asked), scan
# chunks NEEDLE_BLOCK. Each runs twice, first as a `python -m` subprocess, then
# through its main in this process: one results row a grid point, and the
# rerun over the file adds none
EVAL_MAINS = {"eval_needle": eval_needle.main, "eval_needle_multi": eval_needle_multi.main}
EVAL_CLI_GRID = ("--context_lengths_min=1000", "--context_lengths_max=4000",
                 "--n_context_length_intervals=2", "--n_document_depth_intervals=2",
                 "--n_rounds=1")


def phase_eval_clis():
    cfg = LLaMAConfig.load_config(CLI_PRESET).replace(num_hidden_layers=CLI_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    model = LLaMAForCausalLM(cfg, dtype=BF16, device="cuda")
    model.init_weights(gen)
    rng = np.random.default_rng(SEED + 18)
    with tempfile.TemporaryDirectory(prefix="lwm_eval_cli_") as tmp:
        tmp = Path(tmp)
        checkpoint.save_tree(flax_params_tree(model.state_dict(), cfg), str(tmp / "params"))
        del model
        torch.cuda.empty_cache()
        (tmp / "haystack.jsonl").write_text("".join(
            json.dumps({"text": _cli_text(rng, 300) + ". "}) + "\n" for _ in range(40)))
        for module, rows, extra in (("eval_needle", 4, ()),
                                    ("eval_needle_multi", 2,
                                     ("--n_needles_total=2", "--n_needles_retrieve=2"))):
            out = tmp / f"{module}.json"
            argv = [*CLI_FLAGS,
                    f"--load_llama_config={CLI_PRESET}",
                    f"--update_llama_config=dict(num_hidden_layers={CLI_LAYERS},"
                    "theta=10000000,max_sequence_length=131072,"
                    f"scan_query_chunk_size={NEEDLE_BLOCK},scan_key_chunk_size={NEEDLE_BLOCK})",
                    f"--tokenizer={FIXTURE_TOKENIZER}",
                    f"--load_checkpoint=params::{tmp / 'params'}",
                    f"--haystack_file={tmp / 'haystack.jsonl'}", f"--output_file={out}",
                    *EVAL_CLI_GRID, *extra]
            first = None
            for run in ("first", "resumed"):
                if run == "first":   # the module entry point; the rerun through its main
                    stdout = run_cli_process(f"lwm_tpu_torch.apps.{module}", argv,
                                             f"{module} {run}").stdout
                else:
                    stdout = run_cli_in_process(EVAL_MAINS[module], argv, f"{module} {run}")[0]
                results = json.loads(out.read_text())
                done = [ln for ln in stdout.splitlines() if ln.startswith("completed")]
                log(f"{module} {run}: {len(results)} results; {done} [{card()}]")
                if len(results) != rows:
                    raise AssertionError(f"{module} {run}: {len(results)} results, want {rows}")
                if first is not None and results != first:
                    raise AssertionError(f"{module}: the resumed run changed the results")
                first = results
            if done != [f"completed {rows}"]:
                raise AssertionError(f"{module}: the resumed run found {done}, want {rows}")


# VQGAN (phase_vqgan): the released architecture (models.vqgan.VQGANConfig's
# defaults: 256 x 256, 146,244,675 params) with random weights from the seed
# in the released layout, its codebook drawn N(0, 1) (a trained codebook's
# spread; the init's ±1/8192 would put every code within fp32 rounding of
# the next), VQ_FRAMES frames of random pixels as one 5-D video encoded and
# decoded on the card at fp32 (TF32 off, `vqgan.full_fp32`), each timed per
# frame; the same calls with TF32 allowed, timed, their codes and pixels
# beside the fp32 ones (what TF32 would change); one frame through the same
# module on the host CPU: its codes equal the card's but where the card's
# top-2 distance gap is below VQ_TIE_GAP (printed), its pixels from the
# card's codes within VQ_PIXEL_TOL of the largest
VQ_FRAMES = 8
VQ_TIE_GAP = 1e-3      # distances ~1e2 apart by ~1e-4 between two fp32 conv paths
VQ_PIXEL_TOL = 1e-4


def _vq_distances(model, z):
    """Distances [n, n_e] float64 of z [..., e_dim] to the codebook."""
    e = model.quantize.embeddings.double()
    flat = z.reshape(-1, z.shape[-1]).double()
    return (flat ** 2).sum(1, keepdim=True) + (e ** 2).sum(1)[None] - 2 * flat @ e.T


def phase_vqgan():
    """See VQ_*. Returns (the model on the card, its times)."""
    cfg = VQGANConfig()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    model = VQGANModel(cfg, device="cuda")
    model.init_weights(gen)
    with torch.no_grad():
        model.quantize.embeddings.normal_(generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    video = torch.rand((1, VQ_FRAMES, cfg.resolution, cfg.resolution, 3), generator=gen,
                       device="cuda") * 2 - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30   # the earlier phases' weights among it
    with torch.no_grad():
        q, codes = model.encode(video)
        pixels = model.decode(codes)
        enc_ms = time_ms(lambda: model.encode(video), 3) / VQ_FRAMES
        dec_ms = time_ms(lambda: model.decode(codes), 3) / VQ_FRAMES
        peak = torch.cuda.max_memory_allocated() / 2**30
        # what TF32 would change: the same modules with cuDNN's default
        flat = video.reshape(-1, *video.shape[2:])
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
            tf32_codes = model.quantize(model._z(flat))[1]
            tf32_pixels = model._pixels(model.quantize.lookup(codes.reshape(-1, 16, 16)))
            enc_tf32 = time_ms(lambda: model.quantize(model._z(flat)), 3) / VQ_FRAMES
            dec_tf32 = time_ms(lambda: model._pixels(model.quantize.lookup(
                codes.reshape(-1, 16, 16))), 3) / VQ_FRAMES
        with full_fp32():
            d = _vq_distances(model, model._z(flat[:1]))
    if q.shape != (1, VQ_FRAMES, 16, 16, 64) or pixels.shape != video.shape:
        raise AssertionError(f"vqgan: shapes {tuple(q.shape)}, {tuple(pixels.shape)}")
    if not (torch.isfinite(pixels).all() and pixels.abs().max() <= 1):
        raise AssertionError("vqgan: decoded pixels not finite in [-1, 1]")
    tf32_apart = int((tf32_codes.reshape(codes.shape) != codes).sum())
    tf32_err = (tf32_pixels.clamp(-1, 1).reshape(pixels.shape) - pixels).abs().max().item()
    log(f"vqgan: {n_params:,} params, {VQ_FRAMES} frames of {cfg.resolution}^2 at fp32 without "
        f"TF32: encode {enc_ms:.2f} ms a frame, decode {dec_ms:.2f} ms a frame, peak "
        f"{peak:.2f} GiB ({peak - held:.2f} over the {held:.2f} held before); with TF32 allowed: encode {enc_tf32:.2f}, decode {dec_tf32:.2f} ms a "
        f"frame, {tf32_apart} of {codes.numel()} codes apart, pixels max|Δ| {tf32_err:.2e} "
        f"[{card()}]")

    # one frame on the host CPU through the same module
    host = VQGANModel(cfg, device="meta")
    host.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, assign=True)
    host.eval()
    t0 = time.perf_counter()
    with torch.no_grad():
        _, host_codes = host.encode(video[0, :1].cpu())
        host_pixels = host.decode(codes[0, :1].cpu())
    host_s = time.perf_counter() - t0
    top2 = d.topk(2, -1, largest=False).values
    gap = (top2[:, 1] - top2[:, 0]).cpu()
    apart = (host_codes.reshape(-1) != codes[0, 0].reshape(-1).cpu())
    near = gap < VQ_TIE_GAP
    pix_err = (host_pixels - pixels[0, :1].cpu()).abs().max().item()
    log(f"vqgan host CPU: one frame encoded and decoded in {host_s:.1f}s; codes apart from the "
        f"card's at {apart.nonzero()[:, 0].tolist()} (near ties, top-2 gap below {VQ_TIE_GAP}: "
        f"{near.nonzero()[:, 0].tolist()}; smallest gap {gap.min().item():.3e}); pixels from "
        f"the card's codes max|Δ| {pix_err:.3e} (tol {VQ_PIXEL_TOL} of the largest)")
    if (apart & ~near).any():
        raise AssertionError("vqgan: host codes differ from the card's away from a near tie")
    if not pix_err <= VQ_PIXEL_TOL * max(pixels.abs().max().item(), 1.0):
        raise AssertionError("vqgan: host pixels disagree with the card's")
    del host, video, q, pixels, tf32_codes, tf32_pixels, flat
    torch.cuda.empty_cache()
    return model, dict(encode_ms=enc_ms, decode_ms=dec_ms, encode_tf32_ms=enc_tf32,
                       decode_tf32_ms=dec_tf32, peak_gib=peak - held)


# Text to image and video (phase_vision_generation): the bundles
# (scripts/run_sample_image_torch.sh, run_sample_video_torch.sh) at the 7b
# width, all 32 layers, fp32, theta 5e7, sample_mode "vision", on the
# serving weights' fp32 copy with vte and vision_head from the seed, through
# apps.vision_generation's VisionGenerator (the fixture tokenizer, VG_PROMPT):
# the image arm (cfg 5.0, top-k 8192, temperature 1.0, 257 tokens), the video
# arm (cfg 1.0, top-k 100) conditioned on the image's frame at VG_FRAMES
# frames; exact K1/K4 fp32 counts (K1 a layer for the prefill, K4 a layer a
# later token), EOF at every 257th, ms a step, tokens/s, peak. The first
# step's guided logits held to an attn_impl="plain" arm at NEEDLE_REL_TOL of
# the largest; a top-k 1 image run's tokens equal to the plain arm's, or
# apart first at a near tie (SPEC_TIE_GAP on the guided logits). The frames
# decoded through phase_vqgan's model to uint8.
VG_PROMPT = "Fireworks over the city"
VG_FRAMES = 3
VG_CONFIG = dict(sample_mode="vision", theta=50_000_000, max_sequence_length=32768,
                 scan_attention=False, scan_query_chunk_size=128, scan_key_chunk_size=128,
                 scan_mlp=False, scan_mlp_chunk_size=8192)


def vision_generation_model(cfg, fp32, attn_impl="auto"):
    """A VideoLLaMA of `cfg` on the fp32 tensors `fp32` (a text model's),
    its vte and vision_head drawn from the seed (cached in `fp32`)."""
    if "vte.weight" not in fp32:
        gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
        for name in ("vte.weight", "vision_head.weight"):
            fp32[name] = torch.randn((cfg.vision_vocab_size, cfg.hidden_size), generator=gen,
                                     device="cuda") * cfg.initializer_range
    return VideoLLaMAForCausalLM.on_tensors(cfg.replace(attn_impl=attn_impl), fp32,
                                            torch.float32)


@contextlib.contextmanager
def timed_forwards(model):
    """Record each forward's synced seconds in the yielded list."""
    seconds = []
    real = model.forward

    def forward(*a, **kw):
        t = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
        return out

    model.forward = forward
    try:
        yield seconds
    finally:
        del model.forward


def _generate_arm(gen, what, prompt, prefix, n_tokens, cfg, top_k, temp=1.0, counted=True):
    """One generate_frames call: (new tokens [n_tokens], forwards' seconds,
    launches or None), exact K1/K4 fp32 counts held when `counted`."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    _reset_launch_counts()
    with timed_forwards(gen.model) as sec:
        tokens = gen.generate_frames([prompt], prefix, n_tokens, cfg, top_k, temp)[0]
    launches = _launch_counts() if counted else None
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = len(sec) - 1
    eos = gen.model.config.eos_token_id
    if steps + 1 < n_tokens and tokens[steps] != eos:
        raise AssertionError(f"{what}: stopped after {steps + 1} tokens without an eos")
    for at in range(TOKENS_PER_FRAME - 1, steps + 1, TOKENS_PER_FRAME):
        if tokens[at] != EOF:
            raise AssertionError(f"{what}: token {at} is {tokens[at]}, not EOF")
    if counted:
        want = _generation_launches(gen.model.config, dict(forwards=len(sec)), f32=True)
        if launches != want:
            raise AssertionError(f"{what}: launches {launches}, want {want}")
    wall = sum(sec)
    log(f"{what}: {steps + 1} tokens (cfg {cfg}, top-k {top_k}) in {wall:.2f}s: prefill "
        f"{sec[0] * 1e3:.1f} ms, {1e3 * sum(sec[1:]) / max(steps, 1):.2f} ms a step, "
        f"{(steps + 1) / wall:.1f} tokens/s, peak {peak:.1f} GiB ({peak - held:.2f} over the "
        f"{held:.1f} held before); launches {launches} "
        f"[{card()}]")
    return tokens, sec, launches


def _guided(model, ids, mask, vm, cfg, prefill=False):
    """The guided logits [b, vocab] of the CFG batch's last position: with
    `prefill`, generate_vision's (the prompt into a fresh shared-index
    cache), else one forward without a cache (positions from the mask, as
    generate's)."""
    with torch.no_grad():
        if prefill:
            kw = model.prepare_inputs_for_generation(ids, ids.shape[1] + TOKENS_PER_FRAME,
                                                     mask, vm)
            lg = model(ids, kw["attention_mask"], kw["position_ids"], kw["cache"],
                       vision_masks=vm, logits_tail=1)
        else:
            lg = model(ids, mask, (mask.cumsum(-1) - 1).clamp_min(0), vision_masks=vm,
                       logits_tail=1)
    cond, uncond = lg[:, -1].float().chunk(2)
    return uncond + cfg * (cond - uncond)


def phase_vision_generation(model, fp32, vq):
    """See VG_*. Returns the launch counts of the counted runs."""
    tok = Tokenizer(str(FIXTURE_TOKENIZER))
    cfg = VideoLLaMAConfig.load_config("7b").replace(
        **VG_CONFIG, bos_token_id=tok.bos_token_id, eos_token_id=tok.eos_token_id)
    vmodel = vision_generation_model(cfg, fp32)
    plain = vision_generation_model(cfg, fp32, "plain")
    gen = vision_app.VisionGenerator(vmodel, tok, VQGAN.from_model(vq), SEED)
    image_prompt = vision_app.image_prompt(VG_PROMPT)
    paths = []
    first, sec, launches = _generate_arm(gen, "vision generation image", image_prompt, None,
                                         TOKENS_PER_FRAME, 5.0, 8192)
    paths.append(launches)
    video_n = (VG_FRAMES - 1) * TOKENS_PER_FRAME
    rest, vsec, launches = _generate_arm(gen, f"vision generation video ({VG_FRAMES} frames)",
                                         vision_app.video_prompt(VG_PROMPT), first[None],
                                         video_n, 1.0, 100)
    paths.append(launches)
    step_s = sum(vsec[1:]) / max(len(vsec) - 1, 1)
    log(f"vision generation video: 8 frames ({7 * TOKENS_PER_FRAME} tokens, 3072 cache slots) "
        f"would take ~{vsec[0] + 7 * TOKENS_PER_FRAME * step_s:.1f}s at this run's "
        f"{1e3 * step_s:.2f} ms a step (steps lengthen with the cache)")

    # the first step's guided logits, kernel path against the plain arm
    ids, mask, vm = gen.batch([image_prompt])
    got, want = (_guided(m, ids, mask, vm, 5.0, prefill=True) for m in (vmodel, plain))
    rel = ((got - want).abs().max() / want.abs().max()).item()
    log(f"vision generation: first step's guided logits (cfg 5.0), kernel vs plain fp32 "
        f"max|Δ|/max|plain| {rel:.3e} (tol {NEEDLE_REL_TOL}), argmax {got.argmax(-1).tolist()} / "
        f"{want.argmax(-1).tolist()}")
    if not rel <= NEEDLE_REL_TOL:
        raise AssertionError("vision generation: guided logits disagree with the plain fp32 path")

    # top-k 1: the kernel path's tokens against the plain arm's
    greedy, _, launches = _generate_arm(gen, "vision generation image top-k 1", image_prompt,
                                        None, TOKENS_PER_FRAME, 5.0, 1)
    paths.append(launches)
    plain_gen = vision_app.VisionGenerator(plain, tok, gen.vqgan, SEED)
    want_tokens = _generate_arm(plain_gen, "vision generation image top-k 1, plain arm",
                                image_prompt, None, TOKENS_PER_FRAME, 5.0, 1, counted=False)[0]
    apart = np.flatnonzero(greedy != want_tokens)
    if len(apart):
        at = int(apart[0])
        new = torch.tensor(want_tokens[:at], device="cuda")[None].repeat(2, 1)
        lg = _guided(plain, torch.cat([ids, new], 1), torch.cat([mask, torch.ones_like(new)], 1),
                     torch.cat([vm, torch.ones(new.shape, dtype=torch.bool, device="cuda")], 1),
                     5.0)
        top = lg.topk(2, -1).values[0]
        gap = (top[0] - top[1]).item()
        log(f"vision generation top-k 1: tokens apart from the plain arm's first at {at}; "
            f"top-2 guided gap there {gap:.2e} (near tie below {SPEC_TIE_GAP})")
        if not gap < SPEC_TIE_GAP:
            raise AssertionError("vision generation: top-k 1 tokens differ off a near tie")
    else:
        log(f"vision generation top-k 1: all {len(greedy)} tokens equal the plain arm's")
    del plain, plain_gen

    # the frames through VQGAN's decoder
    codes = np.concatenate([first[None], rest.reshape(VG_FRAMES - 1, TOKENS_PER_FRAME)])
    t0 = time.perf_counter()
    frames = gen.decode(codes[:, :-1].reshape(1, VG_FRAMES, 16, 16))
    log(f"vision generation: {VG_FRAMES} frames decoded to uint8 {frames.shape} in "
        f"{time.perf_counter() - t0:.2f}s; pixel mean {frames.mean():.1f}")
    if frames.shape != (1, VG_FRAMES, 256, 256, 3) or frames.dtype != np.uint8:
        raise AssertionError(f"vision generation: frames {frames.shape} {frames.dtype}")
    del gen, vmodel
    for name in ("vte.weight", "vision_head.weight"):
        del fp32[name]
    torch.cuda.empty_cache()
    return paths


# The text-to-image CLI (phase_cli_vision_generation): `python -m
# lwm_tpu_torch.apps.vision_generation` at n_frames 1 over a 7b-width
# VideoLLaMA of CLI_LAYERS layers and a VQGAN pickle, both written by the
# port (the pickle from phase_vqgan's model), the bundle's image flags; then
# the same flags through its main in this process: the same PNG, pixel for
# pixel (read back with utils.image.read_png), and exact K1/K4 fp32 counts.
def phase_cli_vision_generation(vq):
    cfg = VideoLLaMAConfig.load_config(CLI_PRESET).replace(num_hidden_layers=CLI_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 32)
    model = VideoLLaMAForCausalLM(cfg, dtype=BF16, device="cuda")
    model.init_weights(gen)
    with tempfile.TemporaryDirectory(prefix="lwm_vision_generation_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        checkpoint.save_tree(flax_params_tree(model.state_dict(), cfg), str(tmp / "params"))
        del model
        save_vqgan_pickle(vq.state_dict(), tmp / "vqgan.pkl")
        torch.cuda.empty_cache()
        log(f"cli vision generation: a {CLI_PRESET}-width {CLI_LAYERS}-layer VideoLLaMA stream "
            f"and the VQGAN pickle ({(tmp / 'vqgan.pkl').stat().st_size / 1e6:.0f} MB) saved in "
            f"{time.perf_counter() - t0:.1f}s")
        base = [*CLI_FLAGS, f"--prompt={VG_PROMPT}", "--n_frames=1", f"--seed={SEED}",
                f"--load_llama_config={CLI_PRESET}",
                "--update_llama_config=dict(num_hidden_layers="
                f"{CLI_LAYERS},sample_mode='vision',theta=50000000,max_sequence_length=32768,"
                "scan_attention=False,scan_mlp=False)",
                f"--tokenizer={FIXTURE_TOKENIZER}", f"--vqgan_checkpoint={tmp / 'vqgan.pkl'}",
                f"--load_checkpoint=params::{tmp / 'params'}", "--cfg_scale_image=5.0",
                "--top_k_image=8192", "--temperature_image=1.0"]
        run_cli_process("lwm_tpu_torch.apps.vision_generation",
                        base + [f"--output_file={tmp / 'sub.png'}"], "cli vision generation")
        forwards = []
        real = VideoLLaMAForCausalLM.forward
        VideoLLaMAForCausalLM.forward = lambda *a, **kw: (forwards.append(1), real(*a, **kw))[1]
        try:
            _reset_launch_counts()
            run_cli_in_process(vision_app.main, base + [f"--output_file={tmp / 'main.png'}"],
                               "cli vision generation")
            launches = _launch_counts()
        finally:
            VideoLLaMAForCausalLM.forward = real
        sub, main_png = read_png(tmp / "sub.png"), read_png(tmp / "main.png")
    want = _generation_launches(cfg, dict(forwards=len(forwards)), f32=True)
    log(f"cli vision generation: PNG {sub.shape}, {len(forwards)} tokens; the subprocess's and "
        f"the in-process run's pixels equal: {np.array_equal(sub, main_png)}; launches "
        f"{launches}")
    if sub.shape != (256, 256, 3) or launches != want:
        raise AssertionError(f"cli vision generation: PNG {sub.shape}, launches {launches} "
                             f"(want {want})")
    if not np.array_equal(sub, main_png):
        raise AssertionError("cli vision generation: the subprocess's PNG differs from the same "
                             "flags' in-process run")
    return [launches]


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
F32_WRAPPERS = ("flash_fwd", "flash_bwd", "flash_decode")   # fp32 routes, counted apart


def _launch_counts():
    """Each wrapper's launches, and apart K5's and K6's admission-GEMM
    launches (as `<name>_gemm`) and K1's and K4's fp32-route launches (as
    `<name>_f32`), which their totals include."""
    counts = {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}
    for name in GEMM_WRAPPERS:
        counts[name + "_gemm"] = KERNEL_WRAPPERS[name].gemm_launches
    for name in F32_WRAPPERS:
        counts[name + "_f32"] = KERNEL_WRAPPERS[name].f32_launches
    return counts


def _reset_launch_counts():
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
    for name in GEMM_WRAPPERS:
        KERNEL_WRAPPERS[name].gemm_launches = 0
    for name in F32_WRAPPERS:
        KERNEL_WRAPPERS[name].f32_launches = 0


def _vision_batch(b, s, seed):
    """`_lm_batch` with a span of VQ codes in each row (a quarter to three
    quarters of it: vision inputs and targets, read through vte and the
    vision head) and its vision masks."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, 32000, (b, s + 1))
    vision = np.zeros((b, s + 1), bool)
    vision[:, s // 4:3 * s // 4] = True
    toks[vision] = rng.integers(0, 8192, int(vision.sum()))
    on = lambda x: torch.from_numpy(x).cuda()  # noqa: E731
    return dict(input_tokens=on(toks[:, :-1]), target_tokens=on(toks[:, 1:]),
                loss_masks=torch.ones((b, s), device="cuda"),
                input_vision_masks=on(vision[:, :-1]), target_vision_masks=on(vision[:, 1:]))


# The kernel path at fp32 compute (K1's and the backward's fp32 routes) vs
# the plain fp32 path on the same weights and batch (phase_train_compare's
# fourth arm): the loss within F32_LOSS_RTOL relative, every parameter's
# grad within F32_GRAD_REL_TOL of its largest |element| (the fp32 suite's
# 1e-5; the two paths sum attention in other orders, and the backward's dq
# across key tiles by atomics)
F32_LOSS_RTOL = 1e-6
F32_GRAD_REL_TOL = 1e-5


def phase_train_compare(vision=False):
    """One train step's loss and grads at 7b width (2 layers, seq 4096):
    the kernel path vs attn_impl="plain" on the same fp32 weights (both
    computing in bf16), each held to an fp32 copy; and the kernel path at
    fp32 compute held to that fp32 copy (F32_*). With `vision`, a
    VideoLLaMA's step (the dual loss over a batch whose middle half is VQ
    codes)."""
    config_cls, model_cls = (VideoLLaMAConfig, VideoLLaMAForCausalLM) if vision else (
        LLaMAConfig, LLaMAForCausalLM)
    cfg = train.build_model_config("7b", update_llama_config=dict(num_hidden_layers=2),
                                   config_cls=config_cls)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    kernel = model_cls(cfg, dtype=BF16, param_dtype=torch.float32, device="cuda")
    kernel.init_weights(gen)
    batch = _vision_batch(1, 4096, SEED + 1) if vision else _lm_batch(1, 4096, cfg.vocab_size,
                                                                      SEED + 1)
    what = "train compare" + (" vision" if vision else "")
    results = {}
    for name, impl, dtype in [("kernel", "auto", BF16), ("plain", "plain", BF16),
                              ("fp32", "plain", torch.float32),
                              ("kernel_f32", "auto", torch.float32)]:
        if name == "kernel":
            model = kernel
        else:
            model = model_cls(cfg.replace(attn_impl=impl), dtype=dtype,
                              param_dtype=torch.float32, device="cuda")
            model.load_state_dict(kernel.state_dict())
        _reset_launch_counts()
        t0 = time.perf_counter()
        loss, aux = train.compute_loss(model, batch)
        loss.backward()
        torch.cuda.synchronize()
        grads = {n: p.grad for n, p in model.named_parameters()}
        results[name] = (loss.item(), grads, time.perf_counter() - t0, _launch_counts(),
                         {k: round(v.item(), 6) for k, v in aux.items()})
        if name != "kernel":
            del model
    (l_k, g_k, t_k, n_k, a_k), (l_p, g_p, t_p, _, a_p), (l_32, g_32, t_32, _, a_32) = (
        results[n] for n in ("kernel", "plain", "fp32"))
    l_k32, g_k32, t_k32, n_k32, a_k32 = results["kernel_f32"]
    log(f"{what} (7b width, 2 layers, 1 x 4096): loss kernel {l_k:.6f} plain {l_p:.6f} "
        f"fp32 {l_32:.6f} (|kernel - plain| tol {LOSS_TOL}); fwd+bwd s (one unwarmed call each) "
        f"kernel {t_k:.2f} plain {t_p:.2f} fp32 {t_32:.2f}; kernel-path launches {n_k}"
        + (f"; metrics kernel {a_k} plain {a_p} fp32 {a_32}" if vision else ""))
    if not (math.isfinite(l_k) and abs(l_k - l_p) <= LOSS_TOL):
        raise AssertionError(f"{what}: kernel-path loss disagrees with the plain path")
    if min(n_k[k] for k in ("flash_fwd", "flash_bwd")) <= 0:
        raise AssertionError(f"{what}: a training kernel never launched: {n_k}")
    worst = (0.0, "")
    for n in g_k:
        c_k32, c_p32 = _cosine(g_k[n], g_32[n]), _cosine(g_p[n], g_32[n])
        ratio = (1 - c_k32) / max(1 - c_p32, 1e-12)
        worst = max(worst, (ratio, f"{n}: cosine to fp32 kernel {c_k32:.6f} plain {c_p32:.6f}"))
        if not 1 - c_k32 <= FLOOR_RATIO * (1 - c_p32) + GRAD_COS_SLACK:
            raise AssertionError(f"{what}: kernel-path grad of {n} is off the bf16 noise floor: "
                                 f"cosine to fp32 {c_k32:.6f} vs plain {c_p32:.6f}")
    log(f"{what}: every grad within {FLOOR_RATIO}x the plain path's distance to fp32 "
        f"(+{GRAD_COS_SLACK}); largest ratio {worst[0]:.3f} ({worst[1]})")

    # the fp32 kernel arm: one backward launch a layer on the fp32 route
    loss_rel = abs(l_k32 - l_32) / abs(l_32)
    layers = cfg.num_hidden_layers
    worst = max((((g_k32[n] - g_32[n]).abs().max() / g_32[n].abs().max().clamp_min(1e-30)).item(),
                 n) for n in g_32)
    log(f"{what} fp32 kernel arm: loss {l_k32:.8f} vs plain fp32 {l_32:.8f} (relative "
        f"{loss_rel:.3e}, tol {F32_LOSS_RTOL}); largest grad max|Δ|/max|plain fp32| "
        f"{worst[0]:.3e} ({worst[1]}; tol {F32_GRAD_REL_TOL}); fwd+bwd {t_k32:.2f}s (unwarmed); "
        f"launches {n_k32}" + (f"; metrics {a_k32}" if vision else ""))
    if not (math.isfinite(l_k32) and loss_rel <= F32_LOSS_RTOL):
        raise AssertionError(f"{what}: the fp32 kernel path's loss disagrees with plain fp32")
    if not worst[0] <= F32_GRAD_REL_TOL:
        raise AssertionError(f"{what}: the fp32 kernel path's grad of {worst[1]} disagrees with "
                             f"plain fp32")
    if n_k32["flash_bwd_f32"] != layers or n_k32["flash_bwd"] != layers or min(
            n_k32["flash_fwd_f32"], n_k32["flash_fwd"]) < layers:
        raise AssertionError(f"{what}: the fp32 kernel path's launches {n_k32}, want the fp32 "
                             f"backward {layers} times and K1's fp32 route at least as often")
    del results, g_k, g_p, g_32, g_k32, kernel
    torch.cuda.empty_cache()


def train_flops(cfg, b, s):
    """Model FLOPs of one step (no recompute): 6 x dense params x tokens
    (both heads of a VideoLLaMA: its vision head too), plus causal
    attention's 3 x 2 x 2 x b x s^2/2 x hidden per layer."""
    h, f, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    kv = cfg.kv_heads * cfg.head_dim
    dense = L * (2 * h * h + 2 * h * kv + 3 * h * f) + h * cfg.vocab_size
    dense += h * getattr(cfg, "vision_vocab_size", 0)
    return 6 * dense * b * s + L * 6 * b * s * s * h


def phase_train_full(profile=None, dtype=BF16):
    """The 7b width at 16 of its 32 layers, 6 AdamW steps computing in
    `dtype` (bf16; fp32 for phase_train_f32: K1's and the backward's fp32
    routes, each launched exactly layers x steps under save_flash) (then,
    with a `profile` directory, one profiled step). Returns the launch
    counts of the 6-step run and its median step time."""
    layers, b, s, steps = 16, 2, 4096, 6
    f32 = dtype == torch.float32
    what = "train f32" if f32 else "train"
    cfg = train.build_model_config("7b", update_llama_config=dict(num_hidden_layers=layers))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    t0 = time.perf_counter()
    model = LLaMAForCausalLM(cfg, dtype=dtype, param_dtype=torch.float32, device="cuda")
    model.init_weights(gen)
    # scripts/run_train_text.sh:29-35, with init_lr > 0 so that step 1 moves
    state = train.create_train_state(model, dict(adamw_optimizer=dict(
        weight_decay=0.1, lr=8e-5, end_lr=8e-5, lr_warmup_steps=5, lr_decay_steps=200,
        init_lr=8e-6)))
    batch = _lm_batch(b, s, cfg.vocab_size, SEED + 2)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    log(f"{what}: 7b width x {layers} layers ({n_params / 1e9:.2f}B params, fp32 master "
        f"weights, {'fp32' if f32 else 'bf16'} compute, remat {cfg.remat_block}), batch {b} x "
        f"{s}, built in {time.perf_counter() - t0:.1f}s")
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    losses, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        m = train.train_step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(m["loss"].item())
        log(f"{what} step {i + 1}: loss {losses[-1]:.5f} acc {m['acc'].item():.5f} "
            f"lr {m['learning_rate'].item():.3e} grad_norm {m['gradient_norm'].item():.4f} "
            f"param_norm {m['param_norm'].item():.2f} time {times[-1]:.3f}s")
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_s = float(np.median(times[1:]))
    flops = train_flops(cfg, b, s)
    peak_rate, peak_name = (H100_F32_PEAK, "67 TFLOP/s fp32") if f32 else (
        H100_BF16_PEAK, "989 TFLOP/s")
    log(f"{what}: {steps} steps, launches {launches}; step time median of steps 2-{steps} "
        f"{step_s:.3f}s, {b * s / step_s:.0f} tokens/s, model FLOPs {flops / 1e12:.1f} T/step "
        f"= {flops / step_s / 1e12:.1f} TFLOP/s = {100 * flops / step_s / peak_rate:.1f}% "
        f"of {peak_name}; peak memory {peak:.1f} GiB [{card()}]")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: training loss not finite and falling: {losses}")
    for k in ("flash_fwd", "flash_bwd") + (("flash_fwd_f32", "flash_bwd_f32") if f32 else ()):
        if launches[k] != layers * steps:
            raise AssertionError(f"{what}: {k} launched {launches[k]} times, want "
                                 f"{layers * steps}")
    if profile:
        profile_step(state, batch, profile)
    return launches, step_s


def phase_train_f32():
    """phase_train_full at fp32 compute (the trainers' default --dtype):
    the 7b width at 16 layers, 2 x 4096, 6 steps on K1's and the backward's
    fp32 routes. Returns the launch counts."""
    return phase_train_full(dtype=torch.float32)[0]


# The 32K stage of scripts/run_context_extension.sh (ext32k: its BASE_CFG at
# max_sequence_length 32768, theta 2e6, scan chunks 1024, one row,
# --dtype=fp32, remat nothing_saveable; its AdamW schedule): CTX32K_STEPS
# train steps on random tokens, the median of steps 2 on beside the
# backward's fp32 route's share (one launch a layer a step, at its time at
# BWD_F32_32K, the same attention)
CTX32K_CFG = dict(
    vocab_size=2048, hidden_size=768, intermediate_size=2048, num_hidden_layers=6,
    num_attention_heads=6, scan_attention=True, scan_mlp=False, scan_layers=True,
    param_scan_axis=0, remat_block="nothing_saveable", max_sequence_length=32768,
    theta=2000000, scan_query_chunk_size=1024, scan_key_chunk_size=1024)
CTX32K_STEPS = 4


def phase_train_ctx32k(bwd_ms):
    """CTX32K_STEPS train steps of the context-extension bundle's 32K stage
    (above); `bwd_ms` is the backward's fp32 route at BWD_F32_32K. K1's and
    the backward's fp32 routes launch exactly 2 x layers x steps (remat runs
    the forward again) and layers x steps. Returns the launch counts."""
    cfg = train.build_model_config(update_llama_config=CTX32K_CFG)
    layers, b, s = cfg.num_hidden_layers, 1, cfg.max_sequence_length
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    model = LLaMAForCausalLM(cfg, dtype=torch.float32, param_dtype=torch.float32, device="cuda")
    model.init_weights(gen)
    state = train.create_train_state(model, dict(adamw_optimizer=dict(
        lr=3e-4, end_lr=1e-4, lr_warmup_steps=100, lr_decay_steps=500)))
    batch = _lm_batch(b, s, cfg.vocab_size, SEED + 9)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    losses, times = [], []
    for _ in range(CTX32K_STEPS):
        t0 = time.perf_counter()
        m = train.train_step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(m["loss"].item())
    launches = _launch_counts()
    step_s = float(np.median(times[1:]))
    attn_s = layers * bwd_ms / 1e3
    log(f"train ctx32k (run_context_extension.sh's 32K stage: hidden {cfg.hidden_size}, "
        f"{layers} layers, "
        f"{cfg.num_attention_heads} heads, 1 x {s}, fp32, remat {cfg.remat_block}): steps "
        f"{', '.join(f'{t:.3f}' for t in times)} s, median of steps 2-{CTX32K_STEPS} "
        f"{step_s:.3f} s, {b * s / step_s:.0f} tokens/s; the backward's fp32 route {layers} x "
        f"{bwd_ms:.3f} ms = {attn_s:.3f} s ({100 * attn_s / step_s:.1f}% of the step); "
        f"losses {[round(x, 4) for x in losses]}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; launches {launches} [{card()}]")
    n = layers * CTX32K_STEPS
    if not all(map(math.isfinite, losses)) or launches["flash_bwd_f32"] != n or launches[
            "flash_fwd_f32"] != 2 * n:
        raise AssertionError(f"train ctx32k: losses {losses}, launches {launches} (want "
                             f"flash_fwd_f32 {2 * n}, flash_bwd_f32 {n})")
    del model, state, batch
    return launches


# The training CLI on the card (phase_train_cli): `lwm_tpu_torch.train.main`
# in-process over a JSONL of random words made from the seed (so that the
# tokenizer's word cache cannot serve them) and the fixture tokenizer, with
# scripts/run_train_text.sh's optimizer flags (init_lr > 0 so that step 1
# moves): the 7b width at TRAIN_CLI_LAYERS layers for TRAIN_CLI_STEPS steps
# with a pool of TRAIN_CLI_POOL tokenizer processes, then
# TRAIN_CLI_FUSED_STEPS with --fused_lm_loss from the same seed; then the
# checkpoint round trip at ROUNDTRIP_LAYERS (A: 2 steps and a save, B: the
# autoresume to 4, C: 0 to 4 uninterrupted), one example a row (`pad`) so
# that a resume sees the uninterrupted run's batches.
TRAIN_CLI_PRESET, TRAIN_CLI_LAYERS, TRAIN_CLI_SEQ, TRAIN_CLI_BATCH = "7b", 16, 4096, 2
TRAIN_CLI_STEPS, TRAIN_CLI_FUSED_STEPS, ROUNDTRIP_LAYERS, TRAIN_CLI_POOL = 6, 2, 1, 4
TRAIN_CLI_WORDS, ROUNDTRIP_WORDS = 100, 1200   # a line: ~590 / ~7200 fixture tokens
TRAIN_CLI_LINES, PIPELINE_BATCHES = 1200, 48   # batches timed after the first, the pipeline alone
# The fused loss's head computes its logits in fp32, the default path's in
# bf16 over the same bf16 body, so the two step-1 losses differ by that
# rounding alone (1.7e-5 and 1.8e-4 on an H100 80GB HBM3 at 700 W, PERF.md),
# and the fused loss may sit further from fp32 than the default's by as much
# where the default's rounding cancels part of the body's error (1.48x the
# floor in one run): step 1 is held at FLOOR_RATIO x floor + this. Step 2
# follows a backward, whose dq atomics move two runs of one step apart by
# more than that floor (default step 2 spread 2.5e-4 over three runs, fused
# 7.5e-4): its loss and step 1's gradient_norm (Adam's update is blind to a
# gradient's scale) are held to the default run's at ROUNDTRIP_RTOL
FUSED_SLACK = 4e-4
# B's steps 3-4 against C's, relative; learning_rate and dataset_* are held
# exactly. The fused backward's dq atomics make no step bit-exact. Sound
# runs read at most loss 4.4e-5 and gradient_norm 8.4e-4 (and loss 7.1e-5
# on another corpus), param_norm 0 (its fp32 resolution is ~6e-8); resumes
# with AdamW's moments zeroed or its count reset read loss 0.20-0.27,
# gradient_norm 0.17-0.52, param_norm 4.5e-6-1.5e-5 (same card, PERF.md)
ROUNDTRIP_RTOL = dict(loss=2e-4, gradient_norm=3e-3, param_norm=1e-6)
TRAIN_CLI_OPT = dict(weight_decay=0.1, lr=8e-5, end_lr=8e-5, lr_warmup_steps=5,
                     lr_decay_steps=200, init_lr=8e-6)
EXACT_DATASET = ("dataset_file_loc", "dataset_example_index", "dataset_total_tokens")


def train_cli_argv(out_dir, name, data, layers, *extra):
    root = Path(__file__).resolve().parent
    return [
        "--dtype=bf16", f"--seed={SEED + 6}",
        f"--load_llama_config={TRAIN_CLI_PRESET}",
        f"--update_llama_config=dict(num_hidden_layers={layers}, "
        f"max_sequence_length={TRAIN_CLI_SEQ})",
        f"--tokenizer={root / 'tests' / 'fixtures' / 'tokenizer'}",
        "--train_dataset.type=json", "--train_dataset.text_processor.fields=text",
        f"--train_dataset.json_dataset.path={data}",
        f"--train_dataset.json_dataset.seq_length={TRAIN_CLI_SEQ}",
        f"--train_dataset.json_dataset.batch_size={TRAIN_CLI_BATCH}",
        "--optimizer.type=adamw", "--optimizer.accumulate_gradient_steps=1",
        *[f"--optimizer.adamw_optimizer.{k}={v}" for k, v in TRAIN_CLI_OPT.items()],
        "--log_freq=1", f"--logger.output_dir={out_dir}", f"--logger.experiment_id={name}",
        "--logger.append_uuid=False", *extra,
    ]


def _train_text(rng, n_words):
    """`n_words` random lowercase words of 2-9 letters: nearly every word
    is new to the tokenizer, so it runs its BPE on each."""
    lens = rng.integers(2, 10, n_words)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)[
        rng.integers(0, 26, int(lens.sum()))].tobytes().decode()
    ends = np.cumsum(lens)
    return " ".join(letters[e - n:e] for e, n in zip(ends, lens))


def _write_jsonl(path, n_lines, n_words, seed):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n_lines):
            f.write(json.dumps({"text": _train_text(rng, n_words)}) + "\n")


def _metrics(summary):
    with open(Path(summary["output_dir"]) / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _run_cli(argv, layers, steps, what):
    """One in-process run of the CLI; its K1 and backward launches must be
    exactly layers x steps. Returns (summary, launch counts)."""
    _reset_launch_counts()
    summary = train.main(argv)
    launches = _launch_counts()
    torch.cuda.empty_cache()
    for k in ("flash_fwd", "flash_bwd"):
        if launches[k] != layers * steps:
            raise AssertionError(f"train cli {what}: {k} launched {launches[k]} times, "
                                 f"want {layers * steps}")
    return summary, launches


def _cli_batches(data, processes=1):
    """The CLI's train batches over `data`, with the phase's pool flags."""
    from lwm_tpu_torch.data import DatasetFactory
    from lwm_tpu_torch.utils.tokenizer import Tokenizer

    tok = Tokenizer(str(Path(__file__).resolve().parent / "tests" / "fixtures" / "tokenizer"))
    return iter(DatasetFactory.load_dataset(dict(
        type="json", text_processor=dict(fields="text"),
        json_dataset=dict(path=str(data), seq_length=TRAIN_CLI_SEQ,
                          batch_size=TRAIN_CLI_BATCH, tokenizer_processes=processes,
                          tokenizer_parallel_batch_size=64, tokenizer_parallel_chunk_size=4)),
        tok, node_info=train.NODE_INFO))


def _first_batch_loss_fp32(cfg, data):
    """The fp32 loss of the CLI's initial weights on its first batch: the
    same init (the CLI's generator from --seed) in an fp32, plain-attention
    model, and the first batch of the same dataset."""
    from lwm_tpu_torch.utils.rng import init_generator

    batches = _cli_batches(data)
    batch = next(batches)[0]
    batches.close()
    model = LLaMAForCausalLM(cfg.replace(attn_impl="plain"), dtype=torch.float32,
                             param_dtype=torch.float32, device="cuda")
    model.init_weights(init_generator(SEED + 6, "cuda"))
    with torch.no_grad():
        loss, _ = train.compute_loss(model, {k: torch.from_numpy(batch[k]).cuda()
                                             for k in train.BATCH_KEYS})
    loss = loss.item()
    del model
    torch.cuda.empty_cache()
    return loss


def _pipeline_tps(data, processes):
    """Tokens/s of the data pipeline alone with `processes` tokenizer
    processes: PIPELINE_BATCHES batches after the first (so the pool's
    start is not timed)."""
    batches = _cli_batches(data, processes)
    next(batches)
    t0 = time.perf_counter()
    for _ in range(PIPELINE_BATCHES):
        next(batches)
    dt = time.perf_counter() - t0
    batches.close()
    return PIPELINE_BATCHES * TRAIN_CLI_BATCH * TRAIN_CLI_SEQ / dt


def train_cli_round_trip(tmp, what="round trip"):
    """The 1-layer fp32 checkpoint round trip of the text CLI in `tmp` (see
    `cli_round_trip`) over ROUNDTRIP_WORDS-word lines, one a row."""
    rt_data = tmp / "long.jsonl"
    _write_jsonl(rt_data, 12, ROUNDTRIP_WORDS, SEED + 7)
    return cli_round_trip(
        lambda name, *extra: train_cli_argv(tmp, name, rt_data, ROUNDTRIP_LAYERS, *extra),
        ["--train_dataset.json_dataset.pad=True"], what)


def _state_leaves(path, leaves):
    """The train state stream's `leaves` (paths under params/params)."""
    params = checkpoint.load_stream(path, remove_prefix=("params", "params"))
    return {k: params[k].astype(np.float64) for k in leaves}


def _state_drift(a, b, c, leaves):
    """max over `leaves` of |B's step-4 leaf - C's| / |C's - A's step 2|:
    how far the resumed run ended from the uninterrupted one, against how
    far the uninterrupted one moved in steps 3-4."""
    a2 = _state_leaves(Path(a["output_dir"]) / "streaming_train_state_2", leaves)
    b4 = _state_leaves(Path(b["output_dir"]) / "streaming_train_state_4", leaves)
    c4 = _state_leaves(Path(c["output_dir"]) / "streaming_train_state_4", leaves)
    return max(float(np.linalg.norm(b4[k] - c4[k]) / np.linalg.norm(c4[k] - a2[k]))
               for k in leaves)


def cli_round_trip(argv_of, rt_flags, what, held_leaves=(), rtol=ROUNDTRIP_RTOL):
    """The 1-layer fp32 checkpoint round trip (A: 2 steps and a save, B:
    the autoresume to 4, C: 0 to 4 uninterrupted) of the runs
    `argv_of(experiment name, *flags)` with `rt_flags` (one example a row,
    so that a resume reads the uninterrupted run's batches). Holds B's
    steps 3-4 to C's: dataset_* and learning_rate exactly, the rest within
    `rtol`; with `held_leaves` (param paths), C saves as B does and B's
    last params there are held to C's within rtol["state"] of C's
    movement in steps 3-4 (`_state_drift`). Returns the three runs' launch
    counts and the largest relative differences, read before the check (a
    caller may catch it)."""
    rt = ["--checkpointer.save_optimizer_state=True", "--checkpointer.float_dtype=fp32",
          *rt_flags]
    resume = ["--save_model_freq=2", "--autoresume=True"]
    a, la = _run_cli(argv_of("rt", "--total_steps=2", *rt, *resume), ROUNDTRIP_LAYERS, 2,
                     f"{what} A")
    b, lb = _run_cli(argv_of("rt", "--total_steps=4", *rt, *resume), ROUNDTRIP_LAYERS, 2,
                     f"{what} B")
    saves = resume if held_leaves else ()
    c, lc = _run_cli(argv_of("rt_whole", "--total_steps=4", *rt, *saves), ROUNDTRIP_LAYERS, 4,
                     f"{what} C")
    size = (Path(a["output_dir"]) / "streaming_train_state").stat().st_size / 1e9
    if (b["loaded"], b["start_step"], b["end_step"]) != ("trainstate", 2, 4):
        raise AssertionError(f"train cli {what}: run B did not resume at step 2: {b}")
    got, want = _metrics(b)[2:], _metrics(c)[2:]
    if len(got) != 2 or len(want) != 2:
        raise AssertionError(f"train cli {what}: want steps 3-4 of B and C: {got}, {want}")
    metrics = [k for k in rtol if k != "state"]
    worst = {k: max(abs(g[k] - w[k]) / abs(w[k]) for g, w in zip(got, want)) for k in metrics}
    if held_leaves:
        worst["state"] = _state_drift(a, b, c, held_leaves)
    exact = [(g["step"], k) for g, w in zip(got, want)
             for k in (*EXACT_DATASET, "learning_rate") if g[k] != w[k]]
    log(f"train cli {what} ({TRAIN_CLI_PRESET} width x {ROUNDTRIP_LAYERS} layer, fp32 train "
        f"state {size:.2f} GB): saves A {[round(x, 2) for x in a['save_seconds']]} s, B "
        f"{[round(x, 2) for x in b['save_seconds']]} s; load {b['load_seconds']:.2f} s; B's "
        f"steps 3-4 against C's: differing in {exact or 'none'} of dataset_* and learning_rate; "
        + "; ".join(f"{k} {[g[k] for g in got]} vs {[w[k] for w in want]} (largest relative "
                    f"difference {worst[k]:.2e}, limit {rtol[k]})" for k in metrics)
        + (f"; params {[k[-2] for k in held_leaves]} at step 4: |B - C| / |C - A at step 2| "
           f"{worst['state']:.2e} (limit {rtol['state']})" if held_leaves else "")
        + f" [{card()}]")
    readings = dict(worst, exact=exact)
    if exact:
        raise AssertionError(f"train cli {what}: the resumed steps read other data or another "
                             f"learning rate: {exact}", readings)
    off = [k for k in worst if not worst[k] <= rtol[k]]
    if off:
        raise AssertionError(f"train cli {what}: the resumed run's {off} leave the "
                             "uninterrupted run's", readings)
    return [la, lb, lc], readings


def phase_train_cli(step_s_full):
    """The training CLI as a user runs it (see TRAIN_CLI_*): the 7b width
    for 6 steps (finite, falling loss; exact K1 and backward launches; step
    time, tokens/s, MFU share, peak memory, dataset_average_tps; the data
    pipeline's own rate in one process and in the run's pool, beside the
    step's tokens/s and `step_s_full`, phase_train_full's step), then
    --fused_lm_loss from the same seed and batch (step 1's loss at the bf16
    noise floor of the default run's, measured against an fp32 run of the
    same weights and batch, with FUSED_SLACK; step 1's gradient_norm and
    step 2's loss, which follow the fused backward, at the round trip's
    run-to-run limits of the default run's), then the checkpoint
    round trip at 1 layer (`train_cli_round_trip`). Returns each run's
    launch counts."""
    paths = []
    cfg = train.build_model_config(TRAIN_CLI_PRESET, update_llama_config=dict(
        num_hidden_layers=TRAIN_CLI_LAYERS, max_sequence_length=TRAIN_CLI_SEQ))
    with tempfile.TemporaryDirectory(prefix="lwm_train_cli_") as tmp:
        tmp = Path(tmp)
        data = tmp / "train.jsonl"
        _write_jsonl(data, TRAIN_CLI_LINES, TRAIN_CLI_WORDS, SEED + 6)
        pool = [f"--train_dataset.json_dataset.tokenizer_processes={TRAIN_CLI_POOL}",
                "--train_dataset.json_dataset.tokenizer_parallel_batch_size=64",
                "--train_dataset.json_dataset.tokenizer_parallel_chunk_size=4"]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        summary, launches = _run_cli(
            train_cli_argv(tmp, "full", data, TRAIN_CLI_LAYERS,
                           f"--total_steps={TRAIN_CLI_STEPS}", *pool),
            TRAIN_CLI_LAYERS, TRAIN_CLI_STEPS, "full")
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        paths.append(launches)
        recs = _metrics(summary)
        losses = [r["loss"] for r in recs]
        step_s = float(np.median(np.diff([r["_time"] for r in recs])))
        tokens = TRAIN_CLI_BATCH * TRAIN_CLI_SEQ
        flops = train_flops(cfg, TRAIN_CLI_BATCH, TRAIN_CLI_SEQ)
        for r in recs:
            log(f"train cli step {r['step']}: loss {r['loss']:.5f} acc {r['acc']:.5f} "
                f"lr {r['learning_rate']:.3e} grad_norm {r['gradient_norm']:.4f} "
                f"param_norm {r['param_norm']:.2f} dataset_average_tps "
                f"{r['dataset_average_tps']:.0f} example {r['dataset_example_index']}")
        one, pooled = _pipeline_tps(data, 1), _pipeline_tps(data, TRAIN_CLI_POOL)
        log(f"train cli: {TRAIN_CLI_PRESET} width x {TRAIN_CLI_LAYERS} layers, batch "
            f"{TRAIN_CLI_BATCH} x {TRAIN_CLI_SEQ}, {TRAIN_CLI_STEPS} steps in {wall:.1f}s of wall "
            f"(model build, tokenizer pool start and init included); launches {launches}; step "
            f"time median of steps 2-{TRAIN_CLI_STEPS} {step_s:.3f}s (phase_train_full's "
            f"{step_s_full:.3f}s: {step_s / step_s_full:.3f}x), {tokens / step_s:.0f} tokens/s, "
            f"{100 * flops / step_s / H100_BF16_PEAK:.1f}% of 989 TFLOP/s; peak memory "
            f"{peak:.1f} GiB; dataset_average_tps {recs[-1]['dataset_average_tps']:.0f} (the "
            f"loop's rate, its window from the start) [{card()}]")
        log(f"train cli data: the pipeline alone on random words, batches 2-"
            f"{PIPELINE_BATCHES + 1}: {one:.0f} tokens/s in one tokenizer process "
            f"({one * TRAIN_CLI_POOL:.0f} x {TRAIN_CLI_POOL}), {pooled:.0f} tokens/s in the run's "
            f"pool of {TRAIN_CLI_POOL}: {pooled * step_s / tokens:.2f}x what the step eats "
            f"({tokens / step_s:.0f} tokens/s) [{card()}]")
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            raise AssertionError(f"train cli: loss not finite and falling: {losses}")

        summary_f, launches_f = _run_cli(
            train_cli_argv(tmp, "fused", data, TRAIN_CLI_LAYERS,
                           f"--total_steps={TRAIN_CLI_FUSED_STEPS}", "--fused_lm_loss=True",
                           *pool),
            TRAIN_CLI_LAYERS, TRAIN_CLI_FUSED_STEPS, "fused")
        paths.append(launches_f)
        fused = _metrics(summary_f)
        l_fp32 = _first_batch_loss_fp32(cfg, data)
        floor = abs(losses[0] - l_fp32)
        step2 = abs(fused[1]["loss"] - losses[1]) / losses[1]
        gnorm = abs(fused[0]["gradient_norm"] - recs[0]["gradient_norm"]) / recs[0]["gradient_norm"]
        log(f"train cli fused: step 1 loss fused {fused[0]['loss']:.6f} default {losses[0]:.6f} "
            f"fp32 (plain, same weights and batch) {l_fp32:.6f}: |fused - fp32| "
            f"{abs(fused[0]['loss'] - l_fp32):.2e}, the floor |default - fp32| {floor:.2e} "
            f"({abs(fused[0]['loss'] - l_fp32) / floor:.2f}x; limit {FLOOR_RATIO} x floor + "
            f"{FUSED_SLACK}), |fused - default| {abs(fused[0]['loss'] - losses[0]):.2e}; step 1 "
            f"gradient_norm fused {fused[0]['gradient_norm']:.5f} default "
            f"{recs[0]['gradient_norm']:.5f} ({gnorm:.2e} relative, limit "
            f"{ROUNDTRIP_RTOL['gradient_norm']}); step 2 loss fused {fused[1]['loss']:.6f} "
            f"default {losses[1]:.6f} ({step2:.2e} relative, limit {ROUNDTRIP_RTOL['loss']}); "
            f"launches {launches_f}")
        if not abs(fused[0]["loss"] - l_fp32) <= FLOOR_RATIO * floor + FUSED_SLACK:
            raise AssertionError("train cli: the fused loss is off the bf16 noise floor")
        if not (gnorm <= ROUNDTRIP_RTOL["gradient_norm"] and step2 <= ROUNDTRIP_RTOL["loss"]):
            raise AssertionError("train cli: the fused backward's gradients or step 2 leave the "
                                 "default run's")

        rt_paths, _ = train_cli_round_trip(tmp)
        paths += rt_paths
    torch.cuda.empty_cache()
    return paths


# Vision-text training (phase_train_vision): `lwm_tpu_torch.train.main`
# in-process as scripts/run_train_vision_torch.sh runs it (--modality=
# vision,text, json_vision `no_pad`, one row of VISION_TRAIN_SEQ tokens,
# theta 5e7, the AdamW flags with init_lr > 0 so that step 1 moves) at the
# 7b width and VISION_TRAIN_LAYERS layers, over a JSONL from the seed: each
# line a clip of 8-30 frames of random codes and a caption of random words,
# in the field orders "[caption],vision" (vision targets) and
# "vision,caption" (text targets too). Then --freeze_base (frozen params
# bit-unchanged, vte and vision_head moved), the PaLM optimizer, and the
# round trip at 1 layer under both (`pad` rows).
VISION_TRAIN_LAYERS, VISION_TRAIN_STEPS, VISION_TRAIN_LINES = 16, 6, 64
# the --freeze_base and PaLM runs: 2 steps at 4 layers (at 16 they were
# timed again only; the held behaviour, frozen leaves bit-unchanged and a
# PaLM step, does not depend on the depth)
VISION_SHORT_STEPS, VISION_SHORT_LAYERS = 2, 4
# ROADMAP C5: a --loss_chunk_size of the whole sequence may peak at most this
# far above the default path (where the whole-sequence dual CE peaked 6.2
# GiB above it and once failed to allocate)
C5_PEAK_SLACK_GIB = 1.0
VISION_TRAIN_OPT = dict(lr=8e-5, end_lr=8e-5, lr_warmup_steps=5, lr_decay_steps=200,
                        init_lr=8e-6)
# The vision round trip (--freeze_base, PaLM). Only vte and vision_head
# move, so the logged metrics barely see PaLM's state: resumes with its ema
# dropped, v dropped or count reset moved them past ROUNDTRIP_RTOL in 2 of
# 3 cases, by at most 1.4x. So the round trip also holds those two params
# at step 4 (`_state_drift`, limit "state"): sound resumes read 2.6e-4 and
# 2.8e-3, the broken ones 0.49-0.86 (H100 80GB HBM3, 700 W, PERF.md); the
# limit sits ~18x above the one and ~10x below the other. The
# lr is a tenth of PaLM's default: at the default the fused backward's dq
# atomics, amplified by PaLM's g / sqrt(v), put sound resumes at a drift
# of 4.2e-2 and a loss 1.2e-4 apart (the broken ones 0.49-0.85)
VISION_ROUNDTRIP_LR = 1e-3
VISION_HELD_LEAVES = (("transformer", "vte", "embedding"), ("vision_head", "kernel"))
VISION_ROUNDTRIP_RTOL = dict(ROUNDTRIP_RTOL, state=5e-2)


def _write_vision_jsonl(path, n_lines, seed):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n_lines):
            frames = int(rng.integers(8, 31))
            f.write(json.dumps({
                "vision": rng.integers(0, 8192, frames * 256).tolist(),
                "caption": _train_text(rng, int(rng.integers(20, 80))),
                "fields": ["[caption],vision", "vision,caption"][i % 2]}) + "\n")


def train_vision_argv(out_dir, name, data, layers, *extra):
    root = Path(__file__).resolve().parent
    return [
        "--modality=vision,text", "--dtype=bf16", f"--seed={SEED + 9}",
        f"--load_llama_config={TRAIN_CLI_PRESET}",
        f"--update_llama_config=dict(num_hidden_layers={layers}, "
        f"max_sequence_length={VISION_TRAIN_SEQ}, theta=50000000)",
        f"--tokenizer={root / 'tests' / 'fixtures' / 'tokenizer'}",
        "--train_dataset.type=json_vision",
        "--train_dataset.vision_text_processor.fields_from_example=fields",
        f"--train_dataset.json_vision_dataset.path={data}",
        f"--train_dataset.json_vision_dataset.seq_length={VISION_TRAIN_SEQ}",
        "--train_dataset.json_vision_dataset.batch_size=1",
        "--train_dataset.json_vision_dataset.mode=no_pad",
        "--optimizer.type=adamw",
        *[f"--optimizer.adamw_optimizer.{k}={v}" for k, v in VISION_TRAIN_OPT.items()],
        "--log_freq=1", f"--logger.output_dir={out_dir}", f"--logger.experiment_id={name}",
        "--logger.append_uuid=False", *extra,
    ]


def _frozen_base_held(out_dir):
    """(changed, kept) leaf paths of the params between the run's step-0
    save and its last (both fp32 `streaming_params` streams, read a leaf at
    a time): a leaf is changed unless bit-equal. The streams are removed
    after."""
    (last,) = out_dir.glob("streaming_params_*")
    changed, kept = [], 0
    for (k0, v0), (k1, v1) in itertools.zip_longest(
            checkpoint.iter_stream(out_dir / "streaming_params"), checkpoint.iter_stream(last),
            fillvalue=(None, None)):
        if k0 != k1:
            raise AssertionError(f"train vision freeze_base: the saves hold other leaves: "
                                 f"{k0} and {k1}")
        if np.array_equal(v0, v1):
            kept += 1
        else:
            changed.append("/".join(k0))
    for f in out_dir.glob("streaming_params*"):
        f.unlink()
    return changed, kept


def train_vision_round_trip(tmp, data, what="vision round trip (freeze_base, palm)",
                           lr=VISION_ROUNDTRIP_LR):
    """`cli_round_trip` of the vision CLI at PaLM's `lr` under
    --freeze_base over `data` (`pad` rows) in `tmp`, vte and vision_head
    held at step 4."""
    return cli_round_trip(
        lambda name, *extra: train_vision_argv(tmp, name, data, ROUNDTRIP_LAYERS, *extra),
        ["--train_dataset.json_vision_dataset.mode=pad", "--freeze_base=True",
         "--optimizer.type=palm", f"--optimizer.palm_optimizer.lr={lr}"],
        what, VISION_HELD_LEAVES, VISION_ROUNDTRIP_RTOL)


def _vision_records(summary, what):
    """The run's metrics.jsonl; raises unless loss, vision_loss and
    text_loss are finite."""
    recs = _metrics(summary)
    for r in recs:
        log(f"{what} step {r['step']}: loss {r['loss']:.5f} vision_loss {r['vision_loss']:.5f} "
            f"vision_acc {r['vision_acc']:.5f} text_loss {r['text_loss']:.5f} text_acc "
            f"{r['text_acc']:.5f} lr {r['learning_rate']:.3e} grad_norm "
            f"{r['gradient_norm']:.4f} param_norm {r['param_norm']:.2f} example "
            f"{r['dataset_example_index']}")
    if not all(math.isfinite(r[k]) for r in recs for k in ("loss", "vision_loss", "text_loss")):
        raise AssertionError(f"{what}: a loss is not finite")
    return recs


def phase_train_vision(profile=None):
    """Vision-text training as a user runs it (see VISION_TRAIN_*): 6 AdamW
    steps (finite, falling loss; both halves finite; exact K1 and backward
    launches; step time, tokens/s, MFU share, peak memory), 2 with
    --freeze_base (frozen params bit-unchanged, vte and vision_head moved),
    2 with the PaLM optimizer, the round trip at 1 layer with both, then a
    kernel-vs-plain VideoLLaMA step (`phase_train_compare(vision=True)`);
    with a `profile` directory, one profiled AdamW step of the same model
    on a batch from the seed (after one unprofiled). Returns each CLI run's
    launch counts."""
    layers, paths = VISION_TRAIN_LAYERS, []
    cfg = train.build_model_config(TRAIN_CLI_PRESET, update_llama_config=dict(
        num_hidden_layers=layers, max_sequence_length=VISION_TRAIN_SEQ),
        config_cls=VideoLLaMAConfig)
    with tempfile.TemporaryDirectory(prefix="lwm_train_vision_") as tmp:
        tmp = Path(tmp)
        data = tmp / "vision.jsonl"
        _write_vision_jsonl(data, VISION_TRAIN_LINES, SEED + 9)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        summary, launches = _run_cli(
            train_vision_argv(tmp, "full", data, layers, f"--total_steps={VISION_TRAIN_STEPS}"),
            layers, VISION_TRAIN_STEPS, "vision")
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        paths.append(launches)
        recs = _vision_records(summary, "train vision")
        losses = [r["loss"] for r in recs]
        step_s = float(np.median(np.diff([r["_time"] for r in recs])))
        flops = train_flops(cfg, 1, VISION_TRAIN_SEQ)
        log(f"train vision: {TRAIN_CLI_PRESET} width x {layers} layers (VideoLLaMA, vision "
            f"vocab {cfg.vision_vocab_size}), 1 x {VISION_TRAIN_SEQ} tokens, "
            f"{VISION_TRAIN_STEPS} steps in {wall:.1f}s of wall (model build and init "
            f"included); launches {launches}; step time median of steps 2-{VISION_TRAIN_STEPS} "
            f"{step_s:.3f}s, {VISION_TRAIN_SEQ / step_s:.0f} tokens/s, model FLOPs "
            f"{flops / 1e12:.1f} T/step (both heads) = "
            f"{100 * flops / step_s / H100_BF16_PEAK:.1f}% of 989 TFLOP/s; peak memory "
            f"{peak:.1f} GiB [{card()}]")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"train vision: loss not falling: {losses}")

        # ROADMAP C5: a loss chunk covering the whole sequence takes the
        # dual loss in 2048-row pieces; the same run as the default one
        # (steps, data, seed), so the peaks differ by the loss alone
        torch.cuda.reset_peak_memory_stats()
        c5_summary, c5_launches = _run_cli(
            train_vision_argv(tmp, "loss_chunk_whole", data, layers,
                              f"--total_steps={VISION_TRAIN_STEPS}",
                              f"--loss_chunk_size={VISION_TRAIN_SEQ}"),
            layers, VISION_TRAIN_STEPS, "vision loss_chunk_whole")
        c5_peak = torch.cuda.max_memory_allocated() / 2**30
        paths.append(c5_launches)
        c5_losses = [r["loss"] for r in _vision_records(c5_summary, "train vision loss_chunk_whole")]
        log(f"train vision --loss_chunk_size={VISION_TRAIN_SEQ}: {VISION_TRAIN_STEPS} steps, peak "
            f"memory {c5_peak:.2f} GiB beside the default run's {peak:.2f} GiB (limit +"
            f"{C5_PEAK_SLACK_GIB} GiB); losses a step minus the default's "
            f"{[f'{a - b:+.2e}' for a, b in zip(c5_losses, losses)]} [{card()}]")
        if c5_peak > peak + C5_PEAK_SLACK_GIB:
            raise AssertionError(f"train vision: --loss_chunk_size={VISION_TRAIN_SEQ} peaked at "
                                 f"{c5_peak:.2f} GiB, the default at {peak:.2f} GiB")

        def short_run(name, *flags):
            """A VISION_SHORT_STEPS run: its launches, records, step 2's time
            (the gap between the records) and peak memory."""
            torch.cuda.reset_peak_memory_stats()
            summary, launches = _run_cli(
                train_vision_argv(tmp, name, data, VISION_SHORT_LAYERS,
                                  f"--total_steps={VISION_SHORT_STEPS}", *flags),
                VISION_SHORT_LAYERS, VISION_SHORT_STEPS, f"vision {name}")
            recs = _vision_records(summary, f"train vision {name}")
            step = recs[-1]["_time"] - recs[-2]["_time"]
            log(f"train vision {name} ({VISION_SHORT_LAYERS} layers): step {VISION_SHORT_STEPS} "
                f"{step:.3f}s (the {layers}-layer AdamW run's median {step_s:.3f}s), peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{card()}]")
            paths.append(launches)

        # the params as the CLI saves them at step 0 and after its last
        # step, in fp32 (only the frozen mask's leaves may differ)
        short_run("freeze_base", "--freeze_base=True", "--checkpointer.float_dtype=fp32",
                  f"--save_model_freq={VISION_SHORT_STEPS + 1}")
        t0 = time.perf_counter()
        changed, kept = _frozen_base_held(tmp / "freeze_base")
        trainable = ["transformer/vte/embedding", "vision_head/kernel"]
        log(f"train vision freeze_base: param leaves changed by {VISION_SHORT_STEPS} steps "
            f"between the step-0 and the last save: {changed}; {kept} bit-unchanged (read in "
            f"{time.perf_counter() - t0:.1f}s)")
        if changed != trainable:
            raise AssertionError(f"train vision freeze_base: changed {changed}, want exactly "
                                 f"{trainable}")

        short_run("palm", "--optimizer.type=palm")

        rt_paths, _ = train_vision_round_trip(tmp, data)
        paths += rt_paths
    torch.cuda.empty_cache()
    if profile:
        model = VideoLLaMAForCausalLM(cfg, dtype=BF16, param_dtype=torch.float32, device="cuda")
        model.init_weights(torch.Generator(device="cuda").manual_seed(SEED + 9))
        state = train.create_train_state(model, dict(adamw_optimizer=VISION_TRAIN_OPT))
        batch = _vision_batch(1, VISION_TRAIN_SEQ, SEED + 9)
        train.train_step(state, batch)
        profile_step(state, batch, profile, "train_vision")
        del model, state, batch
        torch.cuda.empty_cache()
    phase_train_compare(vision=True)
    return paths


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


def profile_step(state, batch, out_dir, what="train"):
    """One more train step under torch.profiler: device time by kind, from
    the kernel events only (GPU-side user annotations such as the optimizer
    step span kernels already counted, and are reported apart); the full
    table goes to out_dir/<what>_step_profile.txt."""
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
    log(f"profile: one {what} step {wall_ms:.1f} ms wall (profiled), kernels {busy:.1f} ms: "
        f"device busy {100 * busy / wall_ms:.1f}%, idle {100 - 100 * busy / wall_ms:.1f}% "
        f"[{card()}]")
    for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        log(f"profile:   {kind}: {ms:.1f} ms ({100 * ms / busy:.1f}% of kernel time)")
    for name, ms in sorted(spans.items(), key=lambda kv: -kv[1])[:3]:
        log(f"profile:   span {name}: {ms:.1f} ms on the device")
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    (Path(out_dir) / f"{what}_step_profile.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))


def main():
    args = sys.argv[1:]
    if args and (args[0] != "--profile" or len(args) != 2):
        raise SystemExit("usage: chip_smoke.py [--profile DIR]")
    profile = args[1] if args else None
    t_start = time.perf_counter()

    def mark(what):
        log(f"[{time.perf_counter() - t_start:.0f}s] {what} done")

    phase_env()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    *k1, k1_cases = phase_k1(gen)
    *k4, k4_cases = phase_k4(gen)
    k1_f32, k4_f32, f32_err = phase_f32_kernels(gen)
    bwd = phase_bwd(gen)
    bwd_f32_err, bwd_f32, k1_f32_train = phase_bwd_f32(gen)
    k1_vision, bwd_vision = phase_train_vision_kernels(gen)
    k56, k56_named = phase_k56(gen)
    torch.cuda.empty_cache()
    mark("kernel phases")
    # each main path's counts, set to 0 just before its run and read just after
    path_launches = []
    launches, bf16_summary, model = phase_serve()
    path_launches.append(launches)
    torch.cuda.empty_cache()
    path_launches.extend(phase_serve_prefix(model, bf16_summary))
    path_launches.extend(phase_serve_lookup_chunked(model))
    torch.cuda.empty_cache()
    path_launches.extend(phase_serve_vision(model))
    torch.cuda.empty_cache()
    mark("serving, its modes and video QA")
    fp32 = fp32_weights(model)
    path_launches.append(phase_generate(model, fp32))
    path_launches.append(phase_generate_f32(model, fp32))
    mark("generate")
    spec_paths, k1_spec, k4_spec = phase_speculative(model, fp32)
    path_launches.extend(spec_paths)
    mark("speculative decoding")
    vq, _ = phase_vqgan()
    path_launches.extend(phase_vision_generation(model, fp32, vq))
    mark("VQGAN and vision generation")
    del model, fp32
    torch.cuda.empty_cache()
    path_launches.extend(phase_serve_int8(bf16_summary))
    torch.cuda.empty_cache()
    mark("int8 serving")
    phase_cli()
    phase_cli_vision()
    phase_eval_clis()
    path_launches.extend(phase_cli_vision_generation(vq))
    del vq
    torch.cuda.empty_cache()
    mark("the serving, eval and vision generation CLIs")
    phase_train_compare()
    launches, step_s_full = phase_train_full(profile)
    path_launches.append(launches)
    torch.cuda.empty_cache()
    mark("train compare and the bf16 train step")
    path_launches.append(phase_train_f32())
    torch.cuda.empty_cache()
    path_launches.append(phase_train_ctx32k(bwd_f32[BWD_F32_32K]["ms"]))
    torch.cuda.empty_cache()
    mark("fp32 training")
    path_launches.extend(phase_spec_cli())
    torch.cuda.empty_cache()
    mark("run_spec_natural.sh's path")
    path_launches.extend(phase_train_cli(step_s_full))
    torch.cuda.empty_cache()
    mark("the training CLI")
    path_launches.extend(phase_train_vision(profile))
    mark("vision-text training")
    total = {k: sum(p[k] for p in path_launches) for k in path_launches[0]}

    def row(name, source, replaces, max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by):
        return dict(name=name, route="cuda", source="lwm_tpu_torch/csrc/" + source,
                    replaces=replaces, launches=total[name], max_abs_err=max_abs_err, ms=ms,
                    plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=library_ms)

    def f32_cases(cases, source, name):
        """The fp32 route's cases, each with its source and the route's
        launches on the main paths."""
        return {case: dict(t, source="lwm_tpu_torch/csrc/" + source,
                           f32_launches=total[name + "_f32"],
                           max_abs_err=t.get("max_abs_err", f32_err[name]))
                for case, t in cases.items()}

    kernels = [
        dict(row("flash_fwd", "flash_fwd.cu", "lwm_tpu/ops/pallas_flash.py:199", *k1),
             **k1_cases, **{VISION_TRAIN_REPORT: k1_vision},
             **f32_cases(dict(k1_f32, **{BWD_F32_REPORT: k1_f32_train}, **k1_spec),
                         "flash_fwd_f32.cu", "flash_fwd")),
        dict(row("flash_bwd", "flash_bwd.cu",
                 "lwm_tpu/ops/pallas_flash.py:288 and lwm_tpu/ops/pallas_flash.py:356", *bwd),
             **{VISION_TRAIN_REPORT: bwd_vision}),
        dict(row("flash_bwd_f32", "flash_bwd_f32.cu",
                 "lwm_tpu/ops/pallas_flash.py:288 and lwm_tpu/ops/pallas_flash.py:356",
                 bwd_f32_err, *(bwd_f32[BWD_F32_REPORT][k] for k in (
                     "ms", "plain_ms", "library_ms", "bound_ms", "bound_by"))),
             fma_bound_ms=bwd_f32[BWD_F32_REPORT]["fma_bound_ms"],
             **{name: bwd_f32[name] for name in (BWD_F32_8K, BWD_F32_32K)}),
        dict(row("flash_decode", "flash_decode.cu", "lwm_tpu/ops/pallas_decode.py:66", *k4),
             **k4_cases, **f32_cases(dict(k4_f32, **k4_spec), "flash_decode.cu",
                                     "flash_decode")),
        dict(row("int8_matmul", "int8_matmul.cu", "lwm_tpu/ops/quant.py:107",
                 **k56["int8_matmul"]), **k56_named["int8_matmul"]),
        dict(row("w8a8_matmul", "w8a8_matmul.cu", "lwm_tpu/ops/quant.py:182",
                 **k56["w8a8_matmul"]), **k56_named["w8a8_matmul"]),
    ]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on a main path")
    for name in F32_WRAPPERS:
        if total[name + "_f32"] <= 0:
            raise AssertionError(f"{name}'s fp32 route never launched on a main path")
    log(card())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
