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
     block); every case timed. At the first five, `kv_len` also as an int32
     tensor on the card, a scalar and one a row: held to the twin, the
     scalar's output bit for bit the int's.
     Then K1's and K4's fp32 routes (the needle evals' dtype) at fp32 against
     the same twins within 1e-5 of the twin's largest value: K1 over the
     needle batch's cache (5120 queries over 6144 slots) and its edges, and
     at the 32k needle bundle's prefill (its twin in 1024-query chunks); K4 over the needle
     batch's 4 rows (MHA and GQA) and one row of the bundle's 34816 slots,
     output and partials; and both at vision_generation's CFG pair (K1 its
     image prefill, 128 queries over 385 slots, and the 8-frame video's, 385
     over 3072; K4 a step over each), and at the apps' prefills and last
     steps (vision chat's 2432 queries over 3072 slots; the 32K eval's 31744
     over 32768 at 6 heads; the 128-frame vision-needle eval's 33024 over
     34816 at 6 heads of 64); each timed beside SDPA at fp32 and the fp32
     bound. K1 and the fused backward in bf16 at the vision-needle bundle's
     stage C row (1 x 33024, 6 heads of 64), timed beside SDPA, held to the
     twins at 2 heads.
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
     the twin, K1's fp32 route at the train shape too. Then the ring's blocks
     (phase_ring_kernels): all four routes with pos_stride 2 and segment
     ids of three packed documents, as an sp-2 striped ring step gives them
     (queries at offset 1 over keys at 0, then 0 over 1, whose first row
     sees no key: out 0, lse BIG_NEG, dq 0), bf16 at the 7b width's block
     (1 x 4096, h32) and fp32 at the 32K stage's (1 x 16384, h6, the
     backward held to float64 on 2 heads), timed beside their bounds, twins
     and SDPA with the equivalent bool mask.
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
     (cfg 5, top-k 8192, 257 tokens) and a 2-frame video on it (cfg 1,
     top-k 100), exact K1/K4 fp32 counts, EOF every 257th token, ms a step,
     tokens/s, peak; the first step's guided logits held to the plain fp32
     path at 1e-3 of the largest, a top-k 1 image's tokens to its tokens;
     the frames decoded to uint8 pixels. Then image and video QA
     (phase_vision_chat): scripts/run_vision_chat_torch.sh's path through
     apps.vision_chat.Sampler on the same fp32 VideoLLaMA in sample_mode
     'text': 8 decoded frames through phase_vqgan's model, the bundle's
     2432-token prompt, 128 new tokens at temperature 0.2 (exact K1/K4 fp32
     counts, prefill seconds, ms a step); at top-k 1 the prefill logits and
     the tokens held to the plain fp32 path. Then the VQ tokenizer's trainer
     (phase_train_vqgan): scripts/run_vqgan_128px_torch.sh's flags (128 px,
     batch 16, 1024 codes) through apps.train_vqgan's main over synthetic
     PNGs, 20 steps with two revivals, the round trip's PSNR and usage, ms
     a step, peak; step 1's loss and codes held to the host CPU's.
  8. The same weights quantized on the card (`quantize_params_int8`, the
     run_serve.sh QUANTIZE=1 bundle): serve the 12 requests with
     quant_dense="int8" (K5 for every dense product) and 4 with
     "int8_w8a8" and an int8 cache (K6, K5 for lm_head); exact launch
     counts, K5's and K6's admission GEMMs counted apart; admission logits
     of K5 against the "int8_xla" dequant arm on the same int8 tensors,
     and of both (and W8A8) against an fp32 copy of the dequantized
     weights.
     Then the CLIs, each run through its `main` in this process (its wall
     time split into the params stream's read and the work): the serving CLI (`lwm_tpu_torch.apps.serve`) three times
     over a 7b-width 4-layer params stream written by the port: a prefix
     document, its index saved then loaded (the same completions), lookup
     verify; and with --quantize_weights. The video QA CLI
     (`apps.serve_vision`) three times over a 4-layer VideoLLaMA stream and
     an 8-frame codes file: its video index saved, then loaded (the same
     answers), lookup verify. Both needle eval CLIs (`apps.eval_needle`,
     `eval_needle_multi`) at fp32 over a 7b-width 4-layer stream and a
     generated haystack, contexts 1000-4000 x 2 depths x 1 round, each run
     twice in this process: one results row a grid point, and the rerun
     adds none. The
     text-to-image CLI (`apps.vision_generation`) over a 4-layer VideoLLaMA
     stream and phase_vqgan's model as the released pickle, both written by
     the port, run twice in this process: the same PNG, pixel for pixel, with exact K1/K4 fp32 counts.
  9. Train step at 7b width (2 layers, seq 4096): loss and per-parameter
     grads of the kernel path against an attn_impl="plain" bf16 model and
     an fp32 copy (the noise floor), on the same weights and batch; and the
     kernel path at fp32 compute (K1's and the backward's fp32 routes) held
     to the same step in float64 (f64_step: loss 1e-6 relative, each grad
     1e-5 relative in L2 and of its largest element, or within 1.25x the
     plain fp32 path's own distance where that misses 1e-5).
 10. Train the 7b width at 16 of its 32 layers (fp32 master weights, bf16
     compute, remat save_flash, AdamW as scripts/run_train_text.sh), batch
     2 x 4096, 6 steps on one fixed batch from the seed: finite, falling
     loss, and K1 and the backward launched layers x steps times on that
     path. The same at fp32 compute for 4 steps (phase_train_f32, the
     trainers' default --dtype): K1's and the backward's fp32 routes
     launched exactly layers x steps. Then sequence-parallel training
     (phase_train_ring): two ranks share the card over gloo on a mesh of sp
     2 and train through lwm_tpu_torch.train's step in both layouts: the 7b
     width at 4 layers, bf16, 1 x 8192, 2 steps, the losses held to a
     one-rank run at the bf16 noise floor; the 32K stage's model (6 layers
     of 768, fp32, nothing_saveable) at 1 x 32768, 2 steps, step 1's loss
     and grads held to the float64 step beside a one-rank run's; each
     rank's exact K1/backward counts, step times, the gradients' all-reduce
     and the ring's exchanges timed. In the same two ranks, inference on a
     mesh (phase_serve_mesh): run_serve.sh's pool at tp 2 (bf16, 4 layers)
     held row by row to one device at the bf16 noise floor, an sp 2 slot
     pool (fp32, 16384 slots, a verify block across the shards) held to one
     device in relative L2 and ring_attention_inference alone to K4/K1 over
     the whole cache, eval_needle at !1,-1,2,1 (rank 0 alone writes; its
     answers' token ids against one device's); exact K1/K4 counts a rank,
     the decode rounds and the exchanges timed (host-staged). Then
     run_context_extension_torch.sh's chain
     (phase_context_extension, at its widths: hidden 768, 6 layers, fp32,
     remat nothing_saveable): its data from the port's generators in a host
     process started after the build, 2 steps each of its 512, 2048 and
     8192 stages and 4 of its 32K stage (1 x 32768, timed beside the
     backward's share), each warm-started from the last stage's params::
     milestone, exact fp32 counts, the 2048 stage's first batch held kernel
     vs plain; the 32K stream unscanned by convert_checkpoint (as
     run_needle_validation.sh does) and through an HF directory and back,
     leaf for leaf; eval_needle at 30000 tokens over the unscanned stream
     (exact K1/K4 fp32 counts), summarize_needle, and probe_needle_digits
     (exact K1 fp32 counts; logits and argmaxes held to the plain path).
     Before the chain, scripts/run_vision_needle_torch.sh's path
     (phase_vision_needle: hidden 384, 4 layers, 6 heads of 64; its data
     from the same host process; stages A-E at their shapes and dtypes, 2
     steps each, warm-started through params::; the whole 30-point eval
     grid at fp32 and the summary; one 32-frame prefill held kernel vs
     plain, a point a frame count's answer held to the twins') and
     scripts/run_vision_validation_torch.sh's (phase_vision_validation: the
     pattern data, 4 dual-head steps, the CFG probe on the card over 6 of
     its 12 patterns, one pattern's 257 tokens held to the plain path's).
     Then scripts/run_spec_natural.sh's path
     (phase_spec_cli): the training CLI at fp32 with its target and draft
     configs, BPE fixture tokenizer and `[question],answer,[postpad]`
     fields (the target's copy run, a second run warm-started from it with
     params::, the draft's run; exact fp32 launch counts), then both saved
     streams loaded and decoded by speculative_generate and
     prompt_lookup_generate: greedy tokens equal to generate's.
 11. The training CLI (`lwm_tpu_torch.train.main`, in-process) on a JSONL
     from the seed and the fixture tokenizer: the same width and depth for
     4 steps (finite, falling loss; K1 and the backward launched exactly
     16 x 4 times; step time beside phase 10's, tokens/s, model-FLOPs
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
     row of 32768 tokens (`no_pad`), 3 AdamW steps (finite, falling loss;
     K1 and the backward launched exactly 16 x 3 times; step time,
     tokens/s, model-FLOPs share with both heads, peak memory), 2 with
     --freeze_base at 4 layers (every frozen param bit-unchanged, vte and
     vision_head moved), 2 with the PaLM optimizer at 4 layers, the
     1-layer round trip under both
     (`pad` rows), 2 of the AdamW steps again at --loss_chunk_size=32768,
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

import atexit
import contextlib
import io
import itertools
import json
import math
import re
import shutil
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
from lwm_tpu_torch.apps import (
    convert_checkpoint,
    eval_needle,
    eval_needle_multi,
    eval_vision_needle,
    probe_needle_digits,
    probe_vision_patterns,
    summarize_vision_needle,
    train_vqgan,
    vision_chat,
)
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
from lwm_tpu_torch.utils.convert import (
    convert_flax_params,
    flax_params_tree,
    save_vqgan_pickle,
)
from lwm_tpu_torch.utils.image import read_png, write_png
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
# The 3b preset's products (hidden 3200, intermediate 8640; timed) at a
# decode round and a 2048-token admission: K5 splits f 3200 into 2 (100
# tiles), f 8640 unsplit on a ring of 4; K6 unsplit on 16 stages at f 3200,
# 4 at f 8640; d 8640 ends in the first half of a 128-wide k stage.
QUANT_SHAPES = [
    ("decode_m8_wq_4096x4096", 8, 4096, 4096),
    ("decode_m8_w1_4096x11008", 8, 4096, 11008),
    ("decode_m8_w2_11008x4096", 8, 11008, 4096),
    ("decode_m8_head_4096x32000", 8, 4096, 32000),
    ("decode_m8_1b_wq_2048x2048", 8, 2048, 2048),
    ("decode_m8_1b_w2_5504x2048", 8, 5504, 2048),
    ("decode_m8_3b_wq_3200x3200", 8, 3200, 3200),
    ("decode_m8_3b_w1_3200x8640", 8, 3200, 8640),
    ("decode_m8_3b_w2_8640x3200", 8, 8640, 3200),
    ("decode_m8_3b_head_3200x32000", 8, 3200, 32000),
    ("admit_m2048_3b_w1_3200x8640", 2048, 3200, 8640),
    ("admit_m2048_3b_w2_8640x3200", 2048, 8640, 3200),
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
# w2 for K6; the 3b preset's w1 at both, its w2 for K6
QUANT_REPORT = "decode_m8_w1_4096x11008"
QUANT_DECODE_NAMED = ("decode_m8_wq_4096x4096", "decode_m8_w2_11008x4096",
                      "decode_m8_head_4096x32000")
QUANT_NAMED_REPORTS = {
    "int8_matmul": (*QUANT_DECODE_NAMED, "admit_m2048_w1_4096x11008",
                    "decode_m8_3b_w1_3200x8640", "admit_m2048_3b_w1_3200x8640"),
    "w8a8_matmul": (*QUANT_DECODE_NAMED, "decode_m8_1b_w2_5504x2048",
                    "admit_m2048_w1_4096x11008", "admit_m2048_w2_11008x4096",
                    "decode_m8_3b_w1_3200x8640", "admit_m2048_3b_w1_3200x8640",
                    "admit_m2048_3b_w2_8640x3200"),
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
    mask = torch.where(seen, bias, BIG_NEG).to(q.dtype)
    kt, vt = (k, v) if head_major else (k.transpose(1, 2), v.transpose(1, 2))
    lib_ms = _sdpa_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), kt, vt, attn_mask=mask, enable_gqa=h_kv != h), 20)
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


def _k4_kv_len_forms(name, args):
    """K4 with `kv_len` on the card: a scalar int32 tensor (the same
    launch as the int's, bit for bit) and one a row ([b]: each row's last
    valid key + 1, at most the int), each held to its twin given the same
    tensor. Returns the worst max|Δ| on o."""
    from lwm_tpu_torch.ops.ring import local_kv_len

    q, k, v, mask, kv_len, ks, vs = args
    scalar = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    forms = (("device scalar", scalar),
             (f"[{q.shape[0]}]", torch.minimum(local_kv_len(mask), scalar)))
    base = decode.flash_decode(*args, return_partials=True)
    worst = 0.0
    for form, kl in forms:
        a = (q, k, v, mask, kl, ks, vs)
        worst = max(worst, _k4_check(f"{name} kv_len {form}", a))
        same = all(torch.equal(x, y) for x, y in zip(decode.flash_decode(*a, return_partials=True),
                                                      base))
        log(f"K4 {name} kv_len {form}: bit for bit the int kv_len's output and partials: {same}")
        if form == "device scalar" and not same:
            raise AssertionError(f"K4 {name}: a device-scalar kv_len changed the output")
    return worst


def phase_k4(gen):
    """K4 at K4_CASES and K4_FOLD_CASES against its plain twin (output and
    partials), with a row of no valid key at the 8-slot cases, and at
    K4_CASES with `kv_len` on the card (_k4_kv_len_forms), each case
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
        if case in K4_CASES:
            worst = max(worst, _k4_kv_len_forms(name, args))
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
# the apps' prefills (phase_vision_chat's, phase_context_extension's
# eval_needle, phase_vision_needle's eval at 128 frames)
K1_F32_APPS = ("f32_vision_chat_q2432_T3072", "f32_eval32k_h6_q31744_T32768",
               "f32_vneedle_h6_d64_q33024_T34816")
K1_F32_TIMED = (K1_F32_REPORT, K1_F32_BUNDLE, *K1_F32_CFG, K1_F32_VERIFY, *K1_F32_APPS)
K1_F32_CHUNKED = (K1_F32_BUNDLE, *K1_F32_APPS[1:])   # their twins in F32_TWIN_CHUNK-query calls
# the left padding of each "needle" case: the real keys start here (80
# unless named: the vision chat's 2095 real of 2432, the 32K eval's 30000
# context tokens and scaffold, the 128-frame prompt's 32,944 real)
K1_F32_PAD = {K1_F32_APPS[0]: 337, K1_F32_APPS[1]: 1600}
K1_F32_CASES = [
    # name, b, h, h_kv, d, sq, T, causal, q_offset, kv head-major, kind
    (K1_F32_REPORT, 1, 32, 32, 128, 5120, 6144, True, 0, True, "needle"),
    (K1_F32_BUNDLE, 1, 32, 32, 128, 33792, 34816, True, 0, True, "needle"),
    # vision_generation's prefills (the bundles' CFG batch: the cond row's
    # prompt over the uncond "<s><vision>"'s, left-padded to 128): the image
    # over round_cache_length(128 + 257) slots, the 8-frame video's prompt
    # and first frame over the 3072 slots of 128 + 257 + 7 x 257 tokens
    (K1_F32_CFG[0], 2, 32, 32, 128, 128, 385, True, 0, True, "cfg"),
    (K1_F32_CFG[1], 2, 32, 32, 128, 385, 3072, True, 0, True, "cfg"),
    (K1_F32_VERIFY, 4, 32, 32, 128, 8, 2048, True, 1088, True, "verify"),
    # vision chat's 2432-token prompt over round_cache_length(2432 + 128);
    # eval_needle's 31744-token prompt at 6 heads over its 32768 slots;
    # eval_vision_needle's 128-frame prompt (33024 tokens) at 6 heads of 64
    # over round_cache_length(33024 + 10) = 34816 slots
    (K1_F32_APPS[0], 1, 32, 32, 128, 2432, 3072, True, 0, True, "needle"),
    (K1_F32_APPS[1], 1, 6, 6, 128, 31744, 32768, True, 0, True, "needle"),
    (K1_F32_APPS[2], 1, 6, 6, 64, 33024, 34816, True, 0, True, "needle"),
    ("f32_q16_fulltile", 2, 32, 32, 128, 16, 1024, True, 0, True, "frontier"),
    ("f32_gqa_hkv8_q1000", 1, 32, 8, 128, 1000, 2048, True, 0, True, "needle"),
    ("f32_d64_S1000_offsets", 2, 32, 8, 64, 1000, 1000, True, 700, False, "full"),
    ("f32_noncausal_q300_T1000", 1, 32, 32, 128, 300, 1000, False, 0, True, "needle"),
    ("f32_q300_rows_without_keys", 1, 32, 32, 128, 300, 4096, True, 3000, True, "no_keys"),
]
# K4: name, b, h, h_kv, d, T, kv_len, the rows' first real key (left
# padding). The needle batch's decode over its cache (4 rows, 6144 slots,
# after 1 to 128 steps), GQA, and one row of the 32k bundle's cache (34816
# slots)
K4_F32_CASES = [
    ("f32_needle_b4_T6144", 4, 32, 32, 128, 6144, 5248, [0, 80, 700, 2000]),
    # vision_generation's steps: the CFG pair (CFG_FIRST_KEYS) at the image's
    # last step and at the 8-frame video's
    ("f32_cfg_image_b2_T385", 2, 32, 32, 128, 385, 385, list(CFG_FIRST_KEYS)),
    ("f32_cfg_video_b2_T3072", 2, 32, 32, 128, 3072, 2184, list(CFG_FIRST_KEYS)),
    ("f32_gqa_hkv8_b4_T6144", 4, 32, 8, 128, 6144, 5121, [0, 80, 700, 2000]),
    ("f32_bundle_b1_T34816", 1, 32, 32, 128, 34816, 34816, [300]),
    # the apps' last steps: vision chat's (2432 + 127 keys of 3072), the 32K
    # eval's (31744 + 1023 of 32768, 6 heads), the 128-frame eval's (33024 +
    # 10 of 34816, 6 heads of 64)
    ("f32_vision_chat_b1_T3072", 1, 32, 32, 128, 3072, 2559, [337]),
    ("f32_eval32k_h6_b1_T32768", 1, 6, 6, 128, 32768, 32767, [1600]),
    ("f32_vneedle_h6_d64_b1_T34816", 1, 6, 6, 64, 34816, 33034, [80]),
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
    name, b, h, h_kv, d, sq, T, causal, q_off, head_major, kind = case
    f32 = torch.float32
    q = _randn((b, sq, h, d), gen, f32)
    kv_shape = (b, h_kv, T, d) if head_major else (b, T, h_kv, d)
    k, v = _randn(kv_shape, gen, f32), _randn(kv_shape, gen, f32)
    keys = torch.arange(T, device="cuda")
    if kind == "needle":
        pad = K1_F32_PAD.get(name, 80)
        valid = (keys >= pad) & (keys < q_off + sq) if causal else keys < T - 68
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
    name, b, h, h_kv, d, sq, T, causal, q_off, head_major, kind = case
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
        name, b, h, h_kv, d, sq, T, causal, q_off, head_major, kind = case
        q, k, v, bias, kw, valid = k1_f32_inputs(case, gen)
        n0 = flash.flash_attention_fwd.f32_launches
        out, lse = flash.flash_attention_fwd(q, k, v, bias, **kw)
        torch.cuda.synchronize()
        if flash.flash_attention_fwd.f32_launches != n0 + 1:
            raise AssertionError(f"K1 {name}: the fp32 route was not launched")
        chunk = F32_TWIN_CHUNK if name in K1_F32_CHUNKED else None
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

    for name, b, h, h_kv, d, T, kv_len, firsts in K4_F32_CASES:
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


def _bwd_f64(q, k, v, g, lse, delta, bias, *, causal, q_offset, kv_offset, pos_stride=1,
             q_seg=None, kv_seg=None, chunk=2048):
    """The twin's arithmetic in float64, `chunk` queries at a time: (dq, dk,
    dv) of MHA inputs with a per-key bias (inputs as the twin's; positions
    `pos_stride` apart, segment ids [b, sq] and [b, skv] or None)."""
    b, sq, h, d = q.shape
    if k.shape[2] != h or bias.shape[2] != 1:
        raise ValueError("_bwd_f64 takes MHA inputs and a per-key bias")
    f64, scale = torch.float64, d ** -0.5
    dq, dk, dv = (torch.zeros(x.shape, dtype=f64, device=x.device) for x in (q, k, v))
    keys = kv_offset + pos_stride * torch.arange(k.shape[1], device=q.device)
    for bi, hh in itertools.product(range(b), range(h)):
        kk, vv = k[bi, :, hh].to(f64), v[bi, :, hh].to(f64)
        kb = bias[bi if bias.shape[0] > 1 else 0, 0, 0].to(f64)
        for c0 in range(0, sq, chunk):
            qq, gg = q[bi, c0:c0 + chunk, hh].to(f64), g[bi, c0:c0 + chunk, hh].to(f64)
            x = qq @ kk.T * scale + kb
            if causal:
                pos = q_offset + pos_stride * (c0 + torch.arange(qq.shape[0], device=q.device))
                x = x.masked_fill(keys[None] > pos[:, None], BIG_NEG)
            if q_seg is not None:
                x = x.masked_fill(q_seg[bi, c0:c0 + chunk, None] != kv_seg[bi, None], BIG_NEG)
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


# The ring's blocks (phase_ring_kernels): each route of K1 and the fused
# backward with pos_stride 2 and with segment ids, as an sp-2 striped ring
# step gives them: rank 1 over block 0 (q_offset 1, kv_offset 0: row i sees
# keys j <= i), then rank 0 over block 1 (0, 1: row i sees j <= i - 1, so
# row 0 sees no key and must give out 0, lse BIG_NEG and dq 0), each block
# of RING_DOCS packed documents over the global positions, the model's
# per-key bias of an all-ones mask (0). bf16 at the 7b width's sp-2 block of
# S 8192 (phase_train_ring (a)); fp32 at the context-extension 32K stage's
# sp-2 block (b). Held to the plain twins at the suite's tolerances (bf16:
# out BF16_TOL, lse LSE_TOL, the backward BWD_REL_TOL and BWD_COS_MIN as
# phase_bwd; fp32: F32_REL_TOL of the largest value, K1 to the twin and the
# backward to the twin's arithmetic in float64, `_bwd_f64`, on
# RING_TWIN_HEADS heads as the 32K case of phase_bwd_f32, since the fp32
# twin's own sums over 16384 queries sit near 1e-5 of float64); each timed
# beside its bound (the (query, key) pairs this mask keeps), its twin and
# SDPA (efficient attention) with the equivalent bool mask.
RING_BF16_BLOCK = (1, 4096, 32, 128)    # b, s_local, h, d
RING_F32_BLOCK = (1, 16384, 6, 128)
RING_OFFSETS = ((1, 0), (0, 1))         # (q_offset, kv_offset): ranks 1 over 0, 0 over 1
RING_STRIDE, RING_DOCS, RING_TWIN_HEADS = 2, 3, 2


def _ring_block_segments(b, s, q_off, kv_off, stride=RING_STRIDE, docs=RING_DOCS):
    """Segment ids of `docs` equal documents over the positions 0 ..
    stride·s − 1, at a block's query and key positions: int32 [b, s] each."""
    total = stride * s

    def ids(off):
        pos = off + stride * torch.arange(s, device="cuda")
        return (pos * docs // total).to(torch.int32).expand(b, s).contiguous()

    return ids(q_off), ids(kv_off)


def _ring_case_name(dtype, b, s, h, q_off, kv_off):
    kind = "f32_" if dtype == torch.float32 else ""
    return (f"{kind}ring_b{b}_S{s}_h{h}_stride{RING_STRIDE}_q{q_off}_kv{kv_off}_"
            f"{RING_DOCS}docs")


def phase_ring_kernels(gen):
    """K1 and the fused backward, both routes, at the ring's blocks (see
    RING_*). Returns {kernel row: {case: dict(ms, plain_ms, library_ms,
    bound_ms, bound_by, max_abs_err)}} for the rows flash_fwd, flash_bwd
    (bf16) and flash_fwd_f32, flash_bwd_f32."""
    from lwm_tpu_torch.ops.reference import attention_mask

    out_rows = {"flash_fwd": {}, "flash_bwd": {}, "flash_fwd_f32": {}, "flash_bwd_f32": {}}
    f32 = torch.float32
    for dtype, (b, s, h, d) in ((BF16, RING_BF16_BLOCK), (f32, RING_F32_BLOCK)):
        for q_off, kv_off in RING_OFFSETS:
            name = _ring_case_name(dtype, b, s, h, q_off, kv_off)
            q, g = _randn((b, s, h, d), gen, dtype), _randn((b, s, h, d), gen, dtype)
            k, v = _randn((b, s, h, d), gen, dtype), _randn((b, s, h, d), gen, dtype)
            bias = torch.zeros((b, 1, 1, s), device="cuda")
            q_seg, kv_seg = _ring_block_segments(b, s, q_off, kv_off)
            kw = dict(causal=True, q_offset=q_off, kv_offset=kv_off, pos_stride=RING_STRIDE,
                      q_seg=q_seg, kv_seg=kv_seg)
            n_fwd, n_bwd = flash.flash_attention_fwd.launches, flash.flash_attention_bwd.launches
            out, lse = flash.flash_attention_fwd(q, k, v, bias, **kw)
            delta = torch.einsum("bqhd,bqhd->bhq", g.float(), out.float()).contiguous()
            args = (q, k, v, g, lse, delta, bias)
            got = flash.flash_attention_bwd(*args, **kw)
            torch.cuda.synchronize()
            if (flash.flash_attention_fwd.launches - n_fwd, flash.flash_attention_bwd.launches
                    - n_bwd) != (1, 1):
                raise AssertionError(f"ring block {name}: a kernel was not launched")
            keep = attention_mask(s, s, "cuda", **{k_: kw[k_] for k_ in (
                "q_offset", "kv_offset", "pos_stride", "q_seg", "kv_seg")})
            pairs = int(keep.sum())
            blind = ~keep.any(-1)[:, 0]                          # [b, s]: rows with no key
            n_blind = int(blind.sum())
            if (kv_off > q_off and not blind[:, 0].all()) or not (
                    torch.all(out[blind] == 0) and torch.all(lse.transpose(1, 2)[blind] == BIG_NEG)
                    and torch.all(got[0][blind] == 0)):
                raise AssertionError(f"ring block {name}: rows with no key ({n_blind}) do not "
                                     "give out 0, lse BIG_NEG and dq 0")
            # the twins: all heads in bf16; fp32 on RING_TWIN_HEADS (MHA, each head its own)
            th = h if dtype == BF16 else RING_TWIN_HEADS
            t_args = (*(x[:, :, :th].contiguous() for x in (q, k, v, g)),
                      *(x[:, :th].contiguous() for x in (lse, delta)), bias)
            ref, ref_lse = flash.flash_attention_fwd_plain(*t_args[:3], bias, **kw)
            live = ref_lse > BIG_NEG / 2
            if dtype == BF16:
                f_err = (out.float() - ref.float()).abs().max().item()
                l_err = (lse[live] - ref_lse[live]).abs().max().item()
                log(f"K1 {name}: max|out-plain| {f_err:.3e} (tol {BF16_TOL}), max|lse-plain| "
                    f"{l_err:.3e} (tol {LSE_TOL}); {n_blind} rows with no key")
                if not (f_err <= BF16_TOL and l_err <= LSE_TOL):
                    raise AssertionError(f"K1 {name} disagrees with its plain twin")
                want = flash.flash_attention_bwd_plain(*args, **kw)
                b_err, parts = 0.0, []
                for oname, a, r in zip(("dq", "dk", "dv"), got, want):
                    diff = (a.float() - r.float()).abs().max().item()
                    rel, cos = diff / r.float().abs().max().item(), _cosine(a, r)
                    parts.append(f"{oname} max|Δ|/max|ref| {rel:.3e} cos {cos:.6f}")
                    if not (rel <= BWD_REL_TOL and cos >= BWD_COS_MIN):
                        raise AssertionError(f"flash_bwd {name} {oname} disagrees with its twin")
                    b_err = max(b_err, diff)
                log(f"flash_bwd {name}: " + "; ".join(parts) +
                    f" (bounds {BWD_REL_TOL}, cos {BWD_COS_MIN})")
            else:
                f_err = _f32_hold(f"K1 {name} out", out[:, :, :th], ref)
                _f32_hold(f"K1 {name} lse", lse[:, :th][live], ref_lse[live])
                want32 = flash.flash_attention_bwd_plain(*t_args, **kw)
                want = _bwd_f64(*t_args, **kw)
                b_err = 0.0
                for oname, a, w32, r in zip(("dq", "dk", "dv"), got, want32, want):
                    twin_rel = ((w32 - r).abs().max() / r.abs().max()).item()
                    log(f"flash_bwd {name} {oname}: the fp32 twin's max|Δ| from float64 over "
                        f"max|float64| {twin_rel:.3e}")
                    b_err = max(b_err, _f32_hold(f"flash_bwd {name} {oname}",
                                                 a[:, :, :th].double(), r))
                del want32
            del ref, ref_lse, want
            torch.cuda.empty_cache()
            # times: the kernels, the twins (at their heads), SDPA with the
            # equivalent bool mask (efficient attention; rows with no key
            # give NaN there, which the timing does not read)
            fwd_ms = time_ms(lambda: flash.flash_attention_fwd(q, k, v, bias, **kw), 5)
            bwd_ms = time_ms(lambda: flash.flash_attention_bwd(*args, **kw), 5)
            fwd_plain = time_ms(lambda: flash.flash_attention_fwd_plain(*t_args[:3], bias, **kw), 2)
            bwd_plain = time_ms(lambda: flash.flash_attention_bwd_plain(*t_args, **kw), 2)
            from torch.nn.attention import SDPBackend, sdpa_kernel

            qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                fwd_lib = time_ms(lambda: F.scaled_dot_product_attention(
                    qt.detach(), kt.detach(), vt.detach(), attn_mask=keep), 5)
                o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep)
                bwd_lib = time_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), g.transpose(1, 2),
                                                              retain_graph=True), 5)
            del qt, kt, vt, o
            el = q.element_size()
            seg_bytes = 2 * b * s * 4
            fwd_bytes = (2 * q.numel() + 2 * k.numel()) * el + b * h * s * 4 + b * s * 4 + seg_bytes
            bwd_bytes = ((2 * q.numel() + 2 * k.numel()) * el * 2 + q.numel() * 4 * 2
                         + 2 * b * h * s * 4 + b * s * 4 + seg_bytes)
            pair_flops = d * h * pairs
            if dtype == BF16:
                fb, fby = bound_ms(fwd_bytes, 4 * pair_flops, H100_BF16_PEAK)
                bb, bby = bound_ms(bwd_bytes, 10 * pair_flops, H100_BF16_PEAK)
                rows = ("flash_fwd", "flash_bwd")
            else:
                fb, fby, _ = tf32_bounds(fwd_bytes, 4 * pair_flops)
                bb, bby, _ = tf32_bounds(bwd_bytes, 10 * pair_flops)
                rows = ("flash_fwd_f32", "flash_bwd_f32")
            for row, ms, plain_ms, lib, bnd, by, err in (
                    (rows[0], fwd_ms, fwd_plain, fwd_lib, fb, fby, f_err),
                    (rows[1], bwd_ms, bwd_plain, bwd_lib, bb, bby, b_err)):
                out_rows[row][name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=bnd,
                                           bound_by=by, max_abs_err=err)
                if th != h:
                    out_rows[row][name]["plain_heads"] = th
            log(f"ring block {name}: {pairs} (query, key) pairs of {s * s} a head and row, "
                f"{n_blind} rows with no key; K1 {fwd_ms:.3f} ms (bound {fb:.3f}, {fby}; "
                f"{100 * fb / fwd_ms:.1f}%), plain {fwd_plain:.3f} ms at {th} heads, SDPA with "
                f"the bool mask {fwd_lib:.3f} ms; backward {bwd_ms:.3f} ms (bound {bb:.3f}, {bby}; "
                f"{100 * bb / bwd_ms:.1f}%), plain {bwd_plain:.3f} ms, SDPA {bwd_lib:.3f} ms "
                f"[{card()}]")
            del q, k, v, g, out, lse, delta, args, t_args, got, keep, bias
            torch.cuda.empty_cache()
    return out_rows


# The vision-text bundle's attention (scripts/run_train_vision_text.sh: one
# row of 32768 tokens, 7b width, causal; its all-ones attention mask gives
# a zero per-key bias): K1 and the fused backward timed at h32 with SDPA
# (is_causal) beside them, and held to their plain twins at
# VISION_TWIN_HEADS heads (the twins materialise [h, S, S] fp32 scores:
# 8.6 GB a head pair, ~40 GB at the backward's peak; h32 would not fit)
VISION_TRAIN_REPORT = "train_vision_b1_S32768_h32_causal"
VISION_TRAIN_SEQ, VISION_TWIN_HEADS = 32768, 2
# run_vision_needle_torch.sh's stage C row (bf16, 1 x 33024, 6 heads of 64),
# timed and held as above but without the planted faults
VN_TRAIN_REPORT = "train_vneedle_b1_S33024_h6_d64_causal"
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


def phase_train_vision_kernels(gen, S=VISION_TRAIN_SEQ, heads=32, d=128,
                               name=VISION_TRAIN_REPORT, faults=True):
    """K1 and the fused backward over one causal row of S tokens (see
    above), timed at `heads` heads of d, held at VISION_TWIN_HEADS, with the
    planted faults when `faults`. Returns ({ms, plain_ms, library_ms,
    bound_ms, bound_by, max_abs_err, plain_heads} of K1, the same of the
    backward); plain_ms is the twin's at VISION_TWIN_HEADS heads."""
    b = 1
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
    log(f"K1 {name} at h{h}: max|out-plain| {err:.3e} (tol {BF16_TOL}), "
        f"cosine {cos:.7f} (min {BWD_COS_MIN}), largest row |out-plain|/|plain| "
        f"{row_rel:.3e} (tol {FWD_ROW_REL_TOL}), max|lse-plain| {lse_err:.3e} (tol {LSE_TOL})")
    if not (_k1_out_held(err, cos, row_rel) and lse_err <= LSE_TOL):
        raise AssertionError(f"K1 {name} disagrees with its plain twin")
    # planted faults, the kernel fed what a faulty kernel would read: v of
    # the other head, and one 128-key tile of v (keys 16384-16511) read
    # from the next tile; lse stays exact, so the output hold must fail
    tile = S // 2
    v_tile = v.clone()
    v_tile[:, tile:tile + 128] = v[:, tile + 128:tile + 256]
    for fault, v_bad in ((("v of the other head", v.flip(2)),
                          (f"v's tile at key {tile} read from the next", v_tile)) if faults else ()):
        bad, bad_lse = flash.flash_attention_fwd(q, k, v_bad, bias, **kw)
        reading = _k1_out_hold(bad, ref)
        log(f"K1 {name} planted fault ({fault}): max|out-plain| "
            f"{reading[0]:.3e}, cosine {reading[1]:.7f}, largest row relative error "
            f"{reading[2]:.3e}, max|lse-plain| {(bad_lse - ref_lse).abs().max().item():.3e}: "
            f"{'passes' if _k1_out_held(*reading) else 'fails'} the hold")
        if _k1_out_held(*reading):
            raise AssertionError(f"K1 {name}: the hold passed a planted fault "
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
            raise AssertionError(f"flash_bwd {name} {oname} disagrees with the twin")
        bwd_err = max(bwd_err, diff)
    log(f"flash_bwd {name} at h{h}: " + "; ".join(parts) +
        f" (bounds {BWD_REL_TOL}, cos {BWD_COS_MIN})")
    del got, want
    torch.cuda.empty_cache()
    bwd_plain_ms = time_ms(lambda: flash.flash_attention_bwd_plain(*args, **kw), 2)
    del q, k, v, g, out, lse, delta, args
    torch.cuda.empty_cache()

    h = heads
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
    for kernel, r in rows.items():
        log(f"{kernel} {name}: kernel {r['ms']:.3f} ms "
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


# ------------------------------------------------------ the other head dims
# K1, the fused backward and K4 at head dims other than 64 and 128 (any d ≤
# 128 with d % 4 == 0 runs on the next tile width, the columns past d
# zero): d 100, the 3b preset's (hidden 3200 over 32 heads), at the 3b's
# shapes -- K1 at an admission of 2048 queries over the 4096-slot cache
# (HD_ADMIT) and at the train step's attention, 2 x 4096 (HD_TRAIN), in bf16
# and fp32; the backward at HD_TRAIN in both; K4 at a decode round of 8
# slots of T 4096 (HD_DECODE) over bf16, int8 and fp32 caches -- each timed
# beside its bound, its twin and SDPA where SDPA takes it; d 80 held at
# smaller shapes. Neighbouring kv heads are scaled 1 / HD_SCALE and
# HD_SCALE (10^4 apart): q and v by c, k and g by 1 / c, which leaves the
# logits, p, lse, delta and ds as they were, so that a row read past d into
# the next head, or a head read at another's offset, shows in the hold. The
# outputs are scaled back per head (out / c, dq · c, dk / c, dv · c) and
# held as the d-128 cases are: bf16 K1 by max|Δ| (BF16_TOL), cosine
# (BWD_COS_MIN) and per row (FWD_ROW_REL_TOL), lse LSE_TOL; the bf16
# backward BWD_REL_TOL and BWD_COS_MIN; K4 as _k4_check; the fp32 routes at
# F32_REL_TOL of the largest value, the fp32 backward also to the twin's
# arithmetic in float64 (_bwd_f64) on HD_F64_HEADS heads. The backward is
# also held, untimed, at the 3b training CLI's 2 x P3B_TRAIN_SEQ.
HD_SCALE = 1e2
HD_F64_HEADS = 2
HD_ADMIT, HD_TRAIN = "d100_admit_b1_h32_q2048_T4096", "d100_train_b2_S4096_h32_causal_padkeys"
HD_DECODE = "d100_decode_b8_h32_T4096"
# K1: name, d, b, sq, T, head-major (the cache) or seq-major, bias kind
# (_k1_bias), timed
HD_K1_CASES = [
    (HD_ADMIT, 100, 1, 2048, 4096, True, "prompt", True),
    (HD_TRAIN, 100, 2, 4096, 4096, False, "per_key", True),
    ("d80_admit_b1_h32_q1000_T2048", 80, 1, 1000, 2048, True, "prompt", False),
    ("d80_train_b2_S1024_h32_causal_padkeys", 80, 2, 1024, 1024, False, "per_key", False),
]


def _hd_scale(h):
    """Each head's factor [h, 1]: 1 / HD_SCALE on even heads, HD_SCALE on odd."""
    return torch.tensor([HD_SCALE if i % 2 else 1 / HD_SCALE for i in range(h)],
                        device="cuda")[:, None]


def _sdpa_ms(fn, iters, **kw):
    """SDPA's time, or None where it does not take the case."""
    try:
        return time_ms(fn, iters, **kw)
    except RuntimeError as e:
        log(f"  SDPA does not take this case: {str(e).splitlines()[0][:160]}")
        return None


def _hd_k1(case, dtype, gen):
    """K1 at one HD_K1_CASES case (MHA, 32 heads, causal) against its twin;
    (max|Δ| on the scaled-back out, times or None)."""
    name, d, b, sq, T, head_major, kind, timed = case
    f32, h = torch.float32, 32
    c = _hd_scale(h)
    ckv = c[:, None] if head_major else c
    kv_shape = (b, h, T, d) if head_major else (b, T, h, d)
    q = (_randn((b, sq, h, d), gen, f32) * c).to(dtype)
    k = (_randn(kv_shape, gen, f32) / ckv).to(dtype)
    v = (_randn(kv_shape, gen, f32) * ckv).to(dtype)
    bias, valid = _k1_bias(kind, b, sq, T, 0, gen)
    kw = dict(causal=True, q_offset=0, kv_offset=0, kv_head_major=head_major)
    out, lse = flash.flash_attention_fwd(q, k, v, bias, **kw)
    ref, ref_lse = flash.flash_attention_fwd_plain(q, k, v, bias, **kw)
    torch.cuda.synchronize()
    what = f"K1 {'f32_' if dtype == f32 else ''}{name}"
    out_n, ref_n = out.float() / c, ref.float() / c
    if dtype == f32:
        err = _f32_hold(f"{what} out (heads scaled back)", out_n, ref_n)
        live = ref_lse > BIG_NEG / 2
        _f32_hold(f"{what} lse", lse[live], ref_lse[live])
    else:
        err, cos, row_rel = _k1_out_hold(out_n, ref_n)
        lse_err = (lse - ref_lse).abs().max().item()
        log(f"{what} (heads scaled back): max|out-plain| {err:.3e} (tol {BF16_TOL}), cosine "
            f"{cos:.6f} (min {BWD_COS_MIN}), largest row |Δ|/|plain| {row_rel:.3e} (tol "
            f"{FWD_ROW_REL_TOL}), max|lse-plain| {lse_err:.3e} (tol {LSE_TOL})")
        if not (_k1_out_held(err, cos, row_rel) and lse_err <= LSE_TOL):
            raise AssertionError(f"{what} disagrees with its plain twin")
    del out, ref, out_n, ref_n, lse, ref_lse
    t = None
    if timed and dtype != f32:
        t = dict(_time_k1(q, k, v, bias, valid, kw), max_abs_err=err)
    elif timed:
        ms = time_ms(lambda: flash.flash_attention_fwd(q, k, v, bias, **kw), 10)
        plain_ms = time_ms(lambda: flash.flash_attention_fwd_plain(q, k, v, bias, **kw), 2)
        pos = torch.arange(sq, device="cuda")
        mask = torch.where(torch.arange(T, device="cuda")[None] <= pos[:, None], bias, BIG_NEG)
        kt, vt = (k, v) if head_major else (k.transpose(1, 2), v.transpose(1, 2))
        lib_ms = _sdpa_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), kt, vt, attn_mask=mask), 10)
        del mask
        pairs = attn_pairs(valid, sq, 0)
        n_bytes = 2 * q.numel() * 4 + 2 * int(valid.sum()) * h * d * 4 + b * h * sq * 4
        bnd, by, fma = tf32_bounds(n_bytes + bias.numel() * 4, 4 * d * h * pairs)
        t = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd, bound_by=by,
                 fma_bound_ms=fma, max_abs_err=err)
    if t is not None:
        lib = "not taken" if t["library_ms"] is None else f"{t['library_ms']:.3f} ms"
        log(f"{what}: kernel {t['ms']:.3f} ms ({100 * t['bound_ms'] / t['ms']:.1f}% of the "
            f"bound), plain {t['plain_ms']:.3f} ms, SDPA {lib}, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}) [{card()}]")
    del q, k, v, bias
    torch.cuda.empty_cache()
    return err, t


def _hd_bwd(dtype, gen, d=100, b=2, S=4096, timed=True):
    """The fused backward at b x S (HD_TRAIN by default; MHA, 32 heads, the
    model's per-key bias) against its twin, and in fp32 also to the twin's
    arithmetic in float64 on HD_F64_HEADS heads; (max|Δ| scaled back, times
    or None)."""
    f32, h = torch.float32, 32
    c = _hd_scale(h)
    q, v = ((_randn((b, S, h, d), gen, f32) * c).to(dtype) for _ in range(2))
    k, g = ((_randn((b, S, h, d), gen, f32) / c).to(dtype) for _ in range(2))
    bias, valid = _bwd_bias("per_key", b, S, gen)
    kw = dict(causal=True, q_offset=0, kv_offset=0)
    out, lse = flash.flash_attention_fwd(q, k, v, bias, **kw)
    delta = torch.einsum("bqhd,bqhd->bhq", g.float(), out.float()).contiguous()
    del out
    args = (q, k, v, g, lse, delta, bias)
    got = flash.flash_attention_bwd(*args, **kw)
    back = (c, 1 / c, c)   # dq · c, dk / c, dv · c
    what = f"flash_bwd {'f32_' if dtype == f32 else ''}d{d}_train_b{b}_S{S}_h32_causal_padkeys"
    worst = 0.0
    if dtype == f32:
        want = flash.flash_attention_bwd_plain(*args, **kw)
        for oname, a, r, s in zip(("dq", "dk", "dv"), got, want, back):
            worst = max(worst, _f32_hold(f"{what} {oname} (heads scaled back)", a * s, r * s))
        del want
        n = HD_F64_HEADS
        part = (*(x[:, :, :n].contiguous() for x in (q, k, v, g)),
                *(x[:, :n].contiguous() for x in (lse, delta)), bias)
        ref = _bwd_f64(*part, **kw)
        twin = flash.flash_attention_bwd_plain(*part, **kw)
        for oname, a, t, r, s in zip(("dq", "dk", "dv"), got, twin, ref, back):
            a, t, r = a[:, :, :n] * s[:n], t * s[:n], r * s[:n].double()
            log(f"{what} {oname}: the fp32 twin's max|Δ| from float64 over max|float64| "
                f"{((t - r).abs().max() / r.abs().max()).item():.3e} (heads 0-{n - 1}, scaled "
                f"back)")
            worst = max(worst, _f32_hold(f"{what} {oname} vs float64", a.double(), r))
        del ref, twin, part
    else:
        want = flash.flash_attention_bwd_plain(*args, **kw)
        parts = []
        for oname, a, r, s in zip(("dq", "dk", "dv"), got, want, back):
            a, r = a.float() * s, r.float() * s
            diff = (a - r).abs().max().item()
            rel, cos = diff / r.abs().max().item(), _cosine(a, r)
            parts.append(f"{oname} max|Δ|/max|ref| {rel:.3e} cos {cos:.6f}")
            if not (rel <= BWD_REL_TOL and cos >= BWD_COS_MIN):
                raise AssertionError(f"{what} {oname} disagrees with its plain twin")
            worst = max(worst, diff)
        log(f"{what} (heads scaled back): " + "; ".join(parts) +
            f" (bounds {BWD_REL_TOL}, cos {BWD_COS_MIN})")
        del want
    del got
    torch.cuda.empty_cache()
    if not timed:
        del q, k, v, g, lse, delta, bias, args
        torch.cuda.empty_cache()
        return worst, None
    ms = time_ms(lambda: flash.flash_attention_bwd(*args, **kw), 10 if dtype != f32 else 5)
    plain_ms = time_ms(lambda: flash.flash_attention_bwd_plain(*args, **kw), 2)
    pos = torch.arange(S, device="cuda")
    mask = torch.where(pos[None] <= pos[:, None], bias, BIG_NEG).to(dtype)
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
    lib_ms = None
    try:
        o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        lib_ms = _sdpa_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), g.transpose(1, 2),
                                                      retain_graph=True), 5)
        del o
    except RuntimeError as e:
        log(f"  SDPA does not take this case: {str(e).splitlines()[0][:160]}")
    del mask, qt, kt, vt
    pairs = attn_pairs(valid, S, 0)
    if dtype == f32:
        bnd, by, fma = tf32_bounds(*bwd_f32_work(q, k, bias, pairs))
    else:
        n_bytes = (2 * q.numel() + 2 * k.numel()) * 2 * 2 + 2 * b * h * S * 4 + b * S * 4
        bnd, by = bound_ms(n_bytes + q.numel() * 4 * 2, 10 * d * h * pairs, H100_BF16_PEAK)
    t = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd, bound_by=by,
             max_abs_err=worst)
    if dtype == f32:
        t["fma_bound_ms"] = fma
    lib = "not taken" if lib_ms is None else f"{lib_ms:.3f} ms"
    log(f"{what}: kernel {ms:.3f} ms ({100 * bnd / ms:.1f}% of the bound), plain backward "
        f"{plain_ms:.3f} ms, SDPA backward {lib}, bound {bnd:.3f} ms ({by}) [{card()}]")
    del q, k, v, g, lse, delta, bias, args
    torch.cuda.empty_cache()
    return worst, t


def _hd_k4(kind, d, gen, timed):
    """K4 at 8 slots of T 4096 (K4_SLOT_LENGTHS, a left-pad hole), MHA at 32
    heads, over a `kind` cache ("bf16", "int8" or "fp32") against its twin,
    output and partials; (max|Δ| on the scaled-back out, times or None)."""
    f32, b, h, T = torch.float32, 8, 32, 4096
    c = _hd_scale(h)
    dtype = f32 if kind == "fp32" else BF16
    lengths = torch.tensor(K4_SLOT_LENGTHS, device="cuda")
    mask = torch.arange(T, device="cuda")[None] <= lengths[:, None]
    mask[2, :300] = False
    kv_len = int(lengths.max()) + 1
    q = (_randn((b, 1, h, d), gen, f32) * c).to(dtype)
    k = (_randn((b, h, T, d), gen, f32) / c[:, None]).to(dtype)
    v = (_randn((b, h, T, d), gen, f32) * c[:, None]).to(dtype)
    ks = vs = None
    if kind == "int8":
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
    args = (q, k, v, mask, kv_len, ks, vs)
    out = decode.flash_decode(*args)
    o, m, l = decode.flash_decode(*args, return_partials=True)
    ref = decode.flash_decode_plain(*args)
    ro, rm, rl = decode.flash_decode_plain(*args, return_partials=True)
    torch.cuda.synchronize()
    what = f"K4 d{d}_decode_b8_h32_T4096 {kind} cache"
    if kind == "fp32":
        err = _f32_hold(f"{what} out (heads scaled back)", out / c, ref / c)
        _f32_hold(f"{what} partials m", m, rm)
        _f32_hold(f"{what} partials l", l, rl)
    else:
        err = ((out.float() - ref.float()) / c).abs().max().item()
        o_err = ((o.float() - ro.float()) / c).abs().max().item()
        m_err = (m - rm).abs().max().item()
        l_rel = ((l - rl).abs().max() / rl.abs().max()).item()
        log(f"{what} (heads scaled back): max|out-plain| {err:.3e} (tol {BF16_TOL}); partials "
            f"max|o-plain| {o_err:.3e}, max|m-plain| {m_err:.3e} (tol {LSE_TOL}), "
            f"max|l-plain|/max l {l_rel:.3e} (tol {LSE_TOL})")
        if not (max(err, o_err) <= BF16_TOL and m_err <= LSE_TOL and l_rel <= LSE_TOL):
            raise AssertionError(f"{what} disagrees with its plain twin")
    if not torch.equal(o, out):
        raise AssertionError(f"{what}: o with partials differs from the plain output")
    t = None
    if timed:
        _, _, kv_bytes = k4_bound(q, k, mask, kv_len)
        n_valid = int(mask[:, :kv_len].sum())
        bnd, by = bound_ms(kv_bytes + 2 * q.numel() * q.element_size() + b * kv_len,
                           4 * n_valid * h * d, H100_F32_PEAK if kind == "fp32" else H100_BF16_PEAK)
        sets = k4_arg_sets(args, kv_bytes)
        ms = time_ms(lambda *a: decode.flash_decode(*a), 50, sets, graph=True)
        plain_ms = time_ms(lambda: decode.flash_decode_plain(*args), 3)
        lib_ms = None
        if kind != "int8":
            seen = (mask & (torch.arange(T, device="cuda") < kv_len)[None])[:, None, None, :]
            lib_ms = _sdpa_ms(lambda q, k, v, *_: F.scaled_dot_product_attention(
                q.transpose(1, 2), k, v, attn_mask=seen), 50, arg_sets=sets, graph=True)
            del seen
        t = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd, bound_by=by,
                 max_abs_err=err)
        lib = "none (int8 cache)" if kind == "int8" else (
            "not taken" if lib_ms is None else f"{lib_ms:.4f} ms (graph)")
        log(f"{what}: kernel {ms:.4f} ms (graph; {100 * bnd / ms:.1f}% of the bound), plain "
            f"{plain_ms:.3f} ms, SDPA {lib}, bound {bnd:.4f} ms ({by}; {len(sets)} cache copies "
            f"cycled) [{card()}]")
        del sets
    del args, q, k, v, ks, vs
    torch.cuda.empty_cache()
    return err, t


def phase_head_dims(gen):
    """Each route at d 100 (and K1 and K4 at d 80) as the comment above
    says. Returns {kernel: {case: times}} for the kernels line:
    "flash_fwd", "flash_fwd_f32", "flash_bwd", "flash_bwd_f32",
    "flash_decode", "flash_decode_f32"."""
    f32 = torch.float32
    out = {k: {} for k in ("flash_fwd", "flash_fwd_f32", "flash_bwd", "flash_bwd_f32",
                           "flash_decode", "flash_decode_f32")}
    for dtype, key in ((BF16, "flash_fwd"), (f32, "flash_fwd_f32")):
        for case in HD_K1_CASES:
            _, t = _hd_k1(case, dtype, gen)
            if t is not None:
                out[key][("f32_" if dtype == f32 else "") + case[0]] = t
    out["flash_bwd"][HD_TRAIN] = _hd_bwd(BF16, gen)[1]
    out["flash_bwd_f32"]["f32_" + HD_TRAIN] = _hd_bwd(f32, gen)[1]
    for dtype in (BF16, f32):   # the 3b training CLI's shape (phase_3b), held only
        _hd_bwd(dtype, gen, S=P3B_TRAIN_SEQ, timed=False)
    for kind in ("bf16", "int8", "fp32"):
        for d in (100, 80):
            _, t = _hd_k4(kind, d, gen, timed=d == 100)
            if t is not None:
                key = "flash_decode_f32" if kind == "fp32" else "flash_decode"
                out[key][("f32_" if kind == "fp32" else "") + f"{HD_DECODE}_{kind}"] = t
    return out


def serving_config(preset="7b"):
    """scripts/run_serve.sh: 7b (LLAMA_CONFIG), theta 5e7, no scan; the CLI
    sets per_row and max_sequence_length = max(preset, cache_len)."""
    cfg = LLaMAConfig.load_config(preset)
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
    """The model of `cfg` (the 7b's) in bf16 on the card with random weights
    from SEED."""
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
                        labels=None, what="admission", floor_ratio=FLOOR_RATIO, near_tie=False):
    """The serving noise-floor rule, per checked prompt: the `kernel` path agrees
    with the `arm` path (the same tensors another way) at cosine >= cos_min
    and on argmax (or, with `argmax_of_truth`, on the fp32 `truth`'s argmax
    where the arm misses it; with `near_tie`, also on a token whose truth
    logit lies below the truth's top by no more than the arm's own largest
    distance from the truth), and is at most `floor_ratio` x as far from
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
        pick = int(got.argmax())
        if pick not in picks and near_tie:
            gap = (ref.max() - ref[pick]).item()
            floor = (want - ref).abs().max().item()
            log(f"{what} logits, prompt {n}: {kernel}'s pick {pick} lies {gap:.4f} below "
                f"{truth}'s top; {arm}'s largest distance from {truth} {floor:.4f} (a near "
                f"tie within it is allowed)")
            if gap <= floor:
                picks.add(pick)
        if pick not in picks:
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

    int8, w8a8 = build("int8"), build("int8_w8a8", kv_cache_dtype="int8")
    launches, summary = serve(int8, "int8")
    torch.cuda.empty_cache()
    for key, unit in (("prefill_s", "s"), ("decode_tok_s", " tok/s"), ("peak_gib", " GiB")):
        log(f"serve int8 vs bf16: {key} {summary[key]:.3f}{unit} vs {bf16[key]:.3f}{unit}")
    w_launches, _ = serve(w8a8, "int8_w8a8 (int8 cache)", n_requests=4)
    torch.cuda.empty_cache()
    hold_quant_logits(cfg, sd, int8, w8a8)
    return launches, w_launches


def hold_quant_logits(cfg, sd, int8, w8a8, what="admission", near_tie=False):
    """Admission logits of the K5 model `int8` held to the noise floor
    against the "int8_xla" dequant arm on the same int8 tensors `sd`
    (`near_tie` as hold_to_noise_floor's), and of the W8A8 model `w8a8`
    (int8 cache) to W8A8_COS_MIN, both against an fp32 copy of the
    dequantized weights through the plain path."""
    xla = quantized_model(cfg, sd, "int8_xla")
    deq = {}
    for k, v in sd.items():
        if v.dtype == torch.int8:
            deq[k] = v.float() * sd[k[: -len("weight")] + "scale"][:, None]
        elif not k.endswith(".scale"):
            deq[k] = v.float()
    ref32 = LLaMAForCausalLM.on_tensors(cfg.replace(attn_impl="plain"), deq, torch.float32)
    del deq
    logits = admission_logits({"int8": int8, "int8_xla": xla, "int8_w8a8": w8a8,
                               "fp32_dequant": ref32}, cfg)
    del xla, ref32
    torch.cuda.empty_cache()
    w8a8_cos = [_cos(got, ref) for got, ref in zip(logits["int8_w8a8"], logits["fp32_dequant"])]
    for i, got, ref, c in zip(CHECKED_PROMPTS, logits["int8_w8a8"], logits["fp32_dequant"],
                              w8a8_cos):
        log(f"{what} logits, prompt {PROMPT_LENS[i]}: int8_w8a8 (int8 cache) cosine to "
            f"fp32_dequant {c:.6f} (min {W8A8_COS_MIN}), argmax "
            f"{int(got.argmax())}/{int(ref.argmax())}")
    hold_to_noise_floor(logits, "int8", "int8_xla", "fp32_dequant", INT8_ARM_COS_MIN,
                        argmax_of_truth=True, what=what, near_tie=near_tie)
    if not min(w8a8_cos) >= W8A8_COS_MIN:
        raise AssertionError(f"int8_w8a8 {what} logits are too far from the fp32 result")


# The 3b preset (OpenLLaMA 3B's shape: hidden 3200 over 32 heads of d 100,
# 26 layers, intermediate 8640; random weights from SEED) on its main paths:
# serving as scripts/run_serve.sh runs it with LLAMA_CONFIG=3b (bf16, 8
# slots, cache 4096, buckets 256/1024/2048, per_row, theta 5e7, all 26
# layers), the first P3B_REQUESTS of the serving mix, its admission logits
# held to the bf16 noise floor against the plain path and an fp32 copy; the
# same weights over an int8 cache, the logits of a request's admission and
# first decode round as the server picks them held to the noise floor
# against the plain path over an int8 cache and an fp32 copy; quantized on
# the card (QUANTIZE=1) and served with K5 (quant_dense "int8") and K6
# ("int8_w8a8", int8 cache), the first P3B_QUANT_REQUESTS each, their
# admission logits held as phase_serve_int8 holds the 7b's; the fp32 copy through TextSampler
# (P3B_GEN_ROWS prompts at max_input_length P3B_GEN_INPUT, P3B_GEN_NEW new
# tokens: K1's and K4's fp32 routes), its prefill logits held to the plain
# fp32 path at NEEDLE_REL_TOL and its greedy tokens exactly; and the training
# CLI at --load_llama_config=3b, P3B_TRAIN_LAYERS layers, 2 x
# P3B_TRAIN_SEQ, P3B_TRAIN_STEPS steps in bf16 and at its default fp32.
# Exact launch counts on every path.
P3B_REQUESTS, P3B_QUANT_REQUESTS = 8, 4
P3B_CACHE_PROMPT = 2   # the 700-token prompt of the mix (bucket 1024)
P3B_GEN_ROWS, P3B_GEN_INPUT, P3B_GEN_NEW = 2, 1024, 32
P3B_TRAIN_LAYERS, P3B_TRAIN_SEQ, P3B_TRAIN_STEPS = 8, 2048, 2


def _serve_3b_int8_cache(model, fp32):
    """The 3b weights over an int8 cache: served, then the logits of
    P3B_CACHE_PROMPT's admission and first decode round read off the server
    (`server_logits`) held to the noise floor against the same tensors
    through the plain path over an int8 cache, with an fp32 copy over an
    fp32 cache as the truth. Returns the serving run's launches."""
    cfg = model.config.replace(kv_cache_dtype="int8")
    kernel = LLaMAForCausalLM.on_tensors(cfg, model.state_dict(), BF16)
    launches = serve(kernel, "3b bf16 (int8 cache)", n_requests=P3B_QUANT_REQUESTS)[0]
    torch.cuda.empty_cache()
    prompt = serving_requests(cfg)[0][P3B_CACHE_PROMPT]
    srv = InflightServer(kernel, slots=8, cache_len=4096, prompt_buckets=BUCKETS,
                         stop_tokens=(cfg.eos_token_id,), seed=SEED)
    rows = {"kernel": server_logits(srv, prompt)}
    del srv
    plain_cfg = cfg.replace(attn_impl="plain")
    arms = {"plain": LLaMAForCausalLM.on_tensors(plain_cfg, model.state_dict(), BF16),
            "fp32": LLaMAForCausalLM.on_tensors(plain_cfg.replace(kv_cache_dtype="auto"), fp32,
                                                torch.float32)}
    tok = rows["kernel"][1][0]
    rows = {"kernel": rows["kernel"][0],
            **{name: unchunked_logits(m, prompt, tok, 4096) for name, m in arms.items()}}
    del arms, kernel
    torch.cuda.empty_cache()
    n = len(prompt)
    hold_to_noise_floor(rows, "kernel", "plain", "fp32", argmax_of_truth=True,
                        labels=[f"{n}, first token", f"{n}, then one decode round"],
                        what="3b int8-cache server")
    return launches


def _generate_3b(cfg, fp32):
    """P3B_GEN_ROWS prompts through TextSampler over the fp32 weights;
    returns the launch counts."""
    cfg = cfg.replace(decode_index="shared", scan_query_chunk_size=P3B_GEN_NEW,
                      scan_key_chunk_size=P3B_GEN_NEW)
    m32 = LLaMAForCausalLM.on_tensors(cfg, fp32, torch.float32)
    sampler = TextSampler.from_model(m32, Tokenizer(str(FIXTURE_TOKENIZER)), greedy=True,
                                     seed=SEED)
    rng = np.random.default_rng(SEED + 26)
    prompts = [_cli_text(rng, 500) for _ in range(P3B_GEN_ROWS)]
    torch.cuda.synchronize()
    _reset_launch_counts()
    with timed_generation(m32) as rec:
        texts = sampler(prompts, P3B_GEN_INPUT)
    launches = _launch_counts()
    want = _generation_launches(cfg, rec, f32=True)
    if launches != want or len(texts) != P3B_GEN_ROWS:
        raise AssertionError(f"3b fp32 generate: launches {launches}, want {want}")
    _log_generation("3b fp32 generate", rec, P3B_GEN_ROWS, P3B_GEN_INPUT,
                    llama_module.round_cache_length(cfg, P3B_GEN_INPUT + P3B_GEN_NEW))
    ids, mask = sampler.encode(prompts, P3B_GEN_INPUT)
    plain = LLaMAForCausalLM.on_tensors(cfg.replace(attn_impl="plain"), fp32, torch.float32)
    want_logits = _row_logits(plain, ids, mask, P3B_GEN_NEW)
    got = rec["prefill_logits"]
    rel = ((got - want_logits).abs().max() / want_logits.abs().max()).item()
    want_tokens = generation.generate(plain, ids, mask, sampler.generation_config())
    same = (rec["tokens"] == want_tokens).float().mean(-1).tolist()
    log(f"3b fp32 generate: prefill logits kernel vs plain fp32 path max|Δ|/max|plain| "
        f"{rel:.3e} (tol {NEEDLE_REL_TOL}); greedy tokens shared with the plain fp32 path "
        f"{same} (of {rec['tokens'].shape[1]}; held exactly); launches {launches}")
    if not rel <= NEEDLE_REL_TOL or not torch.equal(rec["tokens"], want_tokens):
        raise AssertionError("3b fp32 generate: the kernel path leaves the plain fp32 path")
    del m32, plain, sampler
    torch.cuda.empty_cache()
    return launches


def _train_3b_argv(out_dir, data, dtype):
    root = Path(__file__).resolve().parent
    return [
        f"--dtype={dtype}", f"--seed={SEED + 26}", "--load_llama_config=3b",
        f"--update_llama_config=dict(num_hidden_layers={P3B_TRAIN_LAYERS}, "
        f"max_sequence_length={P3B_TRAIN_SEQ})",
        f"--tokenizer={root / 'tests' / 'fixtures' / 'tokenizer'}",
        "--train_dataset.type=json", "--train_dataset.text_processor.fields=text",
        f"--train_dataset.json_dataset.path={data}",
        f"--train_dataset.json_dataset.seq_length={P3B_TRAIN_SEQ}",
        "--train_dataset.json_dataset.batch_size=2", "--optimizer.type=adamw",
        *[f"--optimizer.adamw_optimizer.{k}={v}" for k, v in TRAIN_CLI_OPT.items()],
        f"--total_steps={P3B_TRAIN_STEPS}", "--log_freq=1", f"--logger.output_dir={out_dir}",
        f"--logger.experiment_id=train3b_{dtype}", "--logger.append_uuid=False",
    ]


def _train_3b():
    """The training CLI at the 3b width in bf16 and fp32; their launches."""
    paths = []
    with tempfile.TemporaryDirectory(prefix="lwm_train_3b_") as tmp:
        tmp = Path(tmp)
        data = tmp / "train.jsonl"
        _write_jsonl(data, 100, TRAIN_CLI_WORDS, SEED + 26)
        for dtype in ("bf16", "fp32"):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            summary, launches = _run_cli(_train_3b_argv(tmp, data, dtype), P3B_TRAIN_LAYERS,
                                         P3B_TRAIN_STEPS, f"3b {dtype}")
            wall = time.perf_counter() - t0
            f32_want = P3B_TRAIN_LAYERS * P3B_TRAIN_STEPS if dtype == "fp32" else 0
            recs = _metrics(summary)
            log(f"train cli 3b {dtype}: {P3B_TRAIN_LAYERS} layers, 2 x {P3B_TRAIN_SEQ}, steps "
                + ", ".join(f"{r['step']}: loss {r['loss']:.5f} grad_norm "
                            f"{r['gradient_norm']:.4f}" for r in recs)
                + f"; {wall:.1f}s of wall (build and init included), step 2 "
                f"{recs[-1]['_time'] - recs[-2]['_time']:.3f}s; peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; launches {launches} "
                f"[{card()}]")
            if not (launches["flash_fwd_f32"] == launches["flash_bwd_f32"] == f32_want
                    and all(math.isfinite(r["loss"]) for r in recs)):
                raise AssertionError(f"train cli 3b {dtype}: launches {launches}, losses "
                                     f"{[r['loss'] for r in recs]}")
            paths.append(launches)
    return paths


def phase_3b():
    """The 3b preset's paths (see above). Returns each path's launches."""
    cfg = serving_config("3b")
    model = serving_model(cfg)
    torch.cuda.synchronize()
    log(f"3b: {sum(p.numel() for p in model.parameters()) / 1e9:.2f}B params, head dim "
        f"{cfg.head_dim}, {cfg.num_hidden_layers} layers, bf16, random seed {SEED}")
    paths = [serve(model, "3b bf16", n_requests=P3B_REQUESTS)[0]]
    fp32 = fp32_weights(model)
    logits = admission_logits({"kernel": model, **plain_arms(model, fp32)}, cfg)
    # the kernel path may take the fp32 truth's argmax where the plain bf16
    # arm misses it at a near tie (prompt 50 on an H100 80GB HBM3: kernel and
    # fp32 30635, plain 9291), as the int8 arms are held
    hold_to_noise_floor(logits, "kernel", "plain", "fp32", argmax_of_truth=True,
                        what="3b admission")
    del logits
    paths.append(_serve_3b_int8_cache(model, fp32))
    paths.append(_generate_3b(cfg, fp32))
    del fp32
    sd = quant.quantize_params_int8(model.state_dict())
    del model
    torch.cuda.empty_cache()
    int8, w8a8 = (quantized_model(cfg, sd, "int8"),
                  quantized_model(cfg, sd, "int8_w8a8", kv_cache_dtype="int8"))
    paths.append(serve(int8, "3b int8", n_requests=P3B_QUANT_REQUESTS)[0])
    paths.append(serve(w8a8, "3b int8_w8a8 (int8 cache)", n_requests=P3B_QUANT_REQUESTS)[0])
    torch.cuda.empty_cache()
    # prompt 50 sits at a near tie of tokens 30635 and 9291 in every arm (the
    # bf16 hold above): on an H100 80GB HBM3 K5 took 30635, int8_xla and the
    # fp32 dequantized copy 9291, K5 nearer that copy (distance ratio 0.88)
    hold_quant_logits(cfg, sd, int8, w8a8, what="3b admission", near_tie=True)
    del int8, w8a8, sd
    torch.cuda.empty_cache()
    paths.extend(_train_3b())
    return paths


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
    (see CLI_LAYERS), each through its main in this process (a `python -m`
    run paid 24 s of imports; summarize_needle's is the smoke's module
    entry point). Checks each output file has one line per request and that
    the run loading the index gives the first run's completions."""
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
        for name, extra in runs.items():
            out = tmp / f"{name.replace(' ', '_')}.jsonl"
            argv = base + extra + [f"--output_file={out}"]
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
# writer, served by `lwm_tpu_torch.apps.serve_vision`'s main at
# scripts/run_serve_vision_torch.sh's flags over a CLI_VIDEO_FRAMES-frame
# codes file (2075 prefix tokens, built in two 2048-token chunks) and a
# questions file: the video index saved, then loaded (the same answers),
# then lookup verify.
CLI_VIDEO_FRAMES = 8


def phase_cli_vision():
    """The video QA CLI on the card, three runs over one saved checkpoint
    through its main in this process (its `python -m` run, 14-17 s of
    imports, cut for room). Checks each answers file has one line per question
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
# (the same tensors; bf16 and fp32 greedy tokens
# fork, so rounds accept part of their proposals and rewind into the verify
# window); prompt lookup, n-gram SPEC_NGRAM, on prompts that repeat a span.
# The self arm decodes SPEC_NEW tokens, the other three SPEC_NEW / 2 (cut
# for room: the draft and lookup arms accept nothing on random weights).
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
        new = SPEC_NEW if arm == "self" else SPEC_NEW // 2
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
# chunks NEEDLE_BLOCK. Each runs twice through its main in this process
# (both first runs are in-process to make room: a `python -m` run costs
# 14-17 s of imports): one
# results row a grid point, and the rerun over the file adds none
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
VG_FRAMES = 2
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


@contextlib.contextmanager
def recorded_forwards():
    """Each model forward's (input length, synced seconds), any model."""
    record, real = [], LLaMAForCausalLM.forward

    def forward(self, ids, *a, **kw):
        t0 = time.perf_counter()
        out = real(self, ids, *a, **kw)
        torch.cuda.synchronize()
        record.append((ids.shape[1], time.perf_counter() - t0))
        return out

    LLaMAForCausalLM.forward = forward
    try:
        yield record
    finally:
        LLaMAForCausalLM.forward = real


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
    torch.cuda.empty_cache()
    return paths


# Image and video QA (phase_vision_chat): scripts/run_vision_chat_torch.sh's
# path through apps.vision_chat.Sampler at the 7b width, all 32 layers, fp32,
# on phase_vision_generation's tensors (the serving weights' fp32 copy as a
# VideoLLaMA, vte and vision_head from the seed) in sample_mode "text" at the
# bundle's config (VC_CONFIG): VC_FRAMES frames of seeded pixels, already
# decoded, through phase_vqgan's model (`Sampler.encode_frames`: each frame's
# codes and EOF, EOV after the last), the prompt by `construct_input` with
# the fixture tokenizer (VC_PROMPT tokens, left-padded), then 128 new tokens
# (block_size) at temperature 0.2 and top-k 50: exact K1/K4 fp32 counts (K1 a
# layer for the prefill, K4 a layer a step), prefill seconds, ms a step. Then
# top-k 1 on the kernel path and on an attn_impl="plain" arm of the same
# tensors: the prefill's last logits held at NEEDLE_REL_TOL of the largest,
# the tokens equal (or apart first at a near tie, SPEC_TIE_GAP).
VC_FRAMES = 8
VC_PROMPT = 2432   # ceil((8 x 257 + 256) / 128) x 128
VC_QUESTION = "What is happening in this video?"
VC_CONFIG = dict(sample_mode="text", theta=50_000_000, max_sequence_length=131072,
                 scan_attention=False, scan_query_chunk_size=128, scan_key_chunk_size=128,
                 scan_mlp=False, scan_mlp_chunk_size=2048)


def _vision_chat_arm(sampler, batch, what, counted=True):
    """One `Sampler.generate` of `batch`'s row: (its new tokens, the
    forwards' seconds, launches or None), exact K1/K4 fp32 counts held when
    `counted`."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    _reset_launch_counts()
    with timed_forwards(sampler.model) as sec:
        tokens = sampler.generate(batch)[0].cpu().numpy()
    launches = _launch_counts() if counted else None
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = len(sec) - 1
    if counted:
        want = _generation_launches(sampler.model.config, dict(forwards=len(sec)), f32=True)
        if launches != want:
            raise AssertionError(f"{what}: launches {launches}, want {want}")
    step_ms = 1e3 * sum(sec[1:]) / max(steps, 1)
    log(f"{what}: {steps + 1} new tokens over a {VC_PROMPT}-token prompt: prefill "
        f"{sec[0]:.3f}s ({VC_PROMPT / sec[0]:.0f} tokens/s), {step_ms:.2f} ms a step, peak "
        f"{peak:.1f} GiB ({peak - held:.2f} over the {held:.1f} held before); "
        f"launches {launches} [{card()}]")
    return tokens, sec, launches


def phase_vision_chat(fp32, vq):
    """See VC_*. Returns the launch counts of the counted runs."""
    tok = Tokenizer(str(FIXTURE_TOKENIZER))
    cfg = VideoLLaMAConfig.load_config("7b").replace(
        **VC_CONFIG, bos_token_id=tok.bos_token_id, eos_token_id=tok.eos_token_id)
    vmodel = vision_generation_model(cfg, fp32)
    plain = vision_generation_model(cfg, fp32, "plain")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 33)
    frames = torch.rand((VC_FRAMES, 256, 256, 3), generator=gen, device="cuda") * 2 - 1
    sampler = vision_chat.Sampler.from_model(vmodel, tok, VQGAN.from_model(vq), 0.2, SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = sampler.construct_input([dict(frames=frames, question=VC_QUESTION)], VC_FRAMES)
    encode_s = time.perf_counter() - t0
    ids, vm = batch["input_ids"][0], batch["vision_masks"][0]
    vision = ids[vm]
    n_real = int(batch["attention_mask"][0].sum())
    log(f"vision chat: {VC_FRAMES} frames encoded and the prompt built in {encode_s:.2f}s: "
        f"{ids.shape[0]} tokens, {n_real} real, {len(vision)} vision (EOF x "
        f"{int((vision == EOF).sum())}, EOV x {int((vision == EOV).sum())})")
    if (batch["input_ids"].shape != (1, VC_PROMPT) or len(vision) != VC_FRAMES * TOKENS_PER_FRAME
            or vision[-1] != EOV or int((vision == EOF).sum()) != VC_FRAMES - 1
            or not (vision[:-1][TOKENS_PER_FRAME - 1::TOKENS_PER_FRAME] == EOF).all()):
        raise AssertionError("vision chat: the prompt is not the bundle's layout")
    paths = []
    tokens, _, launches = _vision_chat_arm(sampler, batch,
                                           "vision chat (temperature 0.2, top-k 50)")
    paths.append(launches)
    answer = sampler.answers(torch.as_tensor(tokens)[None])[0]
    log(f"vision chat answer: {len(answer)} characters, {answer[:80]!r}")
    if not ((tokens >= 0) & (tokens < cfg.vocab_size)).all():
        raise AssertionError("vision chat: a new token outside the text vocabulary")

    sampler.top_k = 1
    greedy, _, launches = _vision_chat_arm(sampler, batch, "vision chat top-k 1")
    paths.append(launches)
    plain_sampler = vision_chat.Sampler.from_model(plain, tok, sampler.vqgan, 0.2, SEED)
    plain_sampler.top_k = 1
    want_tokens = _vision_chat_arm(plain_sampler, batch, "vision chat top-k 1, plain arm",
                                   counted=False)[0]
    on = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    got, want = (generation.prefill(m, on["input_ids"].long(), on["attention_mask"].long(),
                                    sampler.block_size, on["vision_masks"])[0]
                 for m in (vmodel, plain))
    rel = ((got - want).abs().max() / want.abs().max()).item()
    log(f"vision chat: prefill's last logits, kernel vs plain fp32 max|Δ|/max|plain| "
        f"{rel:.3e} (tol {NEEDLE_REL_TOL}), argmax {got.argmax(-1).tolist()} / "
        f"{want.argmax(-1).tolist()}")
    if not rel <= NEEDLE_REL_TOL:
        raise AssertionError("vision chat: prefill logits disagree with the plain fp32 path")
    apart = np.flatnonzero(greedy != want_tokens)
    if len(apart):
        at = int(apart[0])
        new = torch.as_tensor(want_tokens[:at], device="cuda")[None]
        ext = torch.cat([on["input_ids"].long(), new], 1)
        mask = torch.cat([on["attention_mask"].long(), torch.ones_like(new)], 1)
        vms = torch.cat([on["vision_masks"], torch.zeros(new.shape, dtype=torch.bool,
                                                         device="cuda")], 1)
        with torch.no_grad():
            lg = plain(ext, mask, (mask.cumsum(-1) - 1).clamp_min(0), vision_masks=vms,
                       logits_tail=1)[0, -1].float()
        top = lg.topk(2).values
        gap = (top[0] - top[1]).item()
        log(f"vision chat top-k 1: tokens apart from the plain arm's first at {at}; top-2 gap "
            f"there {gap:.2e} (near tie below {SPEC_TIE_GAP})")
        if not gap < SPEC_TIE_GAP:
            raise AssertionError("vision chat: top-k 1 tokens differ off a near tie")
    else:
        log(f"vision chat top-k 1: all {len(greedy)} tokens equal the plain arm's")
    del sampler, plain_sampler, vmodel, plain, got, want, on
    for name in ("vte.weight", "vision_head.weight"):
        del fp32[name]
    torch.cuda.empty_cache()
    return paths


# scripts/run_vqgan_128px_torch.sh's path (phase_train_vqgan): apps.train_vqgan's
# main in this process with the bundle's flags (TV_ARGS: 128 px, batch 16,
# channels 64 x 1,2,2,4, 2 res blocks, z 64, 1024 codes, 64 held-out crops)
# over TV_IMAGES synthetic photos from the seed (TV_SIZE pixels, smooth
# waves and noise, PNGs by utils.image.write_png: the card's machine has no
# photos and no PIL), TV_STEPS steps (cut from 4000) with revival every
# TV_REVIVE steps (cut from 200: it runs twice); each step's loss, the ms a
# step (median of steps 2 on), the round-trip line (PSNR, codebook usage) and
# the peak. Step 1 held to the same step on the host CPU: the CLI's seeded
# init and its first crops (RandomState(seed)) through a CPU copy, the loss
# at TV_LOSS_RTOL relative and the codes equal but at near ties (codes whose
# distances, in float64 from each path's z, are closer than the two paths'
# distances disagree). The path runs cuDNN's convolutions and no
# kernel of the port: its launch counts are all 0.
TV_ARGS = ("--resolution=128", "--batch=16", "--hidden_channels=64", "--channel_mult=1,2,2,4",
           "--num_res_blocks=2", "--z_channels=64", "--num_embeddings=1024", "--eval_crops=64")
TV_IMAGES, TV_SIZE, TV_STEPS, TV_REVIVE = 8, (160, 192), 20, 10
TV_LOSS_RTOL = 1e-5


def _tv_photos(work):
    rng = np.random.default_rng(SEED + 40)
    h, w = TV_SIZE
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(TV_IMAGES):
        fy, fx, phase = rng.uniform(0.01, 0.12, 3), rng.uniform(0.01, 0.12, 3), rng.uniform(0, 6, 3)
        wave = 127.5 + 90 * np.sin(yy[..., None] * fy + xx[..., None] * fx + phase)
        px = np.clip(wave + rng.normal(0, 15, (h, w, 3)), 0, 255).astype(np.uint8)
        write_png(work / f"photo{i}.png", px)


def phase_train_vqgan():
    """See TV_*. Returns the launch counts of its run."""
    work = Path(tempfile.mkdtemp(prefix="lwm_vq128_"))
    atexit.register(shutil.rmtree, work, True)
    _tv_photos(work)
    argv = [f"--image_dir={work}", f"--output={work / 'vqgan128.pkl'}", *TV_ARGS,
            f"--steps={TV_STEPS}", f"--revive_every={TV_REVIVE}", f"--seed={SEED}", *CLI_FLAGS]
    steps, revived, first = [], [], {}

    def record(step, info):
        if "revived" in info:
            revived.append((step, len(info["revived"][0])))
            return
        steps.append((info["loss"], info["rec"], time.perf_counter()))
        if step == 1:
            first["codes"] = info["codes"]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    _reset_launch_counts()
    out, _ = run_cli_in_process(lambda a: train_vqgan.main(a, record=record), argv,
                                "train_vqgan")
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    line = out.strip().splitlines()[-1]
    psnr = float(line.split("PSNR ")[1].split(" dB")[0])
    usage = int(line.split("codebook usage ")[1].split("/")[0])
    step_ms = 1e3 * float(np.median(np.diff([t for *_, t in steps])))
    for i, (loss, rec, _) in enumerate(steps):
        log(f"train_vqgan step {i + 1}: loss {loss:.6f} rec {rec:.6f}")
    log(f"train_vqgan: {line}")
    log(f"train_vqgan (128 px, batch 16, 1024 codes): {len(steps)} steps, {step_ms:.1f} ms a "
        f"step (median of steps 2-{len(steps)}), revivals {revived} (step, codes set), PSNR "
        f"{psnr:.2f} dB, usage {usage}/1024, peak {peak:.2f} GiB ({peak - held:.2f} over the "
        f"{held:.2f} held before); launches {launches} [{card()}]")
    if (any(launches.values()) or len(steps) != TV_STEPS
            or not all(math.isfinite(x) for s in steps for x in s[:2])
            or [s for s, _ in revived] != [TV_REVIVE, 2 * TV_REVIVE]
            or not (math.isfinite(psnr) and 0 < usage <= 1024)):
        raise AssertionError(f"train_vqgan: launches {launches}, {len(steps)} steps, revivals "
                             f"{revived}, {line!r}")

    # step 1 on the host CPU: the CLI's init and first crops
    args = train_vqgan.parse_args(argv)
    cfg = VQGANConfig.get_default_config(train_vqgan.config_updates(args))
    model = VQGANModel(cfg, device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(args.seed))
    host = VQGANModel(cfg, device="meta")
    host.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, assign=True)
    x = train_vqgan.crop_batch(train_vqgan.load_images(str(work), args.resolution),
                               np.random.RandomState(args.seed), args.batch, args.resolution)
    t0 = time.perf_counter()
    with torch.no_grad():
        loss, _, codes = train_vqgan.objective(host, torch.from_numpy(x), args.beta)
    host_s = time.perf_counter() - t0
    # a near tie: two codes closer than the two paths' distances disagree
    # (twice the largest disagreement in float64, plus the quantizer's own
    # fp32 rounding of the largest distance)
    with torch.no_grad(), full_fp32():
        d = _vq_distances(model, model.train_forward(torch.from_numpy(x).cuda())[1]).cpu()
        d_host = _vq_distances(host, host.train_forward(torch.from_numpy(x))[1])
    tie = 2 * (d - d_host).abs().max().item() + 8 * np.finfo(np.float32).eps * d.max().item()
    top2 = d.topk(2, -1, largest=False).values
    gaps = top2[:, 1] - top2[:, 0]
    near = (gaps < tie).numpy()
    apart = codes.numpy().reshape(-1) != first["codes"].reshape(-1)
    rel = abs(loss.item() - steps[0][0]) / abs(steps[0][0])
    log(f"train_vqgan step 1 on the host CPU ({host_s:.1f}s): loss {loss.item():.7f} vs the "
        f"card's {steps[0][0]:.7f} (relative {rel:.2e}, tol {TV_LOSS_RTOL}); codes apart at "
        f"{np.flatnonzero(apart).tolist()} of {apart.size}; near ties (top-2 gap below "
        f"{tie:.2e}) {int(near.sum())}, median gap {gaps.median().item():.2e}")
    if not rel <= TV_LOSS_RTOL or (apart & ~near).any():
        raise AssertionError("train_vqgan: the card's step 1 disagrees with the host CPU's")
    del model, host, d
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


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
        run_cli_in_process(vision_app.main, base + [f"--output_file={tmp / 'sub.png'}"],
                           "cli vision generation, first")
        _reset_launch_counts()
        with recorded_forwards() as forwards:
            run_cli_in_process(vision_app.main, base + [f"--output_file={tmp / 'main.png'}"],
                               "cli vision generation")
        launches = _launch_counts()
        sub, main_png = read_png(tmp / "sub.png"), read_png(tmp / "main.png")
    want = _generation_launches(cfg, dict(forwards=len(forwards)), f32=True)
    log(f"cli vision generation: PNG {sub.shape}, {len(forwards)} tokens; the two runs' pixels "
        f"equal: {np.array_equal(sub, main_png)}; launches {launches}")
    if sub.shape != (256, 256, 3) or launches != want:
        raise AssertionError(f"cli vision generation: PNG {sub.shape}, launches {launches} "
                             f"(want {want})")
    if not np.array_equal(sub, main_png):
        raise AssertionError("cli vision generation: two runs of the same flags and seed wrote "
                             "different PNGs")
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


# The kernel path at fp32 compute (K1's and the backward's fp32 routes) held
# to the float64 step on the same weights and batch (phase_train_compare's
# fourth arm, `f64_arm`): the loss within F32_LOSS_RTOL relative, every
# parameter's grad within F32_GRAD_REL_TOL of the float64 grad's largest
# |element| (the fp32 suite's 1e-5), the plain fp32 path's distance logged
# beside
F32_LOSS_RTOL = 1e-6
F32_GRAD_REL_TOL = 1e-5


def phase_train_compare(vision=False):
    """One train step's loss and grads at 7b width (2 layers, seq 4096):
    the kernel path vs attn_impl="plain" on the same fp32 weights (both
    computing in bf16), each held to an fp32 copy; and the kernel path at
    fp32 compute held to the float64 step (F32_*, `f64_arm`). With `vision`, a
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

    # the fp32 kernel arm, held to the float64 step: one backward launch a
    # layer on the fp32 route
    layers = cfg.num_hidden_layers
    t0 = time.perf_counter()
    ref = f64_step(kernel, batch)
    log(f"{what} fp32 kernel arm: fwd+bwd {t_k32:.2f}s (unwarmed); the float64 step "
        f"{time.perf_counter() - t0:.2f}s; launches {n_k32}" + (f"; metrics {a_k32}" if vision
                                                                else ""))
    f64_arm(what, ref, {"fp32 kernel": (l_k32, g_k32), "plain fp32": (l_32, g_32)},
            held=("fp32 kernel",), plain="plain fp32")
    del ref
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


def phase_train_full(profile=None, dtype=BF16, steps=6):
    """The 7b width at 16 of its 32 layers, `steps` AdamW steps computing in
    `dtype` (bf16; fp32 for phase_train_f32: K1's and the backward's fp32
    routes, each launched exactly layers x steps under save_flash) (then,
    with a `profile` directory, one profiled step). Returns the launch
    counts of the run and its median step time."""
    layers, b, s = 16, 2, 4096
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
    the 7b width at 16 layers, 2 x 4096, 4 steps (phase_train_full's 6,
    cut for room) on K1's and the backward's fp32 routes. Returns the launch
    counts."""
    return phase_train_full(dtype=torch.float32, steps=4)[0]


# The float64 arm: an fp32 path's train step held to the same step in
# float64 (`f64_step`: the model's arithmetic in plain torch, every operation
# in float64, on the same weights cast up and the same batch), not to a
# second fp32 run: two fp32 runs differ by both their noises. Each held fp32
# path's loss within F32_LOSS_RTOL of the float64 loss, and each gradient
# within F32_GRAD_REL_TOL of the float64 gradient in two measures: the
# relative L2 distance ‖g − g64‖ / ‖g64‖, and the largest |element| distance
# over the largest |g64| element. Where the plain fp32 path (no kernel,
# measured beside) itself misses F32_GRAD_REL_TOL in a measure, the held
# path may sit at most FLOOR_RATIO x the plain path's distance there, as
# bf16 paths are held to their noise floor: at the 7b width every fp32
# path's wq and wk gradients of layer 1 sit 1.3-1.5e-5 from float64 in both
# measures (ds = p·(dp − delta) cancels over near-uniform attention), the
# plain one's included (PERF.md §6).
F64_ATTN_CHUNK = 1024   # queries a float64 attention chunk (recomputed in the backward)


def _attend_f64(q, k, v, chunk=F64_ATTN_CHUNK):
    """Causal softmax attention in float64 over `chunk` queries at a time,
    each chunk's scores recomputed in the backward; q [b, s, h, d], k, v
    [b, s, h_kv, d] (kv head i serves query heads i·g .. i·g + g − 1)."""
    from torch.utils.checkpoint import checkpoint

    b, s, h, d = q.shape
    k, v = (x.repeat_interleave(h // x.shape[2], 2) for x in (k, v))

    def part(qc, kc, vc, c0):
        x = torch.einsum("bqhd,bkhd->bhqk", qc, kc) * d ** -0.5
        pos = c0 + torch.arange(qc.shape[1], device=q.device)
        x = x.masked_fill(torch.arange(kc.shape[1], device=q.device)[None] > pos[:, None],
                          float("-inf"))
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(x, -1), vc)

    return torch.cat([checkpoint(part, q[:, c0:c0 + chunk], k[:, :c0 + chunk],
                                 v[:, :c0 + chunk], c0, use_reentrant=False)
                      for c0 in range(0, s, chunk)], 1)


def _ce_f64(logits, tokens, valid):
    """`cross_entropy_loss_and_accuracy`'s loss in float64."""
    lp = torch.log_softmax(logits, -1).gather(-1, tokens.long()[..., None])[..., 0]
    lp = torch.where(valid > 0, lp, 0.0)
    return -(lp.sum(-1) / valid.double().sum(-1).clamp_min(1e-10)).mean()


def f64_step(model, batch):
    """The float64 arm of one train step of `model` (LLaMA or, with vision
    masks, VideoLLaMA with the dual loss) on `batch`: (loss, {name: grad}),
    float64. The weights are the model's parameters cast up; RoPE reads the
    model's own table (its fp32 constants); nothing runs a kernel."""
    cfg, f64 = model.config, torch.float64
    w = {n: p.detach().to(f64).requires_grad_() for n, p in model.named_parameters()}
    ids = batch["input_tokens"]
    b, s = ids.shape
    h, d = cfg.num_attention_heads, cfg.head_dim
    cos, sin = (t.to(f64)[:, :, None, :] for t in llama_module.take_freqs(
        model._rope_table(ids.device), torch.arange(s, device=ids.device).expand(b, s)))

    def norm(x, name):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + cfg.rms_norm_eps) * w[name]

    def rope(x):
        x0, x1 = x.reshape(*x.shape[:-1], -1, 2).unbind(-1)
        return torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], -1).reshape(x.shape)

    def dense(x, name):
        return x @ w[name].T

    vision = model.takes_vision_masks
    x = w["wte.weight"][ids]
    if vision:
        vm = batch["input_vision_masks"].bool()
        x = torch.where(vm[..., None], w["vte.weight"][torch.where(vm, ids, 0)],
                        w["wte.weight"][torch.where(vm, 0, ids)])
    for i in range(cfg.num_hidden_layers):
        p = f"h.{i}."
        y = norm(x, p + "attention_norm.weight")
        q = rope(dense(y, p + "attention.wq.weight").view(b, s, h, d))
        k = rope(dense(y, p + "attention.wk.weight").view(b, s, -1, d))
        v = dense(y, p + "attention.wv.weight").view(b, s, -1, d)
        x = x + dense(_attend_f64(q, k, v).reshape(b, s, h * d), p + "attention.wo.weight")
        y = norm(x, p + "ffn_norm.weight")
        x = x + dense(F.silu(dense(y, p + "feed_forward.w1.weight"))
                      * dense(y, p + "feed_forward.w3.weight"), p + "feed_forward.w2.weight")
    x = norm(x, "ln_f.weight")
    logits = x @ w["lm_head.weight" if "lm_head.weight" in w else "wte.weight"].T
    tokens, valid = batch["target_tokens"], batch["loss_masks"].double()
    if vision:
        tv = batch["target_vision_masks"].bool()
        vlogits = x @ w["vision_head.weight" if "vision_head.weight" in w else "vte.weight"].T
        loss = 0.5 * (_ce_f64(vlogits, torch.where(tv, tokens, 0), valid * tv)
                      + _ce_f64(logits, torch.where(tv, 0, tokens), valid * ~tv))
    else:
        loss = _ce_f64(logits, tokens, valid)
    loss.backward()
    return loss.item(), {n: t.grad for n, t in w.items()}


def _f64_distances(grads, ref_grads):
    """{param: (‖Δ‖/‖g64‖, max|Δ|/max|g64|)} of fp32 grads from float64 ones."""
    out = {}
    for n, g in ref_grads.items():
        d = grads[n].double() - g
        out[n] = ((d.norm() / g.norm().clamp_min(1e-300)).item(),
                  (d.abs().max() / g.abs().max().clamp_min(1e-300)).item())
    return out


def f64_arm(what, ref, paths, held, plain=None):
    """Hold each of `held` (names of `paths`: {name: (loss, {param: grad})})
    to the float64 step `ref` (loss, grads) as the comment above says, the
    path named `plain` (the plain fp32 path, when given) as the floor; every
    path's distances are logged. Returns {path: its largest max-element
    distance}."""
    ref_loss, ref_grads = ref
    dist = {name: _f64_distances(grads, ref_grads) for name, (_, grads) in paths.items()}
    losses = {name: abs(loss - ref_loss) / abs(ref_loss) for name, (loss, _) in paths.items()}
    for name, (loss, _) in paths.items():
        l2, l2_at = max((d[0], n) for n, d in dist[name].items())
        mx, mx_at = max((d[1], n) for n, d in dist[name].items())
        log(f"{what} float64 arm, {name}: loss {loss:.8f} vs float64 {ref_loss:.8f} (relative "
            f"{losses[name]:.3e}, tol {F32_LOSS_RTOL}); largest grad ‖Δ‖/‖float64‖ {l2:.3e} "
            f"({l2_at}), largest max|Δ|/max|float64| {mx:.3e} ({mx_at}; tol "
            f"{F32_GRAD_REL_TOL})" + ("" if name in held else " (logged, not held)"))
    floor = dist.get(plain, {})
    for name in held:
        over = []
        for n, got in dist[name].items():
            for m, measure in enumerate(("‖Δ‖/‖float64‖", "max|Δ|/max|float64|")):
                fl = floor[n][m] if n in floor else 0.0
                limit = FLOOR_RATIO * fl if fl > F32_GRAD_REL_TOL else F32_GRAD_REL_TOL
                if not got[m] <= limit:
                    over.append((n, measure, got[m], limit))
                elif got[m] > F32_GRAD_REL_TOL:
                    log(f"{what} float64 arm, {name}: {n} {measure} {got[m]:.3e}, held to "
                        f"{FLOOR_RATIO} x the plain fp32 path's {fl:.3e}")
        if not (math.isfinite(paths[name][0]) and losses[name] <= F32_LOSS_RTOL) or over:
            raise AssertionError(f"{what}: the {name} path's step leaves the float64 step's: "
                                 f"loss {losses[name]:.3e}, grads {over}")
    return {name: max(d[1] for d in dist[name].values()) for name in paths}


# The ring on the card (phase_train_ring): two ranks share the one card
# (gloo: NCCL refuses two ranks on one device; the ring's blocks are staged
# through host memory) and train through lwm_tpu_torch.train's step on a
# mesh of sp 2 (`1,1,1,2`), each reading the global batch and keeping its
# slice, the weights and moments sharded over sp (`parallel.fsdp`), in both
# layouts:
# (a) the 7b width at RING_A_LAYERS layers, bf16 compute, save_flash, one row
#     of RING_A_SEQ (RING_A_SEQ / 2 a rank), RING_A_STEPS AdamW steps
#     (TRAIN_CLI_OPT), the losses held to a one-rank run of the same steps
#     at FLOOR_RATIO x the bf16 noise floor (the one-rank run against an
#     fp32 one of the same weights and batch) + FUSED_SLACK;
# (b) run_context_extension.sh's 32K stage's model whole (CTX_BASE_CFG at
#     its seq, theta and chunk: 6 layers of 768, 6 heads of 128, fp32,
#     nothing_saveable), one row of 32768 random tokens, the stage's AdamW,
#     2 steps; step 1's loss and gradients, and a one-rank run's, held to
#     the float64 step (f64_arm), both steps' losses to the one-rank run's
#     at F32_LOSS_RTOL.
# Each rank checks its exact K1 and backward launches (ring_launches); each
# layout's step time is logged beside its exchanges' time: the weights'
# gathers and the gradients' reduce-scatter (the Mesh collectives) timed
# inside the steps (synchronised), the ring's blocks timed alone (an upper
# bound of what the step spends on them: in the step they overlap the
# kernels). Two ranks on one card measure correctness and the exchange's
# cost, not multi-GPU speed. (a) runs 2 of the 7b's 32 layers for room: the
# weights' host-staged gathers (~0.6 GB/s) set its step.
RING_A_LAYERS, RING_A_SEQ, RING_A_STEPS = 2, 8192, 2
RING_B_STEPS = 2
RING_LAYOUTS = ("contiguous", "striped")


def ring_launches(rank, sp, layout, remat, layers, steps):
    """K1's and the backward's launches on one rank of a ring: a step
    computes every block in the striped layout and blocks 0..rank in the
    contiguous one (the later ones are wholly masked), a layer a step, K1
    twice under nothing_saveable (the backward replays the block)."""
    blocks = sp if layout == "striped" else rank + 1
    fwd = layers * steps * blocks
    return dict(flash_fwd=fwd * (2 if remat == "nothing_saveable" else 1), flash_bwd=fwd)


def _ring_runs():
    """(name, spec) of phase_train_ring's runs."""
    runs = []
    for layout in RING_LAYOUTS:
        runs.append((f"a_{layout}", dict(
            kind="a", layout=layout, steps=RING_A_STEPS, dtype="bf16", seq=RING_A_SEQ)))
    for layout in RING_LAYOUTS:
        runs.append((f"b_{layout}", dict(
            kind="b", layout=layout, steps=RING_B_STEPS, dtype="fp32", seq=32768)))
    return runs


def _ring_model(kind, dtype):
    """(model, optimizer config, batch) of a ring run: the same weights
    (from the seed, on the card) and the same global batch on every rank."""
    if kind == "a":
        cfg = train.build_model_config("7b", update_llama_config=dict(
            num_hidden_layers=RING_A_LAYERS, max_sequence_length=RING_A_SEQ))
        opt, seq, seed = dict(adamw_optimizer=TRAIN_CLI_OPT), RING_A_SEQ, SEED + 8
    else:
        _, seq, theta, total, _, _, chunk, lr, _ = CTX_STAGES[-1]
        cfg = _ctx_config(seq, theta, chunk)
        # the stage's AdamW, its warm-up started one step in (init_lr = lr /
        # 100, the stage's second step's), so that step 1 moves the weights
        opt = dict(adamw_optimizer=dict(init_lr=float(lr) / 100, lr=float(lr), end_lr=1e-4,
                                        lr_warmup_steps=100, lr_decay_steps=total))
        seed = SEED + 9
    model = LLaMAForCausalLM(cfg, dtype=dtype, param_dtype=torch.float32, device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(seed))
    batch = _lm_batch(1, seq, cfg.vocab_size, seed)
    return model, opt, {k: v.cpu().numpy() for k, v in batch.items()}


def _train_steps(model, opt, batch, steps, keep_grads=False):
    """`steps` train steps (train.train_step) on `batch`: (losses, step
    seconds, step 1's gradients after any all-reduce, or None)."""
    state = train.create_train_state(model, opt)
    grads = {}
    if keep_grads:
        step = state.optimizer.step

        def keep():   # whole over the ranks' shards (every rank gathers)
            if not grads:
                places = model.placements
                grads.update({n: places[n].whole(p.grad.detach()).clone()
                              for n, p in model.named_parameters()})
            step()

        state.optimizer.step = keep
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        m = train.train_step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(m["loss"].item())
    return losses, times, grads or None


def _ring_seconds(model, batch_shape, exchange, dtype):
    """The ring's exchanges of one step alone (synchronised, each the median
    of 3): a layer's k and v blocks once in the forward (twice when the
    backward replays it), once in the backward with dk and dv (fp32)."""
    cfg = model.config
    b, s = batch_shape
    blk = torch.zeros((b, s, cfg.kv_heads, cfg.head_dim), dtype=dtype, device="cuda")
    blk32 = blk.float()

    def timed(fn):
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    kv = timed(lambda: exchange.finish(exchange.start((blk, blk))))
    dkv = timed(lambda: exchange.finish(exchange.start((blk32, blk32), tag=2)))
    fwd_passes = 2 if cfg.remat_block == "nothing_saveable" else 1
    return (cfg.num_hidden_layers * (exchange.size - 1) * ((fwd_passes + 1) * kv)
            + cfg.num_hidden_layers * exchange.size * dkv)


def _timed_all_reduce(seconds):
    """train.all_reduce_grads, synchronised and its seconds appended to
    `seconds` (the gradients' all-reduce of each step)."""
    real = train.all_reduce_grads

    def timed(params, group=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real(params, group)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)

    return timed


def _ring_rank(rank, port, workdir, t_spawn):
    """One of the two ranks that phase_train_mesh, phase_train_ring and
    phase_serve_mesh share (spawned once): the fsdp × tp parts
    (train_mesh_rank), every run of _ring_runs on a mesh of sp 2, then the
    serving parts (serve_mesh_rank); results to workdir."""
    import torch.distributed as dist

    from lwm_tpu_torch.data.text import shard_batch
    from lwm_tpu_torch.ops.ring import RingExchange
    from lwm_tpu_torch.parallel.mesh import create_mesh, get_ranks_and_size

    t_entry = time.time()
    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    train_all_reduce = train.all_reduce_grads
    results = {"_spawn": dict(imports_s=t_entry - t_spawn, build_s=build_s)}
    try:
        results["_train_mesh"] = train_mesh_rank(rank)
        _free_card()
        torch.cuda.reset_peak_memory_stats()
        for name, spec in _ring_runs():
            model, opt, batch = _ring_model(spec["kind"], BF16 if spec["dtype"] == "bf16"
                                            else torch.float32)
            mesh = create_mesh("1,1,1,2", "cuda", spec["layout"])
            model.mesh = mesh
            part = {k: torch.from_numpy(v).cuda() for k, v in shard_batch(
                {k: batch[k] for k in ("input_tokens", "target_tokens", "loss_masks")},
                get_ranks_and_size(mesh)).items()}
            _reset_launch_counts()
            reduce_s, shard_s = [], []
            train.all_reduce_grads = _timed_all_reduce(reduce_s)
            with _timed_mesh_collectives(shard_s):
                losses, times, grads = _train_steps(model, opt, part, spec["steps"],
                                                    keep_grads=spec["kind"] == "b")
            train.all_reduce_grads = train_all_reduce
            launches = _launch_counts()
            ring_s = _ring_seconds(model, part["input_tokens"].shape,
                                   RingExchange(mesh.group("sp")), model.dtype)
            reduce_s = float(np.median(reduce_s[1:]))
            want = ring_launches(rank, 2, spec["layout"], model.config.remat_block,
                                 model.config.num_hidden_layers, spec["steps"])
            if spec["dtype"] == "fp32":
                want.update(flash_fwd_f32=want["flash_fwd"], flash_bwd_f32=want["flash_bwd"])
            results[name] = dict(losses=losses, times=times, launches=launches, want=want,
                                 ring_s=ring_s, reduce_s=reduce_s,
                                 shard_s=sum(shard_s) / spec["steps"],
                                 peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            if grads is not None and rank == 0:
                torch.save({n: g.cpu() for n, g in grads.items()}, Path(workdir) / f"{name}.pt")
            del model, grads, part
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        results["_serve_mesh"] = serve_mesh_rank(rank, Path(workdir))
    finally:
        (Path(workdir) / f"rank{rank}.json").write_text(json.dumps(results))
        dist.destroy_process_group()


def spawn_mesh_ranks(work):
    """The two ranks on the card (gloo) that phase_train_mesh, phase_train_ring and
    phase_serve_mesh read: one spawn, one import and one kernel load for
    both. Writes phase_serve_mesh's eval inputs first. Returns (each rank's
    results, the spawn's wall seconds)."""
    import socket

    import torch.multiprocessing as mp

    torch.cuda.empty_cache()
    write_mesh_eval_inputs(work)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    mp.spawn(_ring_rank, args=(port, str(work), time.time()), nprocs=2, join=True)
    wall = time.perf_counter() - t0
    ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(2)]
    spawn = [r["_spawn"] for r in ranks]
    log(f"mesh ranks: two ranks on the card (gloo), {wall:.1f}s of wall: spawn and imports "
        f"{max(x['imports_s'] for x in spawn):.1f}s, kernel loads "
        f"{max(x['build_s'] for x in spawn):.2f}s (built once by phase_build), then the "
        f"training runs and the serving parts [{card()}]")
    return ranks, wall


def phase_train_ring(ranks, work):
    """See RING_* and ring_launches: the two ranks' runs (spawn_mesh_ranks),
    then the one-rank runs and the float64 step they are held to. Returns
    the launch counts of every rank's runs."""
    grads_b = {name: torch.load(work / f"{name}.pt")
               for name, spec in _ring_runs() if spec["kind"] == "b"}
    paths = []
    for name, spec in _ring_runs():
        for r in range(2):
            got = ranks[r][name]
            paths.append(got["launches"])
            step_s = float(np.median(got["times"][1:]))
            log(f"train ring {name} rank {r}: losses {[round(x, 6) for x in got['losses']]}, "
                f"steps {', '.join(f'{t:.3f}' for t in got['times'])} s (median of steps 2-"
                f"{spec['steps']} {step_s:.3f} s); a step's exchanges: the weights' gathers and "
                f"the gradients' reduce-scatter over sp (the Mesh collectives) {got['shard_s']:.3f} "
                f"s a step ({100 * got['shard_s'] / step_s:.1f}%), of them the norms' gradients' "
                f"all-reduce {got['reduce_s']:.3f} s, the "
                f"ring's blocks {got['ring_s']:.3f} s timed alone ({100 * got['ring_s'] / step_s:.1f}"
                f"%, overlapping the kernels in the step); peak "
                f"{got['peak_gib']:.1f} GiB; launches {got['launches']} (want {got['want']}) "
                f"[{card()}]")
            if any(got["launches"][k] != v for k, v in got["want"].items()):
                raise AssertionError(f"train ring {name} rank {r}: launches {got['launches']}, "
                                     f"want {got['want']}")
        if ranks[0][name]["losses"] != ranks[1][name]["losses"]:
            raise AssertionError(f"train ring {name}: the ranks' losses differ")

    # (a): the one-rank runs, bf16 and fp32 (the noise floor)
    one = {}
    for dtype in (BF16, torch.float32):
        model, opt, batch = _ring_model("a", dtype)
        batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
        one[dtype] = _train_steps(model, opt, batch, RING_A_STEPS)[:2]
        del model
        torch.cuda.empty_cache()
    (l_one, t_one), (l_32, _) = one[BF16], one[torch.float32]
    for layout in RING_LAYOUTS:
        l_ring = ranks[0][f"a_{layout}"]["losses"]
        for i, (a, o, f) in enumerate(zip(l_ring, l_one, l_32)):
            floor = abs(o - f)
            log(f"train ring a_{layout} step {i + 1}: loss sp 2 {a:.6f}, one rank {o:.6f}, one "
                f"rank fp32 {f:.6f}: |sp 2 - one rank| {abs(a - o):.2e}, the bf16 floor "
                f"|one rank - fp32| {floor:.2e} (limit {FLOOR_RATIO} x floor + {FUSED_SLACK})")
            if not (math.isfinite(a) and abs(a - o) <= FLOOR_RATIO * floor + FUSED_SLACK):
                raise AssertionError(f"train ring a_{layout}: step {i + 1}'s loss leaves the "
                                     "one-rank run's by more than the bf16 noise floor")
    log(f"train ring (a): one rank's step (1 x {RING_A_SEQ}) median {np.median(t_one[1:]):.3f} s "
        f"[{card()}]")

    # (b): the one-rank run and the float64 step
    model, opt, batch = _ring_model("b", torch.float32)
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    ref = f64_step(model, batch)
    torch.cuda.empty_cache()
    l_b, t_b, g_b = _train_steps(model, opt, batch, RING_B_STEPS, keep_grads=True)
    del model
    torch.cuda.empty_cache()
    f64_paths = {"one rank": (l_b[0], g_b)}
    for layout in RING_LAYOUTS:
        got = ranks[0][f"b_{layout}"]["losses"]
        f64_paths[f"sp 2 {layout}"] = (got[0], {n: g.cuda() for n, g in grads_b[
            f"b_{layout}"].items()})
        rel = max(abs(a - o) / abs(o) for a, o in zip(got, l_b))
        log(f"train ring b_{layout}: losses sp 2 {got}, one rank {l_b} (largest relative "
            f"{rel:.3e}, tol {F32_LOSS_RTOL})")
        if not rel <= F32_LOSS_RTOL:
            raise AssertionError(f"train ring b_{layout}: the losses leave the one-rank run's")
    f64_arm("train ring (b) step 1", ref, f64_paths, held=tuple(f64_paths))
    log(f"train ring (b): one rank's step (1 x 32768, fp32) median {np.median(t_b[1:]):.3f} s "
        f"[{card()}]")
    del ref, f64_paths, grads_b, g_b
    torch.cuda.empty_cache()
    return paths


# phase_train_mesh: fsdp × tp training, run in the two ranks that
# phase_train_ring spawns (spawn_mesh_ranks: no new spawn, import or kernel
# load), both on the one card over gloo, so every exchange (the weights'
# gathers and the gradients' reduce-scatter over fsdp, the blocks'
# all-reduces and the logits' gather over tp) is staged through host memory:
# its times are gloo's, not NVLink's. The 7b width at MESH_T_LAYERS layers,
# MESH_T_BATCH × MESH_T_SEQ (the bundle's seq_length), save_flash, the weights
# from MESH_T_SEED drawn whole and cut to each rank's part (`init_weights`):
# (a) fsdp 2 ("1,2,1,1"), fp32, MESH_T_STEPS AdamW steps of MESH_T_OPT: each
#     step's loss, whole gradients and whole params after it held to a
#     one-rank run of the kernel path from the same seed and batch at
#     MESH_T_TOL in relative L2 and in max |Δ| / max |want|; a gradient leaf
#     that misses is held by the float64 step at the one-rank run's params
#     of that step (the one-rank path's distance to it the floor: within
#     FLOOR_RATIO × that floor where it exceeds MESH_T_TOL, `f64_arm`'s
#     rule: no fp32 path reaches 1e-5 on the random init's wq and wk); MESH_T_OPT's lr keeps the sign of an
#     Adam update whose gradient lies within float noise of 0 (±lr, the
#     summation order's) below the params' bound;
# (b) tp 2 ("1,1,2,1"): one fp32 step held as in (a), then MESH_T_BF16_STEPS
#     bf16 steps with the bundle's AdamW settings (TRAIN_CLI_OPT), their
#     losses held to a one-rank bf16 run at FLOOR_RATIO × the bf16 noise
#     floor (the one-rank bf16 run against an fp32 one) + FUSED_SLACK, as
#     phase_train_ring (a) holds its losses.
# Each rank's parts are compared with the same parts of the one-rank run,
# which each rank makes in turn (the other waits), so no rank holds two
# whole states; the distances are summed (and maxed) over the ranks. Each
# rank checks its exact K1 and backward launches; each part logs its step
# time, its exchanges' seconds (every Mesh collective synchronised and
# timed) and each rank's peak memory and state bytes beside the one-rank
# run's.
MESH_T_LAYERS, MESH_T_SEQ, MESH_T_BATCH, MESH_T_STEPS, MESH_T_BF16_STEPS = 4, 2048, 2, 2, 2
MESH_T_SEED = SEED + 31
MESH_T_TOL = 1e-5
MESH_T_OPT = dict(adamw_optimizer=dict(init_lr=2e-7, lr=2e-7, end_lr=2e-7, lr_warmup_steps=1,
                                       lr_decay_steps=10, weight_decay=0.1))


def _mesh_t_config():
    return train.build_model_config("7b", update_llama_config=dict(
        num_hidden_layers=MESH_T_LAYERS, max_sequence_length=MESH_T_SEQ))


def _mesh_t_model(dtype, mesh=None, opt=MESH_T_OPT):
    """(state, the global batch) of a phase_train_mesh run: the model (on
    `mesh`, sharded by create_train_state) from MESH_T_SEED, the optimizer
    of `opt`."""
    cfg = _mesh_t_config()
    model = LLaMAForCausalLM(cfg, dtype=dtype, param_dtype=torch.float32, device="cuda",
                             mesh=mesh)
    state = train.create_train_state(model, opt)
    model.init_weights(torch.Generator(device="cuda").manual_seed(MESH_T_SEED))
    return state, _lm_batch(MESH_T_BATCH, MESH_T_SEQ, cfg.vocab_size, MESH_T_SEED)


@contextlib.contextmanager
def _timed_mesh_collectives(seconds, by_kind=None):
    """Every Mesh collective synchronised, its seconds appended to `seconds`
    (and summed by its name into `by_kind`, when given)."""
    from lwm_tpu_torch.parallel.mesh import Mesh

    names = ("all_reduce", "all_gather", "reduce_scatter")
    real = {n: getattr(Mesh, n) for n in names}

    def timed(fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            if by_kind is not None:
                by_kind[fn.__name__] = by_kind.get(fn.__name__, 0.0) + seconds[-1]
            return out
        return call

    for n in names:
        setattr(Mesh, n, timed(real[n]))
    try:
        yield
    finally:
        for n in names:
            setattr(Mesh, n, real[n])


def _mesh_t_steps(state, batch, steps, keep=None):
    """`steps` train steps; `keep(i, kind, {name: tensor})`, when given,
    sees step i's gradients ("grad", before the update) and params
    ("param", after it), this rank's parts. Returns (losses, step seconds)."""
    opt, model = state.optimizer, state.model
    real, at = opt.step, [0]

    def step():
        keep(at[0], "grad", {n: p.grad for n, p in model.named_parameters()})
        real()

    if keep is not None:
        opt.step = step
    losses, times = [], []
    try:
        for i in range(steps):
            at[0] = i
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = train.train_step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(m["loss"].item())
            if keep is not None:
                keep(i, "param", dict(model.named_parameters()))
    finally:
        if keep is not None:
            del opt.step   # no cycle through a bound method: the state frees when dropped
    return losses, times


def _free_card():
    """Collect what the card's tensors' last references left (cycles too)
    and give the cache back, so the other rank sharing the card has it."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _state_gib(state):
    """The bytes of this rank's params, gradients' size and moments (GiB)."""
    params = list(state.model.parameters())
    n = sum(2 * p.numel() * p.element_size() for p in params)   # the param and its gradient
    n += sum(t.numel() * t.element_size() for st in state.optimizer.state.values()
             for t in st.values())
    return n / 2**30


# the columns of a distance row: sums over the ranks, the others maxima
_DIST_SUMS = (0, 1, 4, 5, 8)


def _part_distance(pl, rank, a, b, c=None):
    """This rank's part `a` of a leaf against the same part `b` of the
    one-rank run (and `c` of the float64 step): [Σ(a−b)², Σb², max|a−b|,
    max|b|, Σ(b−c)², Σc², max|b−c|, max|c|, Σ(a−c)², max|a−c|] (the last
    six 0 without `c`), float64 on the host; zeros where another rank
    counts the same part (a leaf held whole)."""
    if not (pl.over_tp or pl.over_shard or rank == 0):
        return torch.zeros(10, dtype=torch.float64)
    a, b = a.double(), b.double()
    d = a - b
    out = [d.square().sum(), b.square().sum(), d.abs().max(), b.abs().max()]
    if c is None:
        out += [torch.zeros((), device=a.device, dtype=torch.float64)] * 6
    else:
        c = c.double()
        bc, ac = b - c, a - c
        out += [bc.square().sum(), c.square().sum(), bc.abs().max(), c.abs().max(),
                ac.square().sum(), ac.abs().max()]
    return torch.stack(out).cpu()


def _distances(rows):
    """{key: the whole leaf's (rel L2, max/max) of the mesh from the one-rank
    run, and with the float64 step the one-rank run's and the mesh's from
    it} from rows summed and maxed over the two ranks."""
    import torch.distributed as dist

    keys = sorted(rows)
    stats = torch.stack([rows[k] for k in keys])
    s, m = stats.clone(), stats.clone()
    dist.all_reduce(s)
    dist.all_reduce(m, op=dist.ReduceOp.MAX)
    stats = torch.where(torch.tensor([c in _DIST_SUMS for c in range(10)]), s, m)
    out = {}
    for k, x in zip(keys, stats.tolist()):
        d = dict(l2=(x[0] / max(x[1], 1e-300)) ** 0.5, max=x[2] / max(x[3], 1e-300))
        if x[5] > 0:   # the float64 step
            d.update(ref_l2=(x[4] / x[5]) ** 0.5, ref_max=x[6] / x[7],
                     f64_l2=(x[8] / x[5]) ** 0.5, f64_max=x[9] / x[7])
        out[k] = d
    return out


def _mesh_t_part(rank, mesh_dim, dtype, opt, steps, held):
    """One part's mesh run and, with `held`, its holds: this rank's parts of
    each step's gradients and params against the one-rank run's (and each
    step's gradients against the float64 step), the one-rank run made by
    each rank in turn. Returns the part's readings."""
    import torch.distributed as dist

    from lwm_tpu_torch.data.text import shard_batch
    from lwm_tpu_torch.parallel.mesh import create_mesh, get_ranks_and_size

    mesh = create_mesh(mesh_dim, "cuda")
    _free_card()
    torch.cuda.reset_peak_memory_stats()
    state, batch = _mesh_t_model(dtype, mesh, opt)
    part = {k: torch.from_numpy(v).cuda() for k, v in shard_batch(
        {k: v.cpu().numpy() for k, v in batch.items()}, get_ranks_and_size(mesh)).items()}
    _reset_launch_counts()
    exchange, records, by_kind = [], {}, {}

    def record(i, kind, named):
        records[(i, kind)] = {n: t.detach().clone() for n, t in named.items()}

    with _timed_mesh_collectives(exchange, by_kind):
        losses, times = _mesh_t_steps(state, part, steps, record if held else None)
    got = dict(losses=losses, times=times, exchange_s=sum(exchange), exchanges=len(exchange),
               exchange_by_kind=by_kind,
               launches=_launch_counts(), peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               state_gib=_state_gib(state))
    places = state.model.placements
    del state, part
    _free_card()
    rows = {}
    for turn in range(2):   # the one-rank run, one rank at a time
        dist.barrier()
        if rank != turn or not (held or rank == 0):
            continue
        torch.cuda.reset_peak_memory_stats()
        ref_state, _ = _mesh_t_model(dtype, None, opt)
        f64, f64_losses = {}, []

        def float64(i):   # this rank's parts of the float64 step's gradients at step i
            loss, grads = f64_step(ref_state.model, batch)
            f64_losses.append(loss)
            f64[i] = {n: places[n].local_part(g) for n, g in grads.items()}
            del grads
            _free_card()

        def compare(i, kind, named):   # the one-rank run's whole tensors, as they come
            mine = records.pop((i, kind))
            ref = f64.pop(i) if kind == "grad" else {}
            for n, pl in places.items():
                rows[f"{kind} {i + 1} {n}"] = _part_distance(
                    pl, rank, mine[n], pl.local_part(named[n].detach()), ref.get(n))
            del ref
            if kind == "param" and i + 1 < steps:
                float64(i + 1)

        if held:
            float64(0)
        r_losses, r_times = _mesh_t_steps(ref_state, batch, steps, compare if held else None)
        got.update(ref_losses=r_losses, ref_times=r_times, f64_losses=f64_losses,
                   ref_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   ref_state_gib=_state_gib(ref_state))
        del ref_state, f64
        _free_card()
    if held:
        got["distances"] = _distances(rows)
    if rank == 0 and dtype == BF16:   # the bf16 floor's fp32 one-rank run
        ref_state, _ = _mesh_t_model(torch.float32, None, opt)
        got["ref_fp32_losses"] = _mesh_t_steps(ref_state, batch, steps)[0]
        del ref_state
        _free_card()
    dist.barrier()
    return got


def train_mesh_rank(rank):
    """This rank's side of phase_train_mesh (see MESH_T_*)."""
    t0 = time.perf_counter()
    out = {"a_fsdp2": _mesh_t_part(rank, "1,2,1,1", torch.float32, MESH_T_OPT,
                                   MESH_T_STEPS, held=True),
           "b_tp2_fp32": _mesh_t_part(rank, "1,1,2,1", torch.float32, MESH_T_OPT,
                                      1, held=True),
           "b_tp2_bf16": _mesh_t_part(rank, "1,1,2,1", BF16,
                                      dict(adamw_optimizer=TRAIN_CLI_OPT), MESH_T_BF16_STEPS,
                                      held=False)}
    out["wall_s"] = time.perf_counter() - t0
    return out


def _mesh_t_held(what, distances):
    """Hold every whole leaf: the mesh within MESH_T_TOL of the one-rank run
    in relative L2 and in max/max; a step-1 gradient that misses, by the
    float64 step at the one-rank run's params (f64_arm's rule). Logs the
    largest distances."""
    over = []
    for kind in ("grad", "param"):
        ks = [k for k in distances if k.startswith(kind)]
        for m in ("l2", "max"):
            worst = max(ks, key=lambda k: distances[k][m])
            log(f"train mesh {what}: largest {kind} {m} distance from the one-rank run "
                f"{distances[worst][m]:.3e} ({worst}; tol {MESH_T_TOL})")
    for k, d in sorted(distances.items()):
        for m in ("l2", "max"):
            if d[m] <= MESH_T_TOL:
                continue
            if "ref_" + m not in d:
                over.append((k, m, d[m]))
                continue
            floor = d["ref_" + m]
            limit = FLOOR_RATIO * floor if floor > MESH_T_TOL else MESH_T_TOL
            log(f"train mesh {what}: {k} {m} {d[m]:.3e} from the one-rank run; from float64 "
                f"the mesh {d['f64_' + m]:.3e}, the one-rank run {floor:.3e} (limit {limit:.3e})")
            if not d["f64_" + m] <= limit:
                over.append((k, m, d[m], d["f64_" + m], limit))
    if over:
        raise AssertionError(f"train mesh {what}: leaves off the one-rank run: {over}")


def phase_train_mesh(ranks):
    """See MESH_T_*: the two ranks' parts (spawn_mesh_ranks), their holds
    and launches. Returns the launch counts of every rank's parts."""
    paths = []
    for r in range(2):
        got = ranks[r]["_train_mesh"]
        for name in ("a_fsdp2", "b_tp2_fp32", "b_tp2_bf16"):
            part = got[name]
            steps = len(part["losses"])
            want = dict(flash_fwd=MESH_T_LAYERS * steps, flash_bwd=MESH_T_LAYERS * steps)
            if "fp32" in name or name.startswith("a"):
                want.update(flash_fwd_f32=want["flash_fwd"], flash_bwd_f32=want["flash_bwd"])
            step_s = float(np.median(part["times"]))
            log(f"train mesh {name} rank {r}: losses {[round(x, 6) for x in part['losses']]}, "
                f"steps {', '.join(f'{t:.3f}' for t in part['times'])} s; exchanges (host-staged "
                f"gloo, two ranks on one card: not multi-GPU speed) {part['exchange_s']:.3f} s "
                f"over {part['exchanges']} collectives ({100 * part['exchange_s'] / sum(part['times']):.1f}% "
                f"of the steps; by kind {({k: round(v, 3) for k, v in part['exchange_by_kind'].items()})}); peak {part['peak_gib']:.2f} GiB, state {part['state_gib']:.2f} "
                f"GiB" + (f" (one rank: peak {part['ref_peak_gib']:.2f}, state "
                          f"{part['ref_state_gib']:.2f} GiB, step "
                          f"{float(np.median(part['ref_times'])):.3f} s)" if "ref_peak_gib" in part
                          else "") + f"; median step {step_s:.3f} s; launches "
                f"{part['launches']} (want {want}) [{card()}]")
            if any(part["launches"][k] != v for k, v in want.items()):
                raise AssertionError(f"train mesh {name} rank {r}: launches {part['launches']}, "
                                     f"want {want}")
            paths.append(part["launches"])
    a, b32, b16 = (ranks[0]["_train_mesh"][n] for n in ("a_fsdp2", "b_tp2_fp32", "b_tp2_bf16"))
    for name, part in (("a_fsdp2", a), ("b_tp2_fp32", b32)):
        for i, (got, want) in enumerate(zip(part["losses"], part["ref_losses"])):
            rel = abs(got - want) / abs(want)
            log(f"train mesh {name} step {i + 1}: loss {got:.8f}, one rank {want:.8f} (relative "
                f"{rel:.3e}, tol {MESH_T_TOL}); float64 at the one-rank run's params "
                f"{part['f64_losses'][i]:.8f}")
            if not (math.isfinite(got) and rel <= MESH_T_TOL):
                raise AssertionError(f"train mesh {name}: step {i + 1}'s loss leaves the one-rank "
                                     "run's")
        _mesh_t_held(name, part["distances"])
    for i, (got, one, f32) in enumerate(zip(b16["losses"], b16["ref_losses"],
                                           b16["ref_fp32_losses"])):
        floor = abs(one - f32)
        log(f"train mesh b_tp2_bf16 step {i + 1}: loss tp 2 {got:.6f}, one rank {one:.6f}, one "
            f"rank fp32 {f32:.6f}: |tp 2 - one rank| {abs(got - one):.2e}, the bf16 floor "
            f"{floor:.2e} (limit {FLOOR_RATIO} x floor + {FUSED_SLACK})")
        if not (math.isfinite(got) and abs(got - one) <= FLOOR_RATIO * floor + FUSED_SLACK):
            raise AssertionError(f"train mesh b_tp2_bf16: step {i + 1}'s loss leaves the one-rank "
                                 "run's by more than the bf16 noise floor")
    for r in range(2):
        if ranks[r]["_train_mesh"]["a_fsdp2"]["losses"] != a["losses"]:
            raise AssertionError("train mesh a_fsdp2: the ranks' losses differ")
    log(f"train mesh: the phase's ranks {max(x['_train_mesh']['wall_s'] for x in ranks):.1f} s "
        f"of wall (parts, one-rank runs and holds) [{card()}]")
    return paths


# phase_serve_mesh: inference on a mesh, run in the two ranks that
# phase_train_ring spawns (spawn_mesh_ranks: one spawn, one import and one
# kernel load for both phases), both on the one card over gloo, so every
# exchange is staged through host memory (its times are gloo's, not
# NVLink's):
# (a) tp 2, bf16 ("1,1,2,1"): serving_config() at MESH_LAYERS layers (the
#     7b width), run_serve.sh's pool (8 slots, cache 4096, buckets
#     256/1024/2048, per_row) over the serving mix's first 8 requests,
#     teacher-forced: every pick returns the next token of MESH_FORCED_SEED's
#     stream, so the admissions' logits and MESH_ROUNDS decode rounds' are held
#     row by row to the one-device port's run of the same weights and tokens
#     at the bf16 noise floor that phase_serve uses (hold_to_noise_floor, an
#     fp32 copy of the weights as the truth); K1 and K4 launches exact on each
#     rank, and both ranks' logits equal;
# (b) sp 2, fp32 ("1,1,1,2"): the same width at MESH_LAYERS layers in fp32,
#     sp_slot_caches, 2 slots of MESH_B_CACHE, prompts of MESH_B_PROMPTS
#     tokens (buckets 2048, 8192), an MESH_VERIFY-token verify block at each
#     slot's frontier (slot 1's, 8188-8195, across the shards' boundary at
#     8192), then MESH_ROUNDS decode rounds, teacher-forced; the decode
#     rounds' logits within MESH_F32_RTOL relative L2 of the one-device fp32
#     port's, the admissions' and the verify block's within that or
#     FLOOR_RATIO x the fp32 floor of another row blocking (the one-device
#     run against itself with its prompts admitted in MESH_B_FLOOR_CHUNK-token
#     chunks: a rank's products take half the rows, which cuBLAS may sum in
#     another order);
#     ring_attention_inference alone at the 7b heads over the same cache
#     length (a decode of 2 rows, and 2048 queries at q_offset 7168, across
#     the boundary, split over sp) held to K4 / K1 over the whole cache on one
#     device within F32_REL_TOL of the largest |value|;
# (c) eval_needle at "!1,-1,2,1" in both ranks (fp32, MESH_EVAL_LAYERS layers of
#     the 7b width saved by the port's writer, a tiny haystack, one grid point):
#     only rank 0 opens a file to write; each answer's token ids are printed
#     beside the one-device run's, and a difference fails unless the
#     one-device run's top-2 margin at the first differing step is below
#     MESH_TIE_GAP.
MESH_LAYERS, MESH_EVAL_LAYERS, MESH_ROUNDS = 4, 2, 8
MESH_FORCED_SEED = SEED + 30
MESH_B_CACHE, MESH_B_PROMPTS, MESH_B_BUCKETS = 16384, (2048, 8188), (2048, 8192)
MESH_VERIFY, MESH_B_Q_OFFSET, MESH_B_QUERIES, MESH_B_HEADS = 8, 7168, 2048, 32
MESH_F32_RTOL = 1e-5
MESH_B_FLOOR_CHUNK = 1024   # the floor's chunked admission
MESH_TIE_GAP = 1e-3
MESH_EVAL_BLOCK = 32


def _mesh_model(cfg, dtype, seed, mesh=None):
    """The model of `cfg` with random weights from `seed` (the same on every
    process); on `mesh`, this rank's slices of them."""
    from lwm_tpu_torch.parallel.partition import shard_state_dict

    full = LLaMAForCausalLM(cfg, dtype=dtype, device="cuda")
    full.init_weights(torch.Generator(device="cuda").manual_seed(seed))
    if mesh is None:
        return full
    sd = shard_state_dict(full.state_dict(), mesh)
    del full
    return LLaMAForCausalLM.on_tensors(cfg, sd, dtype, mesh)


def _forcing(forced, rows):
    """A stand-in for InflightServer._pick: records the logits it is given
    (fp32, on the host) in `rows` and returns the next tokens of `forced`."""
    it = iter(forced)

    def pick(logits, tau):
        rows.append(logits.float().cpu())
        return torch.tensor([next(it) for _ in range(logits.shape[0])], device=logits.device)

    return pick


def mesh_pool_run(model, mesh):
    """(a)'s teacher-forced pool: (logits [8 + MESH_ROUNDS x 8, vocab],
    the decode rounds' seconds, launches)."""
    cfg = model.config
    srv = InflightServer(model, slots=8, cache_len=4096, prompt_buckets=BUCKETS, seed=SEED,
                         mesh=mesh)
    for p in serving_requests(cfg)[0][:8]:
        srv.submit(p, MESH_ROUNDS + 2)
    rows = []
    srv._pick = _forcing(np.random.default_rng(MESH_FORCED_SEED).integers(
        2, cfg.vocab_size, 8 * (MESH_ROUNDS + 1)), rows)
    torch.cuda.synchronize()
    _reset_launch_counts()
    srv.step()   # the 8 admissions and the first round
    rounds = []
    for _ in range(MESH_ROUNDS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.step()
        torch.cuda.synchronize()
        rounds.append(time.perf_counter() - t0)
    launches = _launch_counts()
    return torch.cat(rows), rounds, launches


def mesh_sp_run(model, mesh, admit_chunk=0):
    """(b)'s teacher-forced sp pool: (logits [2 + 2 x MESH_VERIFY +
    MESH_ROUNDS x 2, vocab], the decode rounds' seconds, launches); with
    `admit_chunk`, the prompts admitted in chunks of it."""
    cfg = model.config
    srv = InflightServer(model, slots=2, cache_len=MESH_B_CACHE, prompt_buckets=MESH_B_BUCKETS,
                         lookup_k=MESH_VERIFY - 1, seed=SEED, mesh=mesh, admit_chunk=admit_chunk)
    rng = np.random.default_rng(MESH_FORCED_SEED + 1)
    for n in MESH_B_PROMPTS:
        srv.submit(rng.integers(2, cfg.vocab_size, n).tolist(), 32)
    forced = rng.integers(2, cfg.vocab_size, (3 + MESH_ROUNDS, MESH_VERIFY))
    rows = []
    srv._pick = _forcing(forced[0, :2], rows)
    torch.cuda.synchronize()
    _reset_launch_counts()
    srv._admit()
    while srv._pending:
        srv._advance_pending()
    toks = np.concatenate([srv.tokens[:, None], forced[1:3, 1:]], 1)
    rows.append(srv._forward(toks, MESH_VERIFY).reshape(-1, cfg.vocab_size).cpu())
    srv.lengths += MESH_VERIFY
    srv.tokens[:] = forced[1:3, 0]
    rounds = []
    for r in range(MESH_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows.append(srv._forward(srv.tokens[:, None], 1)[:, 0].cpu())
        torch.cuda.synchronize()
        rounds.append(time.perf_counter() - t0)
        srv.lengths += 1
        srv.tokens[:] = forced[3 + r, :2]
    launches = _launch_counts()
    return torch.cat(rows), rounds, launches


def mesh_layer_inputs():
    """(b)'s ring_attention_inference inputs, fp32 on the card, the same on
    every process: the whole cache k, v [2, MESH_B_HEADS, MESH_B_CACHE, 128],
    a decode (q [2, 1, MESH_B_HEADS, 128], its rows' keys valid up to the
    prompts' ends + 5 and + 12) and a prefill of MESH_B_QUERIES queries at
    MESH_B_Q_OFFSET over row 0."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 32)
    T, h = MESH_B_CACHE, MESH_B_HEADS
    k, v = (_randn((2, h, T, 128), gen, torch.float32) for _ in "kv")
    q_dec = _randn((2, 1, h, 128), gen, torch.float32)
    q_pre = _randn((1, MESH_B_QUERIES, h, 128), gen, torch.float32)
    keys = torch.arange(T, device="cuda")
    ends = torch.tensor([[MESH_B_PROMPTS[0] + 5], [MESH_B_PROMPTS[1] + 12]], device="cuda")
    return k, v, q_dec, keys[None] < ends, q_pre, keys < MESH_B_Q_OFFSET + MESH_B_QUERIES


def mesh_layer_check(mesh):
    """ring_attention_inference on this rank's half of mesh_layer_inputs:
    (decode out, prefill out gathered over sp)."""
    from lwm_tpu_torch.ops.ring import ring_attention_inference

    k, v, q_dec, mask, q_pre, pre_mask = mesh_layer_inputs()
    n = k.shape[2] // mesh.sp
    lo, hi = mesh.sp_rank * n, (mesh.sp_rank + 1) * n
    k, v = k[:, :, lo:hi].contiguous(), v[:, :, lo:hi].contiguous()
    dec = ring_attention_inference(q_dec, k, v, mask[:, lo:hi].contiguous(), mesh=mesh,
                                   kv_offset=lo)
    per = MESH_B_QUERIES // mesh.sp
    rows = slice(mesh.sp_rank * per, (mesh.sp_rank + 1) * per)
    pre = ring_attention_inference(q_pre[:, rows].contiguous(), k[:1], v[:1],
                                   pre_mask[None, lo:hi].contiguous(), mesh=mesh, kv_offset=lo,
                                   q_offset=MESH_B_Q_OFFSET, q_sharded=True)
    return dec, mesh.gather_sequence(pre)


def mesh_eval_argv(work, out, mesh_dim):
    return [*CLI_FLAGS, f"--load_llama_config={CLI_PRESET}",
            f"--update_llama_config=dict(num_hidden_layers={MESH_EVAL_LAYERS},theta=10000000,"
            f"max_sequence_length=131072,scan_query_chunk_size={MESH_EVAL_BLOCK},"
            f"scan_key_chunk_size={MESH_EVAL_BLOCK})",
            f"--tokenizer={FIXTURE_TOKENIZER}", f"--load_checkpoint=params::{work / 'mesh_params'}",
            f"--haystack_file={work / 'mesh_haystack.jsonl'}", f"--output_file={out}",
            f"--mesh_dim={mesh_dim}", "--context_lengths_min=1000", "--context_lengths_max=1000",
            "--n_context_length_intervals=1", "--n_document_depth_intervals=1", "--n_rounds=1",
            "--dtype=fp32"]


def write_mesh_eval_inputs(work):
    """(c)'s checkpoint (the 7b width at MESH_EVAL_LAYERS layers, bf16,
    random from the seed) and haystack, in `work`."""
    cfg = LLaMAConfig.load_config(CLI_PRESET).replace(num_hidden_layers=MESH_EVAL_LAYERS)
    model = _mesh_model(cfg, BF16, SEED + 33)
    checkpoint.save_tree(flax_params_tree(model.state_dict(), cfg), str(work / "mesh_params"))
    del model
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 33)
    (work / "mesh_haystack.jsonl").write_text("".join(
        json.dumps({"text": _cli_text(rng, 300) + ". "}) + "\n" for _ in range(10)))


@contextlib.contextmanager
def recorded_picks(steps):
    """generation._next_token recording each step's picks and top-2 margins
    (host lists) in `steps`."""
    real = generation._next_token

    def next_token(logits, config, generator):
        tok = real(logits, config, generator)
        top = logits.float().topk(2, -1).values
        steps.append((tok.tolist(), (top[:, 0] - top[:, 1]).tolist()))
        return tok

    generation._next_token = next_token
    try:
        yield
    finally:
        generation._next_token = real


def mesh_eval_rank(rank, work):
    """(c) in a rank: eval_needle's CLI in-process on the mesh; returns the
    picks of rank 0's model group (the rows' tokens) and the files this
    rank opened to write."""
    writes, opener = [], eval_needle.open_file

    def recording(path, mode="r", *a, **kw):
        if "w" in mode:
            writes.append(str(path))
        return opener(path, mode, *a, **kw)

    steps = []
    eval_needle.open_file = recording
    try:
        with recorded_picks(steps):
            eval_needle.main(mesh_eval_argv(work, work / "mesh_eval.json", "!1,-1,2,1"))
    finally:
        eval_needle.open_file = opener
    return dict(steps=steps, writes=writes)


def _timed_collectives(seconds):
    """Mesh's collectives synchronised and timed into `seconds`; returns a
    function that restores them."""
    from lwm_tpu_torch.parallel.mesh import Mesh

    real = {name: getattr(Mesh, name) for name in ("all_reduce", "all_gather", "broadcast")}

    def timed(fn):
        def call(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, *a, **kw)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            return out
        return call

    for name, fn in real.items():
        setattr(Mesh, name, timed(fn))
    return lambda: [setattr(Mesh, name, fn) for name, fn in real.items()]


def serve_mesh_rank(rank, work):
    """phase_serve_mesh's parts in one of the two ranks: (a), (b) and (c),
    each part's wall and exchange seconds, launches and round times; the
    logits to `work` (both ranks)."""
    from lwm_tpu_torch.parallel.mesh import create_mesh

    out = {}
    for part, mesh_dim, cfg, dtype, seed, run in (
            ("a", "1,1,2,1", serving_config().replace(num_hidden_layers=MESH_LAYERS), BF16, SEED,
             mesh_pool_run),
            ("b", "1,1,1,2", serving_config().replace(num_hidden_layers=MESH_LAYERS,
                                                      max_sequence_length=MESH_B_CACHE),
             torch.float32, SEED + 31, mesh_sp_run)):
        t0 = time.perf_counter()
        mesh = create_mesh(mesh_dim, "cuda")
        model = _mesh_model(cfg, dtype, seed, mesh)
        exch = []
        restore = _timed_collectives(exch)
        try:
            if part == "b":
                dec, pre = mesh_layer_check(mesh)
                if rank == 0:
                    torch.save(dict(dec=dec.cpu(), pre=pre.cpu()), work / "mesh_layer.pt")
                del dec, pre
            exch.clear()
            t1 = time.perf_counter()
            logits, rounds, launches = run(model, mesh)
            run_s = time.perf_counter() - t1
        finally:
            restore()
        torch.save(logits, work / f"mesh_{part}_rank{rank}.pt")
        out[part] = dict(launches=launches, rounds=rounds, run_s=run_s, exchange_s=sum(exch),
                         n_exchanges=len(exch), wall=time.perf_counter() - t0,
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del model, logits
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    exch = []
    restore = _timed_collectives(exch)
    try:
        _reset_launch_counts()
        out["c"] = dict(mesh_eval_rank(rank, work), launches=_launch_counts())
    finally:
        restore()
    out["c"].update(wall=time.perf_counter() - t0, exchange_s=sum(exch))
    return out


def hold_rows_to_noise_floor(got, one, truth, labels, what):
    """The noise-floor rule over many logit rows: each row of `got` agrees
    with the one-device bf16 run's at cosine >= COS_MIN; its argmax is the
    one device's or the fp32 truth's, or a token whose fp32 logit is within
    the one device's own rounding of that row (max|one - truth|) of the
    truth's largest (a tie at bf16); summed over the rows, got's distance to
    the truth (1 - cosine) is at most FLOOR_RATIO x the one-device run's
    (each row's ratio scatters around 1: two bf16 paths, neither the
    closer)."""
    c_go = F.cosine_similarity(got, one, dim=-1)
    d_got = 1 - F.cosine_similarity(got, truth, dim=-1)
    d_one = 1 - F.cosine_similarity(one, truth, dim=-1)
    pick = got.argmax(-1)
    gap = truth.amax(-1) - truth.gather(-1, pick[:, None])[:, 0]
    noise = (one - truth).abs().amax(-1)
    other = (pick != one.argmax(-1)) & (pick != truth.argmax(-1))
    miss = other & (gap > noise)
    ratio = (d_got.sum() / d_one.sum()).item()
    worst = int(c_go.argmin())
    log(f"{what}: {len(labels)} rows; cosine to one device min {c_go.min().item():.6f} "
        f"({labels[worst]}; min {COS_MIN}); distance to fp32 summed: {d_got.sum().item():.3e} "
        f"vs one device's {d_one.sum().item():.3e}, ratio {ratio:.3f} (max {FLOOR_RATIO}); rows "
        f"ratio {(d_got / d_one).min().item():.3f}-{(d_got / d_one).max().item():.3f}")
    for i in torch.nonzero(other)[:, 0].tolist():
        log(f"{what} {labels[i]}: argmax {int(pick[i])}, one device {int(one[i].argmax())}, fp32 "
            f"{int(truth[i].argmax())}; fp32 logit {gap[i].item():.4f} below the top, the one "
            f"device's rounding there {noise[i].item():.4f}: "
            + ("a tie at bf16" if not miss[i] else "apart"))
    failed = [labels[i] for i in range(len(labels)) if c_go[i] < COS_MIN or miss[i]]
    if failed or not ratio <= FLOOR_RATIO:
        raise AssertionError(f"{what}: off the bf16 noise floor (rows {failed}, summed distance "
                             f"ratio {ratio:.3f})")


def phase_serve_mesh(ranks, work):
    """See MESH_*: the ranks' parts (spawn_mesh_ranks) held to one-device
    runs here. Returns the launch counts of every rank's part."""
    t_phase = time.perf_counter()
    parts = [r["_serve_mesh"] for r in ranks]
    paths = []
    for r, p in enumerate(parts):
        for part in ("a", "b", "c"):
            paths.append(p[part]["launches"])
        log(f"serve mesh rank {r}: (a) {p['a']['wall']:.1f}s ({p['a']['exchange_s']:.2f}s of "
            f"{p['a']['n_exchanges']} exchanges), (b) {p['b']['wall']:.1f}s "
            f"({p['b']['exchange_s']:.2f}s of {p['b']['n_exchanges']} exchanges), (c) "
            f"{p['c']['wall']:.1f}s ({p['c']['exchange_s']:.2f}s of exchanges) of wall, "
            "host-staged over gloo")

    # (a): tp 2, bf16, against one device (bf16) and its fp32 copy (the truth)
    cfg = serving_config().replace(num_hidden_layers=MESH_LAYERS)
    model = _mesh_model(cfg, BF16, SEED)
    one, one_rounds, one_launches = mesh_pool_run(model, None)
    fp32 = type(model).on_tensors(cfg, fp32_weights(model), torch.float32)
    del model
    truth = mesh_pool_run(fp32, None)[0]
    del fp32
    torch.cuda.empty_cache()
    mesh_rows = [torch.load(work / f"mesh_a_rank{r}.pt") for r in range(2)]
    if not torch.equal(mesh_rows[0], mesh_rows[1]):
        raise AssertionError("serve mesh (a): the two tp ranks' logits differ")
    want = dict(flash_fwd=MESH_LAYERS * 8, flash_decode=MESH_LAYERS * MESH_ROUNDS)
    for r, p in enumerate(parts):
        got = {k: p["a"]["launches"][k] for k in want}
        log(f"serve mesh (a) rank {r}: launches {got} (want {want}); decode rounds "
            f"{', '.join(f'{1e3 * t:.1f}' for t in p['a']['rounds'])} ms (tp 2, gloo) [{card()}]")
        if got != want:
            raise AssertionError(f"serve mesh (a) rank {r}: launches {got}, want {want}")
    rounds = ", ".join(f"{1e3 * t:.1f}" for t in one_rounds)
    log(f"serve mesh (a): one device's decode rounds {rounds} ms [{card()}]")
    labels = [f"admission {i}" for i in range(8)] + [
        f"round {i // 8 + 1} slot {i % 8}" for i in range(8 * MESH_ROUNDS)]
    hold_rows_to_noise_floor(mesh_rows[0], one, truth, labels, "serve mesh (a) tp 2")

    # (b): sp 2, fp32, against one device
    k, v, q_dec, mask, q_pre, pre_mask = mesh_layer_inputs()
    ref_dec = decode.flash_decode(q_dec, k, v, mask, MESH_B_CACHE)
    bias = torch.where(pre_mask, 0.0, BIG_NEG)[None, None, None, :]
    ref_pre = flash.flash_attention_fwd(q_pre, k[:1], v[:1], bias, causal=True,
                                        q_offset=MESH_B_Q_OFFSET, kv_head_major=True)[0]
    got = torch.load(work / "mesh_layer.pt")
    for name, ref in (("decode", ref_dec), ("prefill", ref_pre)):
        err = (got[name[:3]].cuda() - ref).abs().max().item() / ref.abs().max().item()
        log(f"serve mesh (b) ring_attention_inference {name}: max|sp 2 - one device| / max|one "
            f"device| {err:.3e} (tol {F32_REL_TOL})")
        if not err <= F32_REL_TOL:
            raise AssertionError(f"serve mesh (b): ring_attention_inference {name} leaves K4/K1 "
                                 "over the whole cache")
    del k, v, q_dec, q_pre, ref_dec, ref_pre, got
    torch.cuda.empty_cache()
    cfg = serving_config().replace(num_hidden_layers=MESH_LAYERS, max_sequence_length=MESH_B_CACHE)
    model = _mesh_model(cfg, torch.float32, SEED + 31)
    one, one_rounds, _ = mesh_sp_run(model, None)
    chunked = mesh_sp_run(model, None, admit_chunk=MESH_B_FLOOR_CHUNK)[0]
    del model
    torch.cuda.empty_cache()
    mesh_rows = [torch.load(work / f"mesh_b_rank{r}.pt") for r in range(2)]
    if not torch.equal(mesh_rows[0], mesh_rows[1]):
        raise AssertionError("serve mesh (b): the two sp ranks' logits differ")
    rel = ((mesh_rows[0] - one).norm(dim=-1) / one.norm(dim=-1)).tolist()
    floor = ((chunked - one).norm(dim=-1) / one.norm(dim=-1)).tolist()
    cut = {"admissions": slice(0, 2), "verify block": slice(2, 2 + 2 * MESH_VERIFY),
           "decode rounds": slice(2 + 2 * MESH_VERIFY, None)}
    groups = {k: rel[c] for k, c in cut.items()}
    log("serve mesh (b): the fp32 floor, one device against itself with the prompts admitted "
        f"in {MESH_B_FLOOR_CHUNK}-token chunks (other row blocks in every product): " + "; ".join(
            f"{k} largest {max(floor[c]):.2e}" for k, c in cut.items()))
    want = dict(flash_fwd=MESH_LAYERS * 3, flash_fwd_f32=MESH_LAYERS * 3,
                flash_decode=MESH_LAYERS * MESH_ROUNDS, flash_decode_f32=MESH_LAYERS * MESH_ROUNDS)
    for r, p in enumerate(parts):
        got = {k: p["b"]["launches"][k] for k in want}
        log(f"serve mesh (b) rank {r}: launches {got} (want {want}); decode rounds "
            f"{', '.join(f'{1e3 * t:.1f}' for t in p['b']['rounds'])} ms (sp 2 over 16384 "
            f"slots, gloo) [{card()}]")
        if got != want:
            raise AssertionError(f"serve mesh (b) rank {r}: launches {got}, want {want}")
    log(f"serve mesh (b): relative L2 of the sp 2 logits to one device's: " + "; ".join(
        f"{k} {', '.join(f'{x:.2e}' for x in v)}" for k, v in groups.items())
        + f" (tol {MESH_F32_RTOL}); one device's decode rounds "
        f"{', '.join(f'{1e3 * t:.1f}' for t in one_rounds)} ms [{card()}]")
    # the decode rounds at MESH_F32_RTOL; the prefills (admissions, the verify
    # block), whose products run on each rank's half of the rows, at the fp32
    # floor of another row blocking where that is above it
    for k, c in cut.items():
        tol = MESH_F32_RTOL if k == "decode rounds" else max(
            MESH_F32_RTOL, FLOOR_RATIO * max(floor[c]))
        if not max(rel[c]) <= tol:
            raise AssertionError(f"serve mesh (b): the sp 2 {k}' logits leave the one-device "
                                 f"run's ({max(rel[c]):.2e}, tol {tol:.2e})")

    # (c): eval_needle on the mesh against one device
    steps = []
    with recorded_picks(steps):
        run_cli_in_process(eval_needle.main, mesh_eval_argv(work, work / "one_eval.json",
                                                            "1,-1,1,1"), "eval_needle one device")
    mesh_steps = parts[0]["c"]["steps"]
    writes = [p["c"]["writes"] for p in parts]
    log(f"serve mesh (c): files opened to write, rank 0 {writes[0]}, rank 1 {writes[1]}")
    if not writes[0] or writes[1] or any(w != str(work / "mesh_eval.json") for w in writes[0]):
        raise AssertionError("serve mesh (c): rank 0 alone must write the results")
    one_ids = [list(t) for t in zip(*(s[0] for s in steps))]
    mesh_ids = [list(t) for t in zip(*(s[0] for s in mesh_steps))]
    for row, (a, b) in enumerate(zip(mesh_ids, one_ids)):
        log(f"serve mesh (c) answer {row}: tp 2 {a}; one device {b}")
        diff = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if diff is None and len(a) == len(b):
            continue
        j = min(len(a), len(b)) if diff is None else diff
        margin = steps[j][1][row] if j < len(steps) else math.inf
        log(f"serve mesh (c) answer {row}: first difference at step {j}, one device's top-2 "
            f"margin there {margin:.3e} (tie below {MESH_TIE_GAP})")
        if not margin < MESH_TIE_GAP:
            raise AssertionError(f"serve mesh (c): answer {row} differs from one device's")
    if (json.loads((work / "mesh_eval.json").read_text()) != json.loads(
            (work / "one_eval.json").read_text())) and mesh_ids == one_ids:
        raise AssertionError("serve mesh (c): the same tokens wrote other results")
    log(f"serve mesh: the phase's holds {time.perf_counter() - t_phase:.1f}s in this process "
        f"[{card()}]")
    return paths


# scripts/run_context_extension_torch.sh's chain (phase_context_extension) at
# the bundle's widths (CTX_BASE_CFG: 6 layers of 768, 6 heads, vocab 2048,
# remat nothing_saveable; fp32; the BPE fixture tokenizer):
# - data: the port's generators with the bundle's flags, n_train cut to what
#   the steps read (CTX_DATA), each a `python -m` process, and the bundle's
#   mixing step, in one host process started after phase_build
#   (start_context_extension_data), so that it overlaps the kernel phases;
# - training: the four stages (CTX_STAGES: the bundle's seq, theta, batch,
#   data, scan chunk and lr, its lr schedule over its own total steps) for
#   their smoke steps, each warm-started with params:: from the last stage's
#   milestone, found as the bundle's `ls` finds it; exact K1 and backward
#   fp32 counts (2 x layers x steps, layers x steps) and finite losses.
#   Stage 3 is the 32K stage that was timed alone before: its steps synced
#   and timed, the median of steps 2 on beside the backward's fp32 route's
#   share (one launch a layer a step at its time at BWD_F32_32K).
#   Stage 1's first batch is held kernel vs plain at fp32 on the stage-0
#   weights (loss F32_LOSS_RTOL, every grad F32_GRAD_REL_TOL of its largest);
# - conversion: run_needle_validation.sh's unscan of stage 3's stream (in
#   this process), every layer equal to its slice; streaming_to_hf
#   then hf_to_streaming of the same stream, leaf for leaf;
# - eval: eval_needle at CTX_EVAL_CONTEXT tokens, one depth, one round over
#   the unscanned stream (exact K1/K4 fp32 counts: a prefill and a step of
#   each layer), its results_32k.json a row; summarize_needle (`python -m`);
#   probe_needle_digits in this process on CTX_PROBE_N prompts with exact K1
#   fp32 counts (its `python -m` run, 30 s of imports on the card's host, was
#   cut for room), its logits held kernel vs plain at NEEDLE_REL_TOL and its
#   argmaxes equal (or apart at a near tie).
CTX_BASE_CFG = ("vocab_size=2048,hidden_size=768,intermediate_size=2048,num_hidden_layers=6,"
                "num_attention_heads=6,scan_attention=True,scan_mlp=False,scan_layers=True,"
                "param_scan_axis=0,remat_block='nothing_saveable'")
# name, seq, theta, the bundle's steps, batch, data, scan chunk, lr, the smoke's steps
CTX_STAGES = (("copy", 512, 10000, 1500, 64, "copy.jsonl", 256, "1e-3", 2),
              ("base2k", 2048, 10000, 4000, 16, "train_mixed.jsonl", 256, "1e-3", 2),
              ("ext8k", 8192, 200000, 800, 4, "needle_8k.jsonl", 1024, "4e-4", 2),
              ("ext32k", 32768, 2000000, 500, 1, "needle_32k.jsonl", 1024, "3e-4", 4))
_NEEDLE = "--filler_mode pool --n_distractors 2 --qa_all_needles"
CTX_DATA = (   # module, the bundle's flags with n_train cut ({w}: the work directory)
    ("create_copy_pretrain_data", "--seq_length 512 --n_train 128 --output {w}/copy.jsonl"),
    ("create_copy_pretrain_data",
     "--seq_length 1024 --n_train 16 --output {w}/copy_mix.jsonl --seed 3"),
    ("create_needle_train_data", f"--seq_length 1024 --n_train 16 {_NEEDLE} "
     "--min_context_tokens 32 --max_context_tokens 450 --train_output {w}/needle_short.jsonl"),
    ("create_needle_train_data", f"--seq_length 2048 --n_train 16 {_NEEDLE} "
     "--min_context_tokens 256 --seed 2 --train_output {w}/needle_long.jsonl "
     "--haystack_output {w}/haystack.jsonl --haystack_sentences 80000"),
    ("create_needle_train_data", f"--seq_length 8192 --n_train 8 {_NEEDLE} "
     "--min_context_tokens 1024 --seed 4 --train_output {w}/needle_8k.jsonl"),
    ("create_needle_train_data", f"--seq_length 32768 --n_train 4 {_NEEDLE} "
     "--min_context_tokens 4096 --seed 5 --train_output {w}/needle_32k.jsonl"),
)
CTX_EVAL_CONTEXT, CTX_PROBE_N = 30000, 4
CTX_LAYERS = _spec_cfg(f"dict({CTX_BASE_CFG})")["num_hidden_layers"]
CTX_DATA_SCRIPT = r'''
import contextlib, importlib, io, json, random, subprocess, sys, time
jobs, w, vjobs = json.loads(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
for module, args in jobs:
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "lwm_tpu_torch.apps." + module, *args],
                         capture_output=True, text=True)
    if out.returncode:
        sys.exit(f"{module} {args}: exit {out.returncode}\n{out.stderr[-3000:]}")
    print(json.dumps([module, round(time.perf_counter() - t0, 2), out.stdout.strip()]),
          flush=True)
# the bundle's mixing step: 2048-token groups of [copy|needle_short pairs] + [needle_long]
t0 = time.perf_counter()
rng = random.Random(99)
copy_ = open(f"{w}/copy_mix.jsonl").read().strip().splitlines()
a = open(f"{w}/needle_short.jsonl").read().strip().splitlines()
b = open(f"{w}/needle_long.jsonl").read().strip().splitlines()
rng.shuffle(copy_); rng.shuffle(a); rng.shuffle(b)
groups = []
for i in range(min(len(copy_), len(a))):
    pair = [copy_[i], a[i]]
    rng.shuffle(pair)
    groups.append(pair)
a = a[len(copy_):]
groups += [[a[i], a[i + 1]] for i in range(0, len(a) - 1, 2)]
groups += [[x] for x in b]
rng.shuffle(groups)
with open(f"{w}/train_mixed.jsonl", "w") as f:
    for g in groups:
        f.write("\n".join(g) + "\n")
print(json.dumps(["mix", round(time.perf_counter() - t0, 2), f"{len(groups)} groups"]),
      flush=True)
# the vision bundles' data (VN_DATA), the generators in this process (they
# import no torch), and run_vision_needle.sh's `mix` (a shuffled concat)
for module, args in vjobs:
    t0 = time.perf_counter()
    buf = io.StringIO()
    if module == "mix":
        out, first, second = args
        rows = open(first).read().strip().splitlines()
        rows += open(second).read().strip().splitlines()
        random.Random(8).shuffle(rows)
        open(out, "w").write("\n".join(rows) + "\n")
        print(f"mixed {len(rows)} rows into {out}", file=buf)
    else:
        with contextlib.redirect_stdout(buf):
            importlib.import_module("lwm_tpu_torch.apps." + module).main(args)
    print(json.dumps([module, round(time.perf_counter() - t0, 2), buf.getvalue().strip()]),
          flush=True)
'''


def start_context_extension_data():
    """The host process that makes phase_context_extension's data (see
    CTX_DATA) and the vision phases' (VN_DATA, under its `vision`
    directory): (its Popen, the work directory). Both are ended and removed
    at exit, whatever happens in between."""
    work = Path(tempfile.mkdtemp(prefix="lwm_ctx_ext_"))
    (work / "vision").mkdir()
    jobs = [(m, a.format(w=work).split() + ["--tokenizer", str(FIXTURE_TOKENIZER)])
            for m, a in CTX_DATA]
    vjobs = [(m, a.format(v=work / "vision").split()) for m, a in VN_DATA]
    proc = subprocess.Popen([sys.executable, "-c", CTX_DATA_SCRIPT, json.dumps(jobs), str(work),
                             json.dumps(vjobs)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=Path(__file__).resolve().parent)
    atexit.register(shutil.rmtree, work, True)
    atexit.register(proc.kill)
    return proc, work


_HOST_DATA = {}


def host_data(data):
    """The data process's jobs, each [module, seconds, its output], waited
    for on the first call (and logged then)."""
    proc, _ = data
    if proc not in _HOST_DATA:
        t0 = time.perf_counter()
        out, err = proc.communicate(timeout=900)
        waited = time.perf_counter() - t0
        if proc.returncode:
            raise AssertionError(f"host data: exit {proc.returncode}\n{err[-3000:]}")
        jobs = [json.loads(line) for line in out.splitlines()]
        for job in jobs:
            log(f"host data: {job}")
        log(f"host data: its jobs took {sum(j[1] for j in jobs):.1f}s of the host process "
            f"beside the earlier phases; waited {waited:.1f}s for it here")
        _HOST_DATA[proc] = jobs
    return _HOST_DATA[proc]


def _ctx_argv(work, stage, warm):
    """The bundle's `train` function's flags for a stage (its own steps)."""
    name, seq, theta, total, batch, data, chunk, lr, steps = stage
    return [
        *CLI_FLAGS, "--mesh_dim=1,1,1,1", "--dtype=fp32", f"--total_steps={steps}",
        "--log_freq=1", f"--save_model_freq={steps}",
        *([f"--load_checkpoint=params::{warm}"] if warm else []),
        f"--update_llama_config=dict({CTX_BASE_CFG},max_sequence_length={seq},theta={theta},"
        f"scan_query_chunk_size={chunk},scan_key_chunk_size={chunk})",
        f"--tokenizer={FIXTURE_TOKENIZER}", "--train_dataset.type=json",
        "--train_dataset.text_processor.fields=[question],answer,[postpad]",
        "--train_dataset.text_processor.subfield_separator=",
        f"--train_dataset.json_dataset.path={work / data}",
        f"--train_dataset.json_dataset.seq_length={seq}",
        f"--train_dataset.json_dataset.batch_size={batch}",
        f"--optimizer.adamw_optimizer.lr={lr}", "--optimizer.adamw_optimizer.end_lr=1e-4",
        "--optimizer.adamw_optimizer.lr_warmup_steps=100",
        f"--optimizer.adamw_optimizer.lr_decay_steps={total}",
        f"--logger.output_dir={work / ('run_' + name)}", f"--logger.experiment_id={name}",
    ]


def _ctx_config(seq, theta, chunk):
    return train.build_model_config(update_llama_config=_spec_cfg(
        f"dict({CTX_BASE_CFG},max_sequence_length={seq},theta={theta},"
        f"scan_query_chunk_size={chunk},scan_key_chunk_size={chunk})"))


def _ctx_step_hold(work, stage, warm):
    """Stage `stage`'s first batch (the CLI's dataset flags) on the weights
    of `warm`: loss and grads of the kernel path at fp32 held to the float64
    step (`f64_arm`), the plain fp32 path's beside."""
    from lwm_tpu_torch.data import DatasetFactory

    name, seq, theta, _, batch_size, data, chunk, _, _ = stage
    cfg = _ctx_config(seq, theta, chunk)
    batches = iter(DatasetFactory.load_dataset(dict(
        type="json", text_processor=dict(fields="[question],answer,[postpad]",
                                         subfield_separator=""),
        json_dataset=dict(path=str(work / data), seq_length=seq, batch_size=batch_size)),
        Tokenizer(str(FIXTURE_TOKENIZER)), node_info=train.NODE_INFO))
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(batches)[0].items()
             if k in train.BATCH_KEYS}
    batches.close()
    sd = convert_flax_params(checkpoint.load_checkpoint(str(warm)), cfg, dtype=torch.float32,
                             device="cuda")
    results = {}
    for impl in ("auto", "plain"):
        model = LLaMAForCausalLM(cfg.replace(attn_impl=impl), dtype=torch.float32,
                                 param_dtype=torch.float32, device="cuda")
        model.load_state_dict(sd)
        loss, _ = train.compute_loss(model, batch)
        loss.backward()
        results["fp32 kernel" if impl == "auto" else "plain fp32"] = (
            loss.item(), {n: p.grad for n, p in model.named_parameters()})
    log(f"context extension {name}'s first batch ({batch_size} x {seq}) on the last stage's "
        "weights, at fp32, held to the float64 step:")
    f64_arm(f"context extension {name}", f64_step(model, batch), results, held=("fp32 kernel",),
            plain="plain fp32")
    del results, sd, model
    torch.cuda.empty_cache()


def _ctx_stage(work, stage, warm, bwd_ms):
    """One stage's CLI run in this process (`_train_stage`), the 32K
    stage's time beside the backward's share. Returns (its milestone, the
    launch counts)."""
    name, seq, _, _, batch, _, _, _, steps = stage
    layers = CTX_LAYERS
    milestone, launches, times, losses, wall = _train_stage(
        _ctx_argv(work, stage, warm), f"context extension {name}", layers, steps, True)
    start = f"warm from {Path(warm).parent.name}/{Path(warm).name}" if warm else "from the seed"
    log(f"context extension {name} ({batch} x {seq}, {start}): {steps} steps in {wall:.1f}s "
        f"of wall, steps {', '.join(f'{t:.3f}' for t in times)} s, losses "
        f"{[round(x, 4) for x in losses]}; launches {launches}")
    if seq == 32768:
        step_s = float(np.median(times[1:]))
        attn_s = layers * bwd_ms / 1e3
        log(f"train ctx32k (run_context_extension.sh's 32K stage: hidden 768, {layers} layers, "
            f"6 heads, 1 x {seq}, fp32, remat nothing_saveable; warm from stage 2, on the "
            f"generated data): median of steps 2-{steps} {step_s:.3f} s, {seq / step_s:.0f} "
            f"tokens/s; the backward's fp32 route {layers} x {bwd_ms:.3f} ms = {attn_s:.3f} s "
            f"({100 * attn_s / step_s:.1f}% of the step); peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{card()}]")
    return milestone, launches


def _stream_equal(got, want, what):
    """Two flat streams leaf for leaf (fp32; `want` widened from bf16)."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: keys differ")
    for key, value in want.items():
        if not np.array_equal(np.asarray(got[key]), torch.as_tensor(value).float().numpy()):
            raise AssertionError(f"{what}: {'/'.join(key)} differs")


def _probe_hold(args):
    """The probe's prompts through its kernel model and an attn_impl="plain"
    one on the same tensors: the first prompt's logits at NEEDLE_REL_TOL of
    the largest, every argmax equal or apart at a near tie."""
    model = probe_needle_digits.load_model(args)
    plain = LLaMAForCausalLM.on_tensors(model.config.replace(attn_impl="plain"),
                                        dict(model.named_parameters()), torch.float32)
    enc = Tokenizer(args.tokenizer)
    rows_k = probe_needle_digits.probe(model, enc, args)[3]
    rows_p = probe_needle_digits.probe(plain, enc, args)[3]
    worst, ties = 0.0, []
    for i, ((ids, pk), (_, pp)) in enumerate(zip(rows_k, rows_p)):
        x = torch.tensor([ids], device="cuda")
        pos = torch.arange(len(ids), device="cuda")[None]
        with torch.no_grad():
            lk, lp = (m(x, torch.ones_like(x), pos)[0].float() for m in (model, plain))
        worst = max(worst, ((lk - lp).abs().max() / lp.abs().max()).item())
        for at in np.flatnonzero(np.asarray(pk) != np.asarray(pp)):
            top = lp[at].topk(2).values
            ties.append((i, int(at), (top[0] - top[1]).item()))
    log(f"probe: {len(rows_k)} prompts, kernel vs plain fp32 logits max|Δ|/max|plain| "
        f"{worst:.3e} (tol {NEEDLE_REL_TOL}); argmaxes apart at {ties} (near tie below "
        f"{SPEC_TIE_GAP})")
    if not worst <= NEEDLE_REL_TOL or any(gap >= SPEC_TIE_GAP for *_, gap in ties):
        raise AssertionError("probe: the kernel path disagrees with the plain fp32 path")
    del model, plain
    torch.cuda.empty_cache()


def phase_context_extension(data, bwd_ms):
    """See CTX_*; `data` is start_context_extension_data's (process, work
    directory), `bwd_ms` the backward's fp32 route at
    BWD_F32_32K. Returns every counted run's launch counts."""
    _, work = data
    host_data(data)
    paths, warm = [], None
    for i, stage in enumerate(CTX_STAGES):
        if i == 1:
            _ctx_step_hold(work, stage, warm)
        warm, launches = _ctx_stage(work, stage, warm, bwd_ms)
        paths.append(launches)
    _, seq, theta, _, _, _, chunk, _, _ = CTX_STAGES[-1]
    update = (f"dict({CTX_BASE_CFG},max_sequence_length={seq},theta={theta},"
              f"scan_query_chunk_size={chunk},scan_key_chunk_size={chunk})")
    scanned = checkpoint.load_stream(str(warm))

    # run_needle_validation.sh's unscan, then the HF round trip
    unscanned = work / "params_unscanned"
    run_cli_in_process(convert_checkpoint.main, [
        "--direction=unscan", "--llama_config=debug", f"--update_llama_config={update}",
        "--scan_layers=True", "--param_scan_axis=0", f"--streaming_path={warm}",
        f"--output={unscanned}"], "convert_checkpoint unscan")
    flat = checkpoint.load_stream(str(unscanned))
    layers = {}
    for key, value in scanned.items():
        if "scan_decoder" in key:
            i = key.index("scan_decoder")
            for layer in range(value.shape[0]):
                layers[key[:i] + (str(layer),) + key[i + 1:]] = value[layer]
        else:
            layers[key] = value
    _stream_equal(flat, layers, "convert_checkpoint unscan")
    conv = ["--llama_config=debug", f"--update_llama_config={update}", "--scan_layers=True",
            "--param_scan_axis=0"]
    t0 = time.perf_counter()
    run_cli_in_process(convert_checkpoint.main, conv + [
        "--direction=streaming_to_hf", f"--streaming_path={warm}", f"--output={work / 'hf'}"],
        "convert_checkpoint streaming_to_hf")
    run_cli_in_process(convert_checkpoint.main, conv + [
        "--direction=hf_to_streaming", f"--hf_path={work / 'hf'}",
        f"--output={work / 'params_back'}"], "convert_checkpoint hf_to_streaming")
    _stream_equal(checkpoint.load_stream(str(work / "params_back")), scanned,
                  "convert_checkpoint HF round trip")
    log(f"convert_checkpoint: stage 3's stream unscanned ({len(flat)} leaves, each layer its "
        f"slice) and through an HF directory and back ({len(scanned)} leaves equal) in "
        f"{time.perf_counter() - t0:.1f}s of in-process runs")

    # eval_needle at one 32K-class context over the unscanned stream
    results = work / "results_32k.json"
    eval_argv = [*CLI_FLAGS, f"--haystack_file={work / 'haystack.jsonl'}",
                 f"--output_file={results}", f"--context_lengths_min={CTX_EVAL_CONTEXT}",
                 f"--context_lengths_max={CTX_EVAL_CONTEXT}", "--n_context_length_intervals=1",
                 "--n_document_depth_intervals=1", "--n_rounds=1",
                 f"--load_checkpoint=params::{unscanned}", "--unscan_for_serving=True",
                 f"--update_llama_config={update}", f"--tokenizer={FIXTURE_TOKENIZER}",
                 "--mesh_dim=1,1,1,1", "--dtype=fp32", "--max_tokens_per_batch=65536"]
    _reset_launch_counts()
    with recorded_forwards() as fwd:
        run_cli_in_process(eval_needle.main, eval_argv, "eval_needle 32k")
    launches = _launch_counts()
    shapes = [n for n, _ in fwd]
    paths.append(launches)
    prefills, steps = sum(s > 1 for s in shapes), sum(s == 1 for s in shapes)
    want = dict(flash_fwd=CTX_LAYERS * prefills, flash_fwd_f32=CTX_LAYERS * prefills,
                flash_decode=CTX_LAYERS * steps, flash_decode_f32=CTX_LAYERS * steps,
                flash_bwd=0)
    rows = json.loads(results.read_text())
    got = [(r["context_length"], r["depth_percent"], r["correct"]) for r in rows]
    log(f"eval_needle 32k: {len(rows)} row(s) {got}, {prefills} prefill of {max(shapes)} "
        f"tokens, {steps} decode steps; launches {launches}")
    if any(launches[k] != v for k, v in want.items()) or len(rows) != 1 or rows[0][
            "context_length"] != CTX_EVAL_CONTEXT:
        raise AssertionError(f"eval_needle 32k: launches {launches} (want {want}), rows {rows}")
    summary = run_cli_process("lwm_tpu_torch.apps.summarize_needle", [str(results)],
                              "summarize_needle").stdout
    log("summarize_needle: " + " | ".join(summary.strip().splitlines()))
    if "overall: " not in summary or f"{CTX_EVAL_CONTEXT:<10}" not in summary:
        raise AssertionError(f"summarize_needle: {summary!r}")

    # the probe: a counted run in this process, then the hold
    probe = [f"--checkpoint={unscanned}", f"--tokenizer={FIXTURE_TOKENIZER}",
             f"--update_llama_config={update}", *CLI_FLAGS]
    _reset_launch_counts()
    line = run_cli_in_process(probe_needle_digits.main, probe + [f"--n={CTX_PROBE_N}"],
                              "probe_needle_digits")[0].strip()
    launches = _launch_counts()
    paths.append(launches)
    want = dict(flash_fwd=CTX_LAYERS * CTX_PROBE_N, flash_fwd_f32=CTX_LAYERS * CTX_PROBE_N,
                flash_decode=0, flash_bwd=0)
    log(f"probe_needle_digits: {line!r} ({CTX_PROBE_N} prompts); launches {launches}")
    if any(launches[k] != v for k, v in want.items()) or not line.startswith("digit acc"):
        raise AssertionError(f"probe_needle_digits: launches {launches} (want {want})")
    _probe_hold(probe_needle_digits.parse_args(probe + [f"--n={CTX_PROBE_N}"]))
    shutil.rmtree(work, ignore_errors=True)
    return paths


# scripts/run_vision_needle_torch.sh's path (phase_vision_needle) at the
# bundle's widths (VN_BASE_CFG: hidden 384, 4 layers, 6 heads of 64, vision
# vocab 8448, remat nothing_saveable, the char-level fixture tokenizer):
# - data: the vision-needle generator with the bundle's flags, n_train cut
#   to the rows the steps read, and its two mixes (VN_DATA), made in the
#   host process of start_context_extension_data beside the kernel phases;
# - training: stages A-E (VN_STAGES: the bundle's seq, theta, batch, lr,
#   dtype and data, its lr schedule over its own steps) for VN_STEPS steps
#   each (cut from 3000/800/400/1800/3000), each warm-started from the
#   last stage's params:: milestone; exact K1 and backward counts on the
#   route of the stage's dtype (2 x layers x steps and layers x steps: the
#   remat recomputes the forward), finite losses, each step timed;
# - eval: the bundle's whole grid (32/64/128 frames x 5 depths x 2 rounds)
#   through eval_vision_needle's main from E's milestone at fp32, exact K1
#   and K4 fp32 counts (a prefill and each step, a launch a layer), the
#   prefill seconds and ms a step at each frame count; the rerun over its
#   results adds nothing; then summarize_vision_needle. One 32-frame point's
#   prefill logits held, kernel path against an attn_impl="plain" model on
#   the same tensors, at NEEDLE_REL_TOL of the largest; at one point a frame
#   count the greedy answer held to that of the kernel path's structure with
#   K1 and K4 replaced by their plain twins (K1's in F32_TWIN_CHUNK-query
#   chunks: the plain model's scores at 128 frames would take 28 GB a
#   tensor), equal or apart first at a near tie (SPEC_TIE_GAP).
VN_TOKENIZER = Path(__file__).resolve().parent / "tests" / "fixtures" / "tokenizer"
VN_BASE_CFG = ("vocab_size=512,vision_vocab_size=8448,hidden_size=384,intermediate_size=1024,"
               "num_hidden_layers=4,num_attention_heads=6,scan_attention=True,"
               "scan_query_chunk_size=256,scan_key_chunk_size=256,scan_mlp=False,"
               "scan_layers=True,param_scan_axis=0,remat_block='nothing_saveable',"
               "sample_mode='all'")
VN_LAYERS = 4
VN_STEPS = 2
# name, data, seq, theta, the bundle's steps, batch, lr, dtype
VN_STAGES = (("A", "train_short.jsonl", 2560, 10000, 3000, 16, "1e-3", "fp32"),
             ("B", "train_mid.jsonl", 8448, 200000, 800, 4, "5e-4", "bf16"),
             ("C", "train_long.jsonl", 33024, 2000000, 400, 1, "3e-4", "bf16"),
             ("D", "train_stageD.jsonl", 33024, 2000000, 1800, 2, "3e-4", "bf16"),
             ("E", "train_stageE.jsonl", 33024, 2000000, 3000, 2, "3e-4", "bf16"))
VN_DATA = (   # module (or the bundle's mix), its flags with n_train cut ({v}: the directory)
    ("create_vision_needle_data",
     "--n_train 32 --min_frames 1 --max_frames 8 --seed 11 --output {v}/train_short.jsonl"),
    ("create_vision_needle_data",
     "--n_train 8 --min_frames 8 --max_frames 32 --seed 12 --output {v}/train_mid.jsonl"),
    ("create_vision_needle_data",
     "--n_train 2 --min_frames 96 --max_frames 128 --seed 13 --output {v}/train_long.jsonl"),
    ("create_vision_needle_data", "--n_train 2 --min_frames 24 --max_frames 128 --seed 14 "
     "--output {v}/train_mix_long.jsonl"),
    ("mix", "{v}/train_stageD.jsonl {v}/train_mix_long.jsonl {v}/train_long.jsonl"),
    ("create_vision_needle_data", "--n_train 4 --min_frames 24 --max_frames 128 --seed 15 "
     "--output {v}/train_mix2.jsonl"),
    ("mix", "{v}/train_stageE.jsonl {v}/train_mix2.jsonl {v}/train_stageD.jsonl"),
    # run_vision_validation.sh's pattern data: 4 steps of 32 rows
    ("create_vision_train_data", "--n_train 128 --n_patterns 12 --output {v}/train.jsonl"),
)
VN_FRAMES, VN_DEPTHS, VN_ROUNDS = (32, 64, 128), (0, 25, 50, 75, 100), 2
VN_EVAL_CFG = f"dict({VN_BASE_CFG},max_sequence_length=33040,theta=2000000)"
VN_HELD_DEPTH = 50   # the depth of the points held to the plain path
PLATFORM_FLAGS = ()  # the --platform apps' flags (a rehearsal on the CPU adds --platform=cpu)


def _vn_argv(work, stage, warm):
    """run_vision_needle.sh's `stage` flags for a stage (its own steps)."""
    name, data, seq, theta, total, batch, lr, dtype = stage
    return [
        "--modality=vision,text", *CLI_FLAGS, "--mesh_dim=1,1,1,1", f"--dtype={dtype}",
        f"--total_steps={VN_STEPS}", "--log_freq=1", f"--save_model_freq={VN_STEPS}",
        *([f"--load_checkpoint=params::{warm}"] if warm else []),
        f"--update_llama_config=dict({VN_BASE_CFG},max_sequence_length={seq},theta={theta})",
        f"--tokenizer={VN_TOKENIZER}", "--train_dataset.type=json_vision",
        "--train_dataset.vision_text_processor.fields_from_example=fields",
        f"--train_dataset.json_vision_dataset.path={work / data}",
        f"--train_dataset.json_vision_dataset.seq_length={seq}",
        f"--train_dataset.json_vision_dataset.batch_size={batch}",
        "--train_dataset.json_vision_dataset.mode=pad",
        f"--optimizer.adamw_optimizer.lr={lr}", "--optimizer.adamw_optimizer.end_lr=1e-4",
        "--optimizer.adamw_optimizer.lr_warmup_steps=100",
        f"--optimizer.adamw_optimizer.lr_decay_steps={total}",
        f"--logger.output_dir={work / ('run_' + name)}", "--logger.experiment_id=v",
    ]


def _train_stage(argv, what, layers, steps, f32):
    """One training CLI run in this process, its steps synced and timed:
    exact K1 and backward counts on the route of its dtype (2 x layers x
    steps and layers x steps: remat nothing_saveable recomputes the
    forward), finite losses. Returns (its last milestone, the launch counts,
    the step seconds, the losses, the wall seconds)."""
    times, real_step = [], train.train_step

    def timed_step(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_step(*a, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    train.train_step = timed_step
    t0 = time.perf_counter()
    try:
        summary = train.main(argv)
    finally:
        train.train_step = real_step
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    losses = [r["loss"] for r in _metrics(summary)]
    n = layers * steps
    want = dict(flash_fwd=2 * n, flash_fwd_f32=2 * n if f32 else 0, flash_bwd=n,
                flash_bwd_f32=n if f32 else 0, flash_decode=0)
    if any(launches[k] != v for k, v in want.items()) or len(losses) != steps or not all(
            map(math.isfinite, losses)):
        raise AssertionError(f"{what}: launches {launches} (want {want}), losses {losses}")
    milestone = sorted(Path(summary["output_dir"]).glob("streaming_params_*"))[-1]
    torch.cuda.empty_cache()
    return milestone, launches, times, losses, wall


@contextlib.contextmanager
def chunked_twins():
    """The kernel path's structure with K1 and K4 replaced by their plain
    twins where the model calls them, K1's over F32_TWIN_CHUNK queries a
    call."""
    saved = llama_module.flash_attention_fwd, llama_module.flash_decode
    llama_module.flash_attention_fwd = (
        lambda q, k, v, bias, **kw: _k1_twin(q, k, v, bias, kw, F32_TWIN_CHUNK))
    llama_module.flash_decode = decode.flash_decode_plain
    try:
        yield
    finally:
        llama_module.flash_attention_fwd, llama_module.flash_decode = saved


def _greedy_held(model, args, proc, n_frames, what):
    """One grid point's greedy tokens through `model` and through the same
    model under chunked_twins: equal, or apart first at a near tie of the
    twins' logits."""
    key, _, ids, vm, am = eval_vision_needle.point(args, proc, n_frames, VN_HELD_DEPTH, 0)
    on = [torch.as_tensor(x, device="cuda") for x in (ids, vm, am)]
    cfg = generation.GenerationConfig(max_new_tokens=args.max_new_tokens, pad_token_id=0,
                                      eos_token_id=proc.tokenizer.eos_token_id)
    got = generation.generate(model, on[0], on[2], cfg, vision_masks=on[1])[0]
    with chunked_twins():
        want = generation.generate(model, on[0], on[2], cfg, vision_masks=on[1])[0]
        apart = torch.nonzero(got != want)[:, 0].tolist()
        gap = None
        if apart:
            at = apart[0]
            ext = torch.cat([on[0], want[None, :at]], 1)
            mask = torch.cat([on[2], torch.ones_like(want[None, :at])], 1)
            vms = torch.cat([on[1], torch.zeros_like(want[None, :at], dtype=torch.bool)], 1)
            lg = generation.prefill(model, ext, mask, 1, vms)[0][0]
            top = lg.topk(2).values
            gap = (top[0] - top[1]).item()
    text = proc.tokenizer.decode(got.tolist(), skip_special_tokens=True).strip()
    log(f"{what} {key} ({ids.shape[1]} tokens): kernel answer {text!r}, "
        f"{'equal to the twins' if not apart else f'apart from the twins first at {apart[0]}, top-2 gap {gap:.2e}'}")
    if apart and not gap < SPEC_TIE_GAP:
        raise AssertionError(f"{what} {key}: the kernel path's answer differs from the twins' "
                             "off a near tie")


def phase_vision_needle(data):
    """See VN_*; `data` is start_context_extension_data's. Returns every
    counted run's launch counts."""
    work = data[1] / "vision"
    host_data(data)
    paths, warm = [], None
    for stage in VN_STAGES:
        name, _, seq, _, _, batch, _, dtype = stage
        warm, launches, times, losses, wall = _train_stage(
            _vn_argv(work, stage, warm), f"vision needle stage {name}", VN_LAYERS, VN_STEPS,
            dtype == "fp32")
        paths.append(launches)
        log(f"vision needle stage {name} ({batch} x {seq}, {dtype}): {VN_STEPS} steps in "
            f"{wall:.1f}s of wall, steps {', '.join(f'{t:.3f}' for t in times)} s "
            f"({batch * seq / times[-1]:.0f} tokens/s at the last), losses "
            f"{[round(x, 4) for x in losses]}, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; launches {launches} "
            f"[{card()}]")

    results = work / "results.json"
    argv = ["--checkpoint", str(warm), "--tokenizer", str(VN_TOKENIZER),
            "--update_llama_config", VN_EVAL_CFG, "--n_frames", ",".join(map(str, VN_FRAMES)),
            "--depths", ",".join(map(str, VN_DEPTHS)), "--rounds", str(VN_ROUNDS),
            "--output", str(results),
            *PLATFORM_FLAGS]
    _reset_launch_counts()
    with recorded_forwards() as fwd:
        out = run_cli_in_process(eval_vision_needle.main, argv, "eval_vision_needle")[0]
    launches = _launch_counts()
    paths.append(launches)
    prefills = [i for i, (n, _) in enumerate(fwd) if n > 1]
    n_steps = len(fwd) - len(prefills)
    want = dict(flash_fwd=VN_LAYERS * len(prefills), flash_fwd_f32=VN_LAYERS * len(prefills),
                flash_decode=VN_LAYERS * n_steps, flash_decode_f32=VN_LAYERS * n_steps,
                flash_bwd=0)
    rows = json.loads(results.read_text())
    log(f"eval_vision_needle: {len(rows)} points, {out.strip().splitlines()[-1]}; "
        f"launches {launches}")
    n_points = len(VN_FRAMES) * len(VN_DEPTHS) * VN_ROUNDS
    if (any(launches[k] != v for k, v in want.items()) or len(rows) != n_points
            or len(prefills) != n_points):
        raise AssertionError(f"eval_vision_needle: launches {launches} (want {want}), "
                             f"{len(rows)} points, {len(prefills)} prefills")
    ends = prefills[1:] + [len(fwd)]
    by_frames = {}   # the points in the results' order, which is the grid's
    for (s, e), key in zip(zip(prefills, ends), rows):
        by_frames.setdefault(rows[key]["n_frames"], []).append((fwd[s], fwd[s + 1:e]))
    for n_frames, pts in by_frames.items():
        pre = [p[1] for p, _ in pts]
        step = [t for _, steps in pts for _, t in steps]
        log(f"eval_vision_needle {n_frames} frames: {len(pts)} points of {pts[0][0][0]} "
            f"tokens, prefill {np.median(pre):.3f}s (median; {pts[0][0][0] / np.median(pre):.0f} "
            f"tokens/s), {1e3 * np.mean(step):.2f} ms a step over {len(step)} steps "
            f"[{card()}]")
    again = run_cli_in_process(eval_vision_needle.main, argv, "eval_vision_needle rerun")[0]
    if json.loads(results.read_text()) != rows or len(again.strip().splitlines()) != 1:
        raise AssertionError("eval_vision_needle: the rerun did not skip the done points")
    grid = run_cli_in_process(summarize_vision_needle.main, [str(results)],
                              "summarize_vision_needle")[0]
    for line in grid.strip().splitlines():
        log(f"summarize_vision_needle: {line}")
    if len(grid.strip().splitlines()) != 5 or not grid.startswith("frames(vis-toks)"):
        raise AssertionError(f"summarize_vision_needle: {grid!r}")

    # the holds: the 32-frame point's prefill logits against the plain
    # model, and a point a frame count's answer against the twins
    args = eval_vision_needle.parse_args(argv)
    proc = eval_vision_needle.processor(Tokenizer(str(VN_TOKENIZER)), args.n_per_frame)
    model = eval_vision_needle.load_vision_model(args, torch.device("cuda"),
                                                 eval_vision_needle.FORCED)
    plain = VideoLLaMAForCausalLM.on_tensors(model.config.replace(attn_impl="plain"),
                                             dict(model.named_parameters()), torch.float32)
    key, _, ids, vm, am = eval_vision_needle.point(args, proc, VN_FRAMES[0], VN_HELD_DEPTH, 0)
    on = [torch.as_tensor(x, device="cuda") for x in (ids, am, vm)]
    got, want = (generation.prefill(m, *on[:2], args.max_new_tokens, on[2])[0]
                 for m in (model, plain))
    rel = ((got - want).abs().max() / want.abs().max()).item()
    log(f"eval_vision_needle {key}: prefill's last logits ({ids.shape[1]} tokens), kernel vs "
        f"plain fp32 max|Δ|/max|plain| {rel:.3e} (tol {NEEDLE_REL_TOL})")
    if not rel <= NEEDLE_REL_TOL:
        raise AssertionError("eval_vision_needle: prefill logits disagree with the plain path")
    del plain, got, want
    torch.cuda.empty_cache()
    for n_frames in VN_FRAMES:
        _greedy_held(model, args, proc, n_frames, "eval_vision_needle")
    del model
    torch.cuda.empty_cache()
    return paths


# scripts/run_vision_validation_torch.sh's path (phase_vision_validation):
# its pattern data (VN_DATA's last job: 128 rows, 4 steps of 32), the
# dual-head trainer at its config and flags (hidden 384, 4 layers,
# sample_mode 'all', fp32, 32 x 384, `pad`) for VV_STEPS steps (cut from
# 3000; exact K1 and backward fp32 counts), then probe_vision_patterns over
# its milestone on the card for VV_PATTERNS patterns (of the bundle's 12,
# cut for room): 257 CFG steps each
# at top-k 1, exact K1/K4 fp32 counts (a prefill and each step, a launch a
# layer), ms a step; one pattern's 257 tokens equal to those of an
# attn_impl="plain" model on the same tensors.
VV_BASE_CFG = ("vocab_size=512,vision_vocab_size=8448,hidden_size=384,intermediate_size=1024,"
               "num_hidden_layers=4,num_attention_heads=6,max_sequence_length=512,"
               "scan_attention=False,scan_mlp=False,scan_layers=True,param_scan_axis=0,"
               "remat_block='nothing_saveable'")
VV_STEPS, VV_PATTERNS, VV_HELD_PATTERN = 4, 6, 3


def phase_vision_validation(data):
    """See VV_*; `data` is start_context_extension_data's. Returns the
    counted runs' launch counts."""
    work = data[1] / "vision"
    host_data(data)
    argv = [
        "--modality=vision,text", *CLI_FLAGS, "--mesh_dim=1,1,1,1", "--dtype=fp32",
        f"--total_steps={VV_STEPS}", "--log_freq=1", f"--save_model_freq={VV_STEPS}",
        f"--update_llama_config=dict({VV_BASE_CFG},sample_mode='all')",
        f"--tokenizer={VN_TOKENIZER}", "--train_dataset.type=json_vision",
        "--train_dataset.vision_text_processor.fields_from_example=fields",
        f"--train_dataset.json_vision_dataset.path={work / 'train.jsonl'}",
        "--train_dataset.json_vision_dataset.seq_length=384",
        "--train_dataset.json_vision_dataset.batch_size=32",
        "--train_dataset.json_vision_dataset.mode=pad",
        "--optimizer.adamw_optimizer.lr=1e-3", "--optimizer.adamw_optimizer.end_lr=1e-4",
        "--optimizer.adamw_optimizer.lr_warmup_steps=100",
        "--optimizer.adamw_optimizer.lr_decay_steps=3000",
        f"--logger.output_dir={work / 'run'}", "--logger.experiment_id=patterns",
    ]
    milestone, launches, times, losses, wall = _train_stage(
        argv, "vision validation trainer", VN_LAYERS, VV_STEPS, True)
    paths = [launches]
    log(f"vision validation trainer (32 x 384, fp32, sample_mode 'all'): {VV_STEPS} steps in "
        f"{wall:.1f}s of wall, steps {', '.join(f'{t:.3f}' for t in times)} s, losses "
        f"{[round(x, 4) for x in losses]}; launches {launches} [{card()}]")

    probe = ["--checkpoint", str(milestone), "--tokenizer", str(VN_TOKENIZER),
             "--update_llama_config", f"dict({VV_BASE_CFG})",
             "--n_patterns", str(VV_PATTERNS), *PLATFORM_FLAGS]
    _reset_launch_counts()
    with recorded_forwards() as fwd:
        out = run_cli_in_process(probe_vision_patterns.main, probe, "probe_vision_patterns")[0]
    launches = _launch_counts()
    paths.append(launches)
    lines = out.strip().splitlines()
    prefills = sum(n > 1 for n, _ in fwd)
    n_steps = len(fwd) - prefills
    want = dict(flash_fwd=VN_LAYERS * prefills, flash_fwd_f32=VN_LAYERS * prefills,
                flash_decode=VN_LAYERS * n_steps, flash_decode_f32=VN_LAYERS * n_steps,
                flash_bwd=0)
    for line in lines:
        log(f"probe_vision_patterns: {line}")
    step_ms = 1e3 * np.mean([t for n, t in fwd if n == 1])
    log(f"probe_vision_patterns: {prefills} CFG prefills of {fwd[0][0]} tokens x 2 rows, "
        f"{n_steps} steps, {step_ms:.2f} ms a step; launches {launches} [{card()}]")
    if (any(launches[k] != v for k, v in want.items()) or prefills != VV_PATTERNS
            or len(lines) != VV_PATTERNS + 1 or not lines[-1].startswith("code acc")):
        raise AssertionError(f"probe_vision_patterns: launches {launches} (want {want}), "
                             f"{prefills} prefills, lines {lines}")

    args = probe_vision_patterns.parse_args(probe)
    proc = eval_vision_needle.processor(Tokenizer(str(VN_TOKENIZER)))
    model = eval_vision_needle.load_vision_model(args, torch.device("cuda"),
                                                 probe_vision_patterns.FORCED)
    plain = VideoLLaMAForCausalLM.on_tensors(model.config.replace(attn_impl="plain"),
                                             dict(model.named_parameters()), torch.float32)
    prompt, _ = probe_vision_patterns.pattern_prompt(proc, VV_HELD_PATTERN)
    got, want = (probe_vision_patterns.draw(m, prompt, args.cfg_scale, VV_HELD_PATTERN)
                 for m in (model, plain))
    apart = np.flatnonzero(got != want)
    if len(apart):
        raise AssertionError(f"probe_vision_patterns pattern {VV_HELD_PATTERN}: tokens apart "
                             f"from the plain path's first at {int(apart[0])}")
    log(f"probe_vision_patterns pattern {VV_HELD_PATTERN}: all {len(got)} tokens equal the "
        f"plain fp32 path's")
    del model, plain
    torch.cuda.empty_cache()
    return paths


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
# (TRAIN_CLI_STEPS and VISION_TRAIN_STEPS cut from 6 to 4 and 3 for room)
TRAIN_CLI_STEPS, TRAIN_CLI_FUSED_STEPS, ROUNDTRIP_LAYERS, TRAIN_CLI_POOL = 4, 2, 1, 4
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
    for TRAIN_CLI_STEPS steps (finite, falling loss; exact K1 and backward launches; step
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
VISION_TRAIN_LAYERS, VISION_TRAIN_STEPS, VISION_TRAIN_LINES = 16, 3, 64
# the --freeze_base and PaLM runs: 2 steps at 4 layers (at 16 they were
# timed again only; the held behaviour, frozen leaves bit-unchanged and a
# PaLM step, does not depend on the depth)
VISION_SHORT_STEPS, VISION_SHORT_LAYERS = 2, 4
# ROADMAP C5: a --loss_chunk_size of the whole sequence may peak at most this
# far above the default path (where the whole-sequence dual CE peaked 6.2
# GiB above it and once failed to allocate)
C5_PEAK_SLACK_GIB = 1.0
C5_STEPS = 2   # the loss's pieces peak in every step alike (cut from 6 for room)
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
    """Vision-text training as a user runs it (see VISION_TRAIN_*):
    VISION_TRAIN_STEPS AdamW steps (finite, falling loss; both halves finite; exact K1 and backward
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
                              f"--total_steps={C5_STEPS}",
                              f"--loss_chunk_size={VISION_TRAIN_SEQ}"),
            layers, C5_STEPS, "vision loss_chunk_whole")
        c5_peak = torch.cuda.max_memory_allocated() / 2**30
        paths.append(c5_launches)
        c5_losses = [r["loss"] for r in _vision_records(c5_summary, "train vision loss_chunk_whole")]
        log(f"train vision --loss_chunk_size={VISION_TRAIN_SEQ}: {C5_STEPS} steps, peak "
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
    ctx_data = start_context_extension_data()   # host work beside the kernel phases
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    *k1, k1_cases = phase_k1(gen)
    *k4, k4_cases = phase_k4(gen)
    k1_f32, k4_f32, f32_err = phase_f32_kernels(gen)
    bwd = phase_bwd(gen)
    bwd_f32_err, bwd_f32, k1_f32_train = phase_bwd_f32(gen)
    ring_blocks = phase_ring_kernels(gen)
    k1_vision, bwd_vision = phase_train_vision_kernels(gen)
    k1_vneedle, bwd_vneedle = phase_train_vision_kernels(gen, 33024, 6, 64, VN_TRAIN_REPORT,
                                                         faults=False)
    k56, k56_named = phase_k56(gen)
    hd = phase_head_dims(gen)
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
    path_launches.extend(phase_vision_chat(fp32, vq))
    path_launches.append(phase_train_vqgan())
    mark("VQGAN, vision generation, vision chat and the VQ trainer")
    del model, fp32
    torch.cuda.empty_cache()
    path_launches.extend(phase_serve_int8(bf16_summary))
    torch.cuda.empty_cache()
    mark("int8 serving")
    path_launches.extend(phase_3b())
    torch.cuda.empty_cache()
    mark("the 3b preset's paths (head dim 100)")
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
    mark("fp32 training")
    with tempfile.TemporaryDirectory(prefix="lwm_mesh_") as work:
        ranks, _ = spawn_mesh_ranks(Path(work))
        path_launches.extend(phase_train_ring(ranks, Path(work)))
        torch.cuda.empty_cache()
        mark("ring training (two ranks on the card)")
        path_launches.extend(phase_train_mesh(ranks))
        mark("fsdp x tp training (the same two ranks)")
        path_launches.extend(phase_serve_mesh(ranks, Path(work)))
        torch.cuda.empty_cache()
        mark("serving, generate and the needle eval on a mesh (the same two ranks)")
    path_launches.extend(phase_vision_needle(ctx_data))
    torch.cuda.empty_cache()
    mark("the vision-needle bundle's path")
    path_launches.extend(phase_vision_validation(ctx_data))
    torch.cuda.empty_cache()
    mark("the vision-validation bundle's path")
    path_launches.extend(phase_context_extension(ctx_data, bwd_f32[BWD_F32_32K]["ms"]))
    torch.cuda.empty_cache()
    mark("the context-extension chain")
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
             **k1_cases, **{VISION_TRAIN_REPORT: k1_vision, VN_TRAIN_REPORT: k1_vneedle},
             **ring_blocks["flash_fwd"], **hd["flash_fwd"],
             **f32_cases(dict(k1_f32, **{BWD_F32_REPORT: k1_f32_train}, **k1_spec,
                              **ring_blocks["flash_fwd_f32"], **hd["flash_fwd_f32"]),
                         "flash_fwd_f32.cu", "flash_fwd")),
        dict(row("flash_bwd", "flash_bwd.cu",
                 "lwm_tpu/ops/pallas_flash.py:288 and lwm_tpu/ops/pallas_flash.py:356", *bwd),
             **{VISION_TRAIN_REPORT: bwd_vision, VN_TRAIN_REPORT: bwd_vneedle},
             **ring_blocks["flash_bwd"], **hd["flash_bwd"]),
        dict(row("flash_bwd_f32", "flash_bwd_f32.cu",
                 "lwm_tpu/ops/pallas_flash.py:288 and lwm_tpu/ops/pallas_flash.py:356",
                 bwd_f32_err, *(bwd_f32[BWD_F32_REPORT][k] for k in (
                     "ms", "plain_ms", "library_ms", "bound_ms", "bound_by"))),
             fma_bound_ms=bwd_f32[BWD_F32_REPORT]["fma_bound_ms"],
             **{name: bwd_f32[name] for name in (BWD_F32_8K, BWD_F32_32K)},
             **ring_blocks["flash_bwd_f32"], **hd["flash_bwd_f32"]),
        dict(row("flash_decode", "flash_decode.cu", "lwm_tpu/ops/pallas_decode.py:66", *k4),
             **k4_cases, **hd["flash_decode"],
             **f32_cases(dict(k4_f32, **k4_spec, **hd["flash_decode_f32"]), "flash_decode.cu",
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
