#!/usr/bin/env python3
"""Time the needle bundle's batches on one GPU and read their peak memory.

    python3 scripts/measure_needle_batch.py [--max_tokens_per_batch=40000] [--steps=16]

scripts/run_eval_needle_torch.sh runs the 7b preset in fp32 over contexts of
1000, 16500 and 32000 tokens (scan chunks 1024: prompts cut to 2048, 18432
and 33792 tokens, 1024 new tokens each), as many prompts a batch as
`--max_tokens_per_batch` / (max_input_length + 1024) allows. For each of
those batches this script builds the 7b model in fp32 with random weights
(32 layers, theta 1e7, max_sequence_length 131072: the bundle's config) on
the card and runs `generation.generate` (greedy, no eos: `--steps` + 1
new tokens) over the batch of random left-padded prompts: the prefill into
a shared-index cache of the bundle's length (K1's fp32 route a layer),
then `--steps` decode steps (K4's fp32 route a layer a step). The
prefill's time is read around `generation.prefill`, which `generate`
calls; the decode's is the rest of the call. It prints, a batch a line,
one JSON object: rows, max_input_length, cache slots, prefill seconds,
decode ms a step, and the peak of allocated device memory from the
prefill through the last step, with the card's name and power limit; the
kernels are built and one short prefill run first, outside every timing.
The weights and inputs are random (seed 0): what is measured is time and
memory, not answers.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from lwm_tpu_torch import generation  # noqa: E402
from lwm_tpu_torch.models.llama import LLaMAConfig, LLaMAForCausalLM, round_cache_length  # noqa: E402
from lwm_tpu_torch.ops import _build, decode, flash  # noqa: E402

CONTEXTS = (1000, 16500, 32000)   # np.linspace(1000, 32000, 3): the bundle's grid
BLOCK = 1024                      # the bundle's scan chunks: the sampler's block_size


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv):
    opts = dict(max_tokens_per_batch=40000, steps=16)
    for arg in argv:
        key, _, value = arg.lstrip("-").partition("=")
        if key not in opts:
            raise SystemExit(f"usage: {sys.argv[0]} [--max_tokens_per_batch=N] [--steps=N]")
        opts[key] = int(value)
    if not 0 < opts["steps"] < BLOCK:   # then generate's cache is the bundle's (1024 new tokens)
        raise SystemExit(f"--steps must lie in 1..{BLOCK - 1}")
    if not torch.cuda.is_available():
        raise SystemExit("measure_needle_batch: no GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LLaMAConfig.load_config("7b").replace(
        theta=10_000_000, max_sequence_length=131072, scan_query_chunk_size=BLOCK,
        scan_key_chunk_size=BLOCK)
    t0 = time.perf_counter()
    model = LLaMAForCausalLM(cfg, dtype=torch.float32, device="cuda").eval()
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"7b fp32 built in {time.perf_counter() - t0:.1f}s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB of weights [{card()}]", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    # the kernels' build and cuBLAS's first products are set-up, not the batch's time
    t0 = time.perf_counter()
    _build.load()
    with torch.no_grad():
        warm = torch.randint(2, cfg.vocab_size, (1, BLOCK), generator=gen, device="cuda")
        generation.prefill(model, warm, None, 1)
    torch.cuda.synchronize()
    print(f"kernels built and warmed up in {time.perf_counter() - t0:.1f}s", flush=True)
    config = generation.GenerationConfig(max_new_tokens=opts["steps"] + 1, pad_token_id=0)
    timed, real_prefill = {}, generation.prefill

    def prefill(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_prefill(*args, **kwargs)
        torch.cuda.synchronize()
        timed["prefill_s"] = time.perf_counter() - t0
        return out

    generation.prefill = prefill
    for context in CONTEXTS:
        max_input = -(-(context + 1024) // BLOCK) * BLOCK
        rows = max(1, int(opts["max_tokens_per_batch"] / (max_input + BLOCK)))
        ids = torch.randint(2, cfg.vocab_size, (rows, max_input), generator=gen, device="cuda")
        mask = torch.ones_like(ids)
        mask[:, :max_input - context - 200] = 0   # the prompt's left padding
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        flash.flash_attention_fwd.f32_launches = decode.flash_decode.f32_launches = 0
        t0 = time.perf_counter()
        generation.generate(model, ids, mask, config)
        torch.cuda.synchronize()
        generate_s = time.perf_counter() - t0
        prefill_s = timed["prefill_s"]
        decode_s = generate_s - prefill_s
        launches = (flash.flash_attention_fwd.f32_launches, decode.flash_decode.f32_launches)
        if launches != (cfg.num_hidden_layers, cfg.num_hidden_layers * opts["steps"]):
            raise AssertionError(f"fp32 launches {launches}")
        print(json.dumps(dict(
            context=context, rows=rows, max_input_length=max_input,
            cache_slots=round_cache_length(cfg, max_input + config.max_new_tokens), prefill_s=prefill_s,
            prefill_tokens_per_s=rows * max_input / prefill_s,
            decode_ms_per_step=1e3 * decode_s / opts["steps"],
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            max_tokens_per_batch=opts["max_tokens_per_batch"], card=card())), flush=True)
        del ids, mask


if __name__ == "__main__":
    main(sys.argv[1:])
