"""Score a pattern-trained VideoLLaMA by drawing frames with the CFG
sampler and comparing their codes with the class's pattern: the vision
counterpart of `apps.probe_needle_digits`. It checks the text → vision
path whole (vte and the dual head's training, `sample_mode='vision'`, the
cond/uncond CFG loop, the EOF after 256 codes) on a task that can be
learned (`apps.create_vision_train_data`).

Counterpart of `lwm_tpu/apps/probe_vision_patterns.py`, with its flags and
its printed lines. `--platform`: "default" runs on the card (and raises
without CUDA), "cpu" on the CPU, "tpu" is refused. Each class's prompt is
built by `data.vision.VisionTextProcessor` (bos, the text, `<vision>`) and
cut at the first code; the pair [cond; uncond] of that prompt twice goes
through `VideoLLaMAForCausalLM.generate_vision` at top-k 1, temperature 1,
257 new tokens, pad 0 (the JAX app's `min_new_tokens` is not read by the
Flax sampler, so none is applied here), the model at fp32 (on the card:
K1's fp32 route in the prefill, K4's fp32 instance in each step). A draw
at top-k 1 is forced, so the tokens are the JAX probe's wherever the two
models' argmaxes agree.

Run: python -m lwm_tpu_torch.apps.probe_vision_patterns \\
    --checkpoint <streaming_params> --tokenizer tests/fixtures/tokenizer \\
    --update_llama_config "dict(hidden_size=384,...)" [--n_patterns 12]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from lwm_tpu_torch.apps.create_vision_train_data import _NAMES, PROMPT_TEMPLATE, pattern_frame
from lwm_tpu_torch.apps.eval_vision_needle import load_vision_model, platform_device, processor
from lwm_tpu_torch.generation import GenerationConfig
from lwm_tpu_torch.utils.tokenizer import Tokenizer

# the config fields the JAX probe forces over `--update_llama_config`
FORCED = dict(scan_attention=False, sample_mode="vision")
NEW_TOKENS = 257   # 256 codes and the EOF


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m lwm_tpu_torch.apps.probe_vision_patterns")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--tokenizer", required=True)
    p.add_argument("--update_llama_config", default="")
    p.add_argument("--n_patterns", type=int, default=12)
    p.add_argument("--cfg_scale", type=float, default=1.0)
    p.add_argument("--platform", default="default", choices=["cpu", "tpu", "default"])
    return p.parse_args(argv)


def pattern_prompt(proc, cls):
    """(class cls's prompt tokens up to its first code, its target codes)."""
    target = pattern_frame(cls)
    example = {"fields": "[text],vision", "text": PROMPT_TEMPLATE.format(name=_NAMES[cls]),
               "vision": target}
    tokens, _, vision, _ = proc(example)
    return tokens[:vision.index(True)], target


def draw(model, prompt, cfg_scale, cls):
    """The cond row's 257 new tokens (numpy) for the prompt's CFG pair."""
    device = model.wte.weight.device
    ids = torch.tensor([prompt] * 2, dtype=torch.long, device=device)   # cond + uncond
    config = GenerationConfig(max_new_tokens=NEW_TOKENS, do_sample=True, top_k=1,
                              temperature=1.0, pad_token_id=0)
    seq = model.generate_vision(
        ids, torch.full((1,), cfg_scale, dtype=torch.float32), torch.ones_like(ids),
        torch.zeros(ids.shape, dtype=torch.bool, device=device), config,
        torch.Generator(device=device).manual_seed(cls))
    return seq[0, ids.shape[1]:].cpu().numpy()


def main(argv=None):
    args = parse_args(argv)
    device = platform_device(args.platform)
    enc = Tokenizer(args.tokenizer)
    proc = processor(enc)
    model = load_vision_model(args, device, FORCED)
    eof = proc.config["eof_token"]

    code_hits = frame_hits = eof_hits = total_codes = 0
    for cls in range(args.n_patterns):
        prompt, target = pattern_prompt(proc, cls)
        gen = draw(model, prompt, args.cfg_scale, cls)
        hits = int((gen[:256] == np.asarray(target)).sum())
        code_hits += hits
        total_codes += 256
        frame_hits += hits == 256
        eof_hits += int(gen[256] == eof)
        print(f"pattern {cls:2d} ({_NAMES[cls]}): {hits}/256 codes, "
              f"eof {'ok' if gen[256] == eof else 'BAD'}")

    print(f"code acc {code_hits}/{total_codes} = {code_hits/total_codes:.2%}  "
          f"whole-frame {frame_hits}/{args.n_patterns} = "
          f"{frame_hits/args.n_patterns:.1%}  eof {eof_hits}/{args.n_patterns}")


if __name__ == "__main__":
    main()
