"""Vision-needle retrieval eval: fresh long synthetic videos (noise frames
and one pattern frame at a set depth), scored by whether the model names
the pattern after the video, over a grid of frame count × depth × round.

Counterpart of `lwm_tpu/apps/eval_vision_needle.py`, with its flags,
seeding, prompts and results file. `--platform` keeps the JAX spelling:
"default" runs on the card (and raises without CUDA), "cpu" on the CPU,
"tpu" is refused. Each point:
- draws from `random.Random((seed, frames, depth, round).__hash__() &
  0x7FFFFFFF)` the class and the noise frames
  (`create_vision_needle_data.build_example`, the needle at frame
  round(depth / 100 · (frames − 1)));
- builds the tokens through `data.vision.VisionTextProcessor`
  (`n_tokens_per_frame=--n_per_frame`), so that the layout is the
  trainer's, and cuts them where the loss-trained answer begins;
- left-pads the prompt to a multiple of `--pad_multiple` and decodes
  `--max_new_tokens` greedy tokens (`generation.generate` with the
  prompt's vision masks; pad 0, the tokenizer's eos) through the
  checkpoint's VideoLLaMA at fp32 in `sample_mode="text"`; on the card the
  prefill runs K1's fp32 route and each step K4's fp32 instance;
- is correct when the class's name is a word of the answer, decoded
  without special tokens.
The results JSON is written after every point, and a rerun skips the keys
it holds. `--checkpoint` is a params stream (`streaming_params_*`), read
by `checkpoint.load_checkpoint`; the tokenizer is `utils.tokenizer.
Tokenizer` on a local directory.

Run: python -m lwm_tpu_torch.apps.eval_vision_needle \\
    --checkpoint <streaming_params> --tokenizer tests/fixtures/tokenizer \\
    --update_llama_config "dict(hidden_size=384,...)" \\
    --n_frames 32,64,128 --depths 0,25,50,75,100 --rounds 2 \\
    --output vneedle/results.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random

import numpy as np
import torch

from lwm_tpu_torch.apps.create_vision_needle_data import build_example
from lwm_tpu_torch.apps.create_vision_train_data import _NAMES
from lwm_tpu_torch.checkpoint import load_checkpoint
from lwm_tpu_torch.data.vision import VisionTextProcessor
from lwm_tpu_torch.generation import GenerationConfig, generate
from lwm_tpu_torch.models.vision_llama import VideoLLaMAConfig, VideoLLaMAForCausalLM
from lwm_tpu_torch.utils.convert import convert_flax_params
from lwm_tpu_torch.utils.tokenizer import Tokenizer

# the config fields the JAX app forces over `--update_llama_config`
# (`:79-84`): text answers, one flash prefill over the cache, no remat
FORCED = dict(sample_mode="text", scan_attention=False, remat_block="none")


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m lwm_tpu_torch.apps.eval_vision_needle")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--tokenizer", required=True)
    p.add_argument("--update_llama_config", default="")
    p.add_argument("--n_patterns", type=int, default=12)
    p.add_argument("--n_codes", type=int, default=8192)
    p.add_argument("--n_per_frame", type=int, default=256)
    p.add_argument("--n_frames", default="32,64,128")
    p.add_argument("--depths", default="0,25,50,75,100")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--seed", type=int, default=20260820)
    # the fixture tokenizer is char-level: " eleven" and the eos are 8
    # tokens, so the budget must cover the longest class name
    p.add_argument("--max_new_tokens", type=int, default=10)
    p.add_argument("--pad_multiple", type=int, default=256)
    p.add_argument("--output", required=True)
    p.add_argument("--platform", default="default", choices=["cpu", "tpu", "default"])
    return p.parse_args(argv)


def platform_device(platform):
    """The JAX apps' `--platform` on the port: "default" is the card,
    "cpu" the CPU; "tpu" is refused."""
    if platform == "tpu":
        raise ValueError("--platform=tpu: the port runs on a CUDA card (--platform=default) "
                         "or on the CPU (--platform=cpu)")
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--platform=default runs on the card and CUDA is not available: "
                           "pass --platform=cpu to run on the CPU")
    return torch.device("cuda")


def load_vision_model(args, device, forced):
    """The checkpoint's VideoLLaMA at fp32 on `device`: the default config,
    `--update_llama_config` over it, then `forced` over that, as the JAX
    apps update theirs."""
    updates = {}
    if args.update_llama_config:
        # the JAX CLI's spelling: a Python expression, "dict(hidden_size=384, ...)"
        updates = dict(eval(args.update_llama_config, {"dict": dict}))  # noqa: S307
    cfg = VideoLLaMAConfig.from_dict(
        {**dataclasses.asdict(VideoLLaMAConfig()), **updates, **forced})
    sd = convert_flax_params(load_checkpoint(args.checkpoint), cfg, dtype=torch.float32,
                             device=device)
    return VideoLLaMAForCausalLM.on_tensors(cfg, sd, torch.float32)


def processor(tokenizer, n_per_frame=None):
    """The trainer's vision-text processor of the JSONL's "fields"."""
    updates = dict(fields_from_example="fields")
    if n_per_frame is not None:
        updates["n_tokens_per_frame"] = n_per_frame
    return VisionTextProcessor(VisionTextProcessor.get_default_config(updates), tokenizer)


def point(args, proc, n_frames, depth, rnd):
    """A grid point's (key, class, ids, vision masks, attention mask), the
    three numpy [1, L], the prompt left-padded to a `--pad_multiple`
    multiple (`:133-161`)."""
    key = f"frames{n_frames}_depth{depth}_round{rnd}"
    rng = random.Random((args.seed, n_frames, depth, rnd).__hash__() & 0x7FFFFFFF)
    cls = rng.randrange(args.n_patterns)
    needle_pos = round(depth / 100 * (n_frames - 1))
    ex = build_example(rng, n_frames, needle_pos, cls, args.n_codes, args.n_per_frame)
    tokens, masks, vision, _ = proc(ex)
    # the prompt ends where the loss-trained answer begins
    ans_start = next(i for i, m in enumerate(masks) if m > 0)
    prompt, vm = tokens[:ans_start], vision[:ans_start]
    length = -(-len(prompt) // args.pad_multiple) * args.pad_multiple
    ids = np.zeros((1, length), np.int64)
    vmask = np.zeros((1, length), bool)
    amask = np.zeros((1, length), np.int64)
    ids[0, -len(prompt):] = prompt
    vmask[0, -len(prompt):] = vm
    amask[0, -len(prompt):] = 1
    return key, cls, ids, vmask, amask


def main(argv=None):
    args = parse_args(argv)
    device = platform_device(args.platform)
    enc = Tokenizer(args.tokenizer)
    proc = processor(enc, args.n_per_frame)
    model = load_vision_model(args, device, FORCED)
    gen_cfg = GenerationConfig(max_new_tokens=args.max_new_tokens, do_sample=False,
                               pad_token_id=0, eos_token_id=enc.eos_token_id)

    results = {}
    if os.path.exists(args.output):
        with open(args.output) as f:
            results = json.load(f)

    frames_list = [int(x) for x in args.n_frames.split(",")]
    depths = [int(x) for x in args.depths.split(",")]
    n_correct = n_total = 0
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    for n_frames in frames_list:
        for depth in depths:
            for rnd in range(args.rounds):
                key = f"frames{n_frames}_depth{depth}_round{rnd}"
                if key in results:
                    n_total += 1
                    n_correct += int(results[key]["correct"])
                    continue
                _, cls, ids, vmask, amask = point(args, proc, n_frames, depth, rnd)
                new = generate(model, torch.as_tensor(ids, device=device),
                               torch.as_tensor(amask, device=device), gen_cfg,
                               vision_masks=torch.as_tensor(vmask, device=device))
                text = enc.decode(new[0].tolist(), skip_special_tokens=True)
                want = _NAMES[cls]
                correct = want in text.split()
                results[key] = {
                    "n_frames": n_frames,
                    "vision_tokens": n_frames * (args.n_per_frame + 1),
                    "depth_pct": depth,
                    "round": rnd,
                    "target": want,
                    "answer": text.strip(),
                    "correct": bool(correct),
                }
                n_total += 1
                n_correct += int(correct)
                with open(args.output, "w") as f:
                    json.dump(results, f, indent=1)
                print(f"{key}: target={want!r} answer={text.strip()!r} "
                      f"{'OK' if correct else 'MISS'}  ({n_correct}/{n_total} so far)",
                      flush=True)

    print(f"total: {n_correct}/{n_total} = {n_correct / max(n_total, 1):.1%}")


if __name__ == "__main__":
    main()
