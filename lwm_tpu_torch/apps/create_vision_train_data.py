"""A synthetic text → frame-token dataset with a learnable mapping: each
example is a prompt naming one of `--n_patterns` classes and one frame of
`--n_per_frame` codes that is a fixed function of the class, so that a
trained VideoLLaMA must route text → vte and the dual head → the CFG
sampler to draw the frame again (`apps.probe_vision_patterns` scores it).

Counterpart of `lwm_tpu/apps/create_vision_train_data.py`, with its flags,
its `random.Random(--seed)` draws in the same order and its output: the
JSONL is the JAX generator's byte for byte at the same flags.

The frame of class c: code[i] = (c · stride + i · step) % n_codes, one code
a position, so drawing it right takes a prediction a position. A line is
`{"fields": "[text],vision", "text": ..., "vision": [codes]}`, for the
trainer's `json_vision` dataset with `fields_from_example='fields'`.

Run: python -m lwm_tpu_torch.apps.create_vision_train_data \\
    --n_train 4000 --output vision/train.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import random

_NAMES = (
    "zero one two three four five six seven eight nine ten eleven twelve "
    "thirteen fourteen fifteen sixteen seventeen eighteen nineteen"
).split()

PROMPT_TEMPLATE = "draw pattern {name} now"


def pattern_frame(cls, n_codes=8192, n_per_frame=256, stride=997, step=13):
    return [(cls * stride + i * step) % n_codes for i in range(n_per_frame)]


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m lwm_tpu_torch.apps.create_vision_train_data")
    p.add_argument("--n_train", type=int, default=4000)
    p.add_argument("--n_patterns", type=int, default=12)
    p.add_argument("--n_codes", type=int, default=8192)
    p.add_argument("--n_per_frame", type=int, default=256)
    p.add_argument("--seed", type=int, default=5)
    p.add_argument("--output", type=str, required=True)
    args = p.parse_args(argv)
    if args.n_patterns > len(_NAMES):
        raise ValueError(f"--n_patterns {args.n_patterns}: at most {len(_NAMES)} classes")
    return args


def main(argv=None):
    args = parse_args(argv)
    rng = random.Random(args.seed)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    with open(args.output, "w") as f:
        for _ in range(args.n_train):
            cls = rng.randrange(args.n_patterns)
            f.write(json.dumps({
                "fields": "[text],vision",
                "text": PROMPT_TEMPLATE.format(name=_NAMES[cls]),
                "vision": pattern_frame(cls, args.n_codes, args.n_per_frame),
            }) + "\n")
    print(f"wrote {args.n_train} pattern examples "
          f"({args.n_patterns} classes) to {args.output}")


if __name__ == "__main__":
    main()
