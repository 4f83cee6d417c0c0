"""Vision-needle training data: long synthetic videos whose frames are
random VQ codes (noise that cannot be learned) but for one frame, at a
random depth, that carries a class's pattern (`create_vision_train_data.
pattern_frame`). The question after the video asks which pattern was shown,
so answering it means attending back over up to 128 frames to that frame:
the vision counterpart of the text needle data.

Counterpart of `lwm_tpu/apps/create_vision_needle_data.py`, with its flags,
its `random.Random(--seed)` draws in the same order and its output: the
JSONL is the JAX generator's byte for byte at the same flags. A line is
`{"fields": "[vision],[question],answer", "vision": [...], "question":
"...", "answer": " <name>"}`: the video and the question are loss-masked,
the answer is trained.

Run: python -m lwm_tpu_torch.apps.create_vision_needle_data \\
    --n_train 20000 --min_frames 1 --max_frames 8 \\
    --output vneedle/train_short.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import random

from lwm_tpu_torch.apps.create_vision_train_data import _NAMES, pattern_frame

QUESTION = "which pattern did you see ? answer :"


def noise_frame(rng, n_codes, n_per_frame):
    return [rng.randrange(n_codes) for _ in range(n_per_frame)]


def build_example(rng, n_frames, needle_pos, cls, n_codes, n_per_frame):
    """One example: `n_frames` frames, noise drawn from `rng` but at
    `needle_pos`, where class `cls`'s pattern stands."""
    vq = []
    for j in range(n_frames):
        if j == needle_pos:
            vq.extend(pattern_frame(cls, n_codes, n_per_frame))
        else:
            vq.extend(noise_frame(rng, n_codes, n_per_frame))
    return {
        "fields": "[vision],[question],answer",
        "vision": vq,
        "question": QUESTION,
        "answer": " " + _NAMES[cls],
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m lwm_tpu_torch.apps.create_vision_needle_data")
    p.add_argument("--n_train", type=int, default=20000)
    p.add_argument("--n_patterns", type=int, default=12)
    p.add_argument("--n_codes", type=int, default=8192)
    p.add_argument("--n_per_frame", type=int, default=256)
    p.add_argument("--min_frames", type=int, default=1)
    p.add_argument("--max_frames", type=int, default=8)
    p.add_argument("--seed", type=int, default=11)
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
            n_frames = rng.randint(args.min_frames, args.max_frames)
            needle_pos = rng.randrange(n_frames)
            cls = rng.randrange(args.n_patterns)
            f.write(json.dumps(build_example(rng, n_frames, needle_pos, cls, args.n_codes,
                                             args.n_per_frame)) + "\n")
    print(f"wrote {args.n_train} examples to {args.output}")


if __name__ == "__main__":
    main()
