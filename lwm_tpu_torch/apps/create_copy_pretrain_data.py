"""The pure-copy pretask that warm-starts needle-retrieval training, on the
port's tokenizer reader.

Counterpart of `lwm_tpu/apps/create_copy_pretrain_data.py`, with its flags:
the same `random.Random(--seed)` draws in the same order, so the JSONL is
the JAX generator's byte for byte. Each example is `{span} REPEAT: ` →
`{span}`, a fresh word-salad span to reproduce verbatim (loss on the
repeat alone, fields "[question],answer,[postpad]"), padded to exactly
`--seq_length` tokens (bos + question + answer + postpad + eos), so that
it packs row-aligned with the other exact-length datasets.

Run: python -m lwm_tpu_torch.apps.create_copy_pretrain_data \\
    --tokenizer tests/fixtures/tokenizer --seq_length 512 \\
    --n_train 8000 --output needle/copy.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import random

from lwm_tpu_torch.apps.create_needle_train_data import exact_token_text, make_filler_sentences
from lwm_tpu_torch.utils.tokenizer import Tokenizer


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m lwm_tpu_torch.apps.create_copy_pretrain_data")
    p.add_argument("--tokenizer", type=str, required=True)
    p.add_argument("--seq_length", type=int, default=512)
    p.add_argument("--n_train", type=int, default=8000)
    p.add_argument("--min_span_tokens", type=int, default=40)
    p.add_argument("--max_span_frac", type=float, default=0.42,
                   help="the span's budget as a fraction of seq_length (the span appears "
                        "twice, with the scaffold and the padding)")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--output", type=str, required=True)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    rng = random.Random(args.seed)
    enc = Tokenizer(args.tokenizer)
    max_span = int(args.seq_length * args.max_span_frac)

    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    n = 0
    with open(args.output, "w") as f:
        while n < args.n_train:
            span = make_filler_sentences(rng, rng.randint(4, 20))
            toks = enc.encode(span, add_special_tokens=False)
            if not (args.min_span_tokens <= len(toks) <= max_span):
                continue
            question = span + " REPEAT: "
            used = 1 + len(enc.encode(question, add_special_tokens=False)) + len(toks) + 1
            pad = args.seq_length - used
            if pad < 0:
                continue
            postpad = exact_token_text(enc, pad, rng)
            total = used + len(enc.encode(postpad, add_special_tokens=False))
            if total != args.seq_length:
                continue
            f.write(json.dumps({"question": question, "answer": span, "postpad": postpad})
                    + "\n")
            n += 1
    print(f"wrote {n} exact-{args.seq_length}-token copy examples to {args.output}")


if __name__ == "__main__":
    main()
