"""Teacher-forced needle-retrieval probe: the decode-free measure of whether
a checkpoint retrieves or memorizes.

Counterpart of `lwm_tpu/apps/probe_needle_digits.py`, with its flags and
its output line, `--device` in place of `--platform` (the card by default;
"cpu" for the CPU; without CUDA the default raises). It builds fresh
eval-style needle prompts (new cities, numbers and filler from `--seed`,
drawn in the JAX probe's order), teacher-forces the answer line through one
forward of `LLaMAForCausalLM` at fp32 (on the card, K1's fp32 route), and
reports argmax accuracy on the digit positions and on whole numbers. The
numbers are fresh, so accuracy above 10% a digit is in-context retrieval.

Run: python -m lwm_tpu_torch.apps.probe_needle_digits \\
    --checkpoint STREAMING_PARAMS_PATH --tokenizer tests/fixtures/tokenizer \\
    --update_llama_config "dict(hidden_size=768,...)" [--n 24] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import random

import torch

from lwm_tpu_torch.apps.create_needle_train_data import (
    NEEDLE_TEMPLATE,
    RETRIEVAL_QUESTION,
    insert_needle_tokens,
    make_filler_sentences,
    period_token_ids,
)
from lwm_tpu_torch.apps.eval_needle import PROMPT_TEMPLATE, RANDOM_NEEDLE_CITIES
from lwm_tpu_torch.checkpoint import load_checkpoint
from lwm_tpu_torch.models.llama import LLaMAConfig, LLaMAForCausalLM
from lwm_tpu_torch.utils.convert import convert_flax_params
from lwm_tpu_torch.utils.tokenizer import Tokenizer


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m lwm_tpu_torch.apps.probe_needle_digits")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--tokenizer", required=True)
    p.add_argument("--update_llama_config", default="")
    p.add_argument("--n", type=int, default=24)
    p.add_argument("--ctx_min", type=int, default=200)
    p.add_argument("--ctx_max", type=int, default=800)
    p.add_argument("--n_distractors", type=int, default=0)
    p.add_argument("--seed", type=int, default=99)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def load_model(args):
    """The fp32 model of the checkpoint: the default config (as the JAX
    probe's `LLaMAConfig()`) with `--update_llama_config` over it."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass --device=cpu to probe on the CPU")
    cfg = LLaMAConfig()
    if args.update_llama_config:
        # the JAX CLI's spelling: a Python expression, "dict(hidden_size=768, ...)"
        updates = dict(eval(args.update_llama_config, {"dict": dict}))  # noqa: S307
        cfg = LLaMAConfig.from_dict({**dataclasses.asdict(cfg), **updates})
    sd = convert_flax_params(load_checkpoint(args.checkpoint), cfg, dtype=torch.float32,
                             device=device)
    return LLaMAForCausalLM.on_tensors(cfg, sd, torch.float32)


def probe(model, enc, args):
    """(digit hits, digits, whole-number hits, [(each prompt's teacher-forced
    ids, its argmaxes at every position)]) of `args.n` fresh prompts."""
    period_tokens = period_token_ids(enc)
    rng = random.Random(args.seed)
    filler = enc.encode(make_filler_sentences(rng, 3000), add_special_tokens=False)
    device = model.wte.weight.device
    bos = model.config.bos_token_id
    digit_hits = number_hits = total_digits = 0
    rows = []
    for _ in range(args.n):
        cities = rng.sample(RANDOM_NEEDLE_CITIES, 1 + args.n_distractors)
        numbers = [str(rng.randint(10 ** 6, 10 ** 7 - 1)) for _ in cities]
        ctx_len = rng.randint(args.ctx_min, args.ctx_max)
        off = rng.randint(0, len(filler) - ctx_len - 1)
        ctx = filler[off: off + ctx_len]
        for c, num in zip(cities, numbers):
            ctx = insert_needle_tokens(enc, ctx, NEEDLE_TEMPLATE.format(city=c, rnd_number=num),
                                       rng.randint(0, 100), period_tokens)
        city, number = cities[0], numbers[0]
        prompt = PROMPT_TEMPLATE.format(context=enc.decode(ctx),
                                        question=RETRIEVAL_QUESTION.format(city))
        answer = f"The special magic {city} number is: {number}"
        # the fields encoded apart, as the trainer's TextProcessor encodes
        # "[question],answer": one encoding of both would merge across the
        # boundary and move the teacher-forced positions
        answer_ids = enc.encode(answer, add_special_tokens=False)
        ids = [bos] + enc.encode(prompt, add_special_tokens=False) + answer_ids
        stem = f"The special magic {city} number is:"
        n_digits = len(answer_ids) - len(enc.encode(stem, add_special_tokens=False))
        x = torch.tensor([ids], dtype=torch.long, device=device)
        with torch.no_grad():
            logits = model(x, torch.ones_like(x), torch.arange(len(ids), device=device)[None])
        preds = logits[0].argmax(-1).cpu()
        rows.append((ids, preds.tolist()))
        tgt = torch.tensor(ids[1:])
        dstart = len(ids) - 1 - n_digits
        hits = preds[:-1][dstart:] == tgt[dstart:]
        digit_hits += int(hits.sum())
        total_digits += n_digits
        number_hits += int(hits.all())
    return digit_hits, total_digits, number_hits, rows


def main(argv=None):
    args = parse_args(argv)
    enc = Tokenizer(args.tokenizer)
    model = load_model(args)
    digit_hits, total_digits, number_hits, _ = probe(model, enc, args)
    print(f"digit acc {digit_hits}/{total_digits} = {digit_hits/total_digits:.2%}"
          f"  full-number {number_hits}/{args.n} = {number_hits/args.n:.1%}")


if __name__ == "__main__":
    main()
