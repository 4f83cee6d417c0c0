"""Synthetic needle-retrieval training data (and the eval's filler haystack)
on the port's tokenizer reader.

Counterpart of `lwm_tpu/apps/create_needle_train_data.py`, with its flags,
seeding and output: the same `random.Random(--seed)` draws in the same
order, so the JSONL and the haystack file are the JAX generator's byte for
byte at the same flags. The tokenizer is `utils.tokenizer.Tokenizer` on a
local directory in place of `transformers.AutoTokenizer`.

Each training line is {"question", "answer", "postpad"}: the question is
the eval prompt (`apps.eval_needle.PROMPT_TEMPLATE`) around a filler
context with one "special magic {city} number" needle (and
`--n_distractors` more) inserted at a sentence boundary at a random depth,
counted in tokens as `eval_needle.NeedleInserter` counts them; the answer
is the needle's line (or its digits); the postpad is loss-masked filler
sized so that every example is exactly `--seq_length` tokens under the
fields "[question],answer,[postpad]" with no separator (bos + question +
answer + postpad + eos).

Run: python -m lwm_tpu_torch.apps.create_needle_train_data \\
    --tokenizer tests/fixtures/tokenizer --seq_length 2048 \\
    --n_train 2000 --train_output needle/train.jsonl \\
    --haystack_output needle/haystack.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import random

from lwm_tpu_torch.apps.eval_needle import PROMPT_TEMPLATE, RANDOM_NEEDLE_CITIES
from lwm_tpu_torch.utils.tokenizer import Tokenizer

NEEDLE_TEMPLATE = "\nThe special magic {city} number is: {rnd_number}\n"
RETRIEVAL_QUESTION = "What is the special magic {} number?"

# Filler vocabulary for synthetic haystack sentences: plain common words
# that any byte-level or BPE tokenizer covers.
_WORDS = (
    "the quick brown fox jumps over a lazy dog while morning light settles "
    "across quiet fields and distant hills carry soft echoes of rain wind "
    "moves through tall grass near the old stone bridge where children once "
    "played simple games under summer skies boats drift along the slow river "
    "past small houses with red roofs and open windows people walk to the "
    "market carrying baskets of fruit bread and flowers evening comes early "
    "in winter when lamps glow warm against the cold blue dusk travelers "
    "rest by the fire telling long stories about far mountains deep forests "
    "and bright cities they have seen on their many roads"
).split()


def make_filler_sentences(rng: random.Random, n_sentences: int) -> str:
    """Word-salad prose: sentences of 6-12 words, each ending '. '."""
    out = []
    for _ in range(n_sentences):
        n = rng.randint(6, 12)
        words = [rng.choice(_WORDS) for _ in range(n)]
        words[0] = words[0].capitalize()
        out.append(" ".join(words) + ". ")
    return "".join(out)


def exact_token_text(enc, n_tokens, rng, attempts=40):
    """Text that re-encodes to exactly n_tokens tokens.

    Units are whole space-prefixed sentences and short space-prefixed
    words, whose token counts add up under byte-level pre-tokenization
    (merges never cross a word boundary); the total is checked by encoding
    the whole text once, and the attempt retried with fresh sentences if it
    drifts.
    """
    if n_tokens <= 0:
        return ""
    probes = [" and", " the", " sun", " over", " a", "."]
    probe_len = {p: len(enc.encode(p, add_special_tokens=False)) for p in probes}
    assert any(n == 1 for n in probe_len.values()), probe_len
    for _ in range(attempts):
        parts, count = [], 0
        while True:
            s = " " + make_filler_sentences(rng, rng.randint(2, 6)).strip()
            n = len(enc.encode(s, add_special_tokens=False))
            if count + n > n_tokens:
                break
            parts.append(s)
            count += n
        while count < n_tokens:
            for p in probes:
                if count + probe_len[p] <= n_tokens:
                    parts.append(p)
                    count += probe_len[p]
                    break
        text = "".join(parts)
        if len(enc.encode(text, add_special_tokens=False)) == n_tokens:
            return text
    raise ValueError(f"could not build exact {n_tokens}-token text")


def period_token_ids(enc):
    """The ids that end a sentence: '.' alone and after a word."""
    return set(enc.encode(".", add_special_tokens=False)
               + enc.encode("text.", add_special_tokens=False)[-1:])


def insert_needle_tokens(enc, filler_tokens, needle: str, depth_percent: int,
                         period_tokens: set) -> list:
    """The needle's tokens inserted at the sentence boundary at or before
    depth_percent of the filler (`eval_needle.NeedleInserter.insert`)."""
    needle_toks = enc.encode(needle, add_special_tokens=False)
    if depth_percent >= 100:
        return filler_tokens + needle_toks
    ip = int(len(filler_tokens) * depth_percent / 100)
    while ip > 0 and filler_tokens[ip - 1] not in period_tokens:
        ip -= 1
    return filler_tokens[:ip] + needle_toks + filler_tokens[ip:]


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m lwm_tpu_torch.apps.create_needle_train_data")
    p.add_argument("--tokenizer", type=str, required=True)
    p.add_argument("--seq_length", type=int, default=2048)
    p.add_argument("--n_train", type=int, default=2000)
    p.add_argument("--min_context_tokens", type=int, default=256)
    p.add_argument("--max_context_tokens", type=int, default=0,
                   help="0 = as much as fits in seq_length")
    p.add_argument("--rnd_number_digits", type=int, default=7)
    p.add_argument("--answer_format", type=str, default="needle_sentence",
                   choices=["number", "needle_sentence"],
                   help="needle_sentence supervises the whole needle line; number its digits")
    p.add_argument("--filler_mode", type=str, default="stream",
                   choices=["stream", "fresh", "pool"],
                   help="'stream' slices one shared filler stream; 'fresh' draws new filler "
                        "an example; 'pool' shuffles sentences from a pre-tokenized pool")
    p.add_argument("--n_distractors", type=int, default=0,
                   help="extra needles with other cities and numbers in the same context")
    p.add_argument("--qa_all_needles", action="store_true",
                   help="a QA round for every inserted needle, not only the first")
    p.add_argument("--multi_retrieve_frac", type=float, default=0.0,
                   help="fraction of examples that ask one multi-city question answered "
                        "with every needle line (eval_needle_multi's format)")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--train_output", type=str, default="")
    p.add_argument("--haystack_output", type=str, default="")
    p.add_argument("--haystack_sentences", type=int, default=20000)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    rng = random.Random(args.seed)
    enc = Tokenizer(args.tokenizer)
    period_tokens = period_token_ids(enc)

    if args.haystack_output:
        os.makedirs(os.path.dirname(args.haystack_output) or ".", exist_ok=True)
        with open(args.haystack_output, "w") as f:
            for _ in range(args.haystack_sentences // 20):
                f.write(json.dumps({"text": make_filler_sentences(rng, 20)}) + "\n")
        print(f"wrote haystack corpus to {args.haystack_output}")

    if not args.train_output:
        return

    # one long filler token stream, sliced an example
    filler_text = make_filler_sentences(rng, 6000)
    filler_tokens = enc.encode(filler_text, add_special_tokens=False)

    sentence_pool = []
    if args.filler_mode == "pool":
        sentence_pool = [
            enc.encode(make_filler_sentences(rng, 1), add_special_tokens=False)
            for _ in range(4000)
        ]

    def draw_filler(n_tokens):
        """Filler tokens: a slice of the shared stream, or freshly drawn."""
        if args.filler_mode == "fresh":
            toks = []
            while len(toks) < n_tokens:
                toks.extend(enc.encode(make_filler_sentences(rng, 8), add_special_tokens=False))
            return toks[:n_tokens]
        if args.filler_mode == "pool":
            toks = []
            while len(toks) < n_tokens:
                toks.extend(rng.choice(sentence_pool))
            return toks[:n_tokens]
        off = rng.randint(0, len(filler_tokens) - n_tokens - 1)
        return filler_tokens[off: off + n_tokens]

    def qa_answer(c, num):
        if args.answer_format == "needle_sentence":
            return f"The special magic {c} number is: {num}"
        return num

    os.makedirs(os.path.dirname(args.train_output) or ".", exist_ok=True)
    n_written = 0
    with open(args.train_output, "w") as f:
        while n_written < args.n_train:
            cities = rng.sample(RANDOM_NEEDLE_CITIES, 1 + args.n_distractors)
            numbers = [
                str(rng.randint(10 ** (args.rnd_number_digits - 1),
                                10 ** args.rnd_number_digits - 1))
                for _ in cities
            ]
            city, number = cities[0], numbers[0]
            question = RETRIEVAL_QUESTION.format(city)

            multi = len(cities) > 1 and rng.random() < args.multi_retrieve_frac
            if multi:
                # eval_needle_multi's question form, every needle answered
                joined = ", ".join(cities[:-1]) + ", and " + cities[-1]
                question = f"What are the special magic numbers for {joined}?"
                answer = " ".join(qa_answer(c, n) for c, n in zip(cities, numbers))
            else:
                answer = qa_answer(city, number)
            if args.qa_all_needles and not multi:
                # a QA round for each other needle, in the eval prompt's
                # USER/ASSISTANT scaffold
                for c, num in zip(cities[1:], numbers[1:]):
                    answer += (
                        f" USER: {RETRIEVAL_QUESTION.format(c)} Don't give "
                        f"information outside the document or repeat your "
                        f"findings. Keep your response short and direct. "
                        f"ASSISTANT: {qa_answer(c, num)}"
                    )

            # the context's budget leaves room for the prompt's scaffold, the
            # answer, bos and eos; the postpad takes the rest
            max_ctx = args.seq_length - 128
            if args.max_context_tokens:
                max_ctx = min(max_ctx, args.max_context_tokens)
            ctx_len = rng.randint(args.min_context_tokens, max_ctx)

            ctx_toks = draw_filler(ctx_len)
            for c, num in zip(cities, numbers):   # the asked needle, then the distractors
                needle = NEEDLE_TEMPLATE.format(city=c, rnd_number=num)
                ctx_toks = insert_needle_tokens(enc, ctx_toks, needle, rng.randint(0, 100),
                                                period_tokens)
            context = enc.decode(ctx_toks)
            prompt = PROMPT_TEMPLATE.format(context=context, question=question)

            # bos + enc(prompt) + enc(answer) + enc(postpad) + eos
            used = (1 + len(enc.encode(prompt, add_special_tokens=False))
                    + len(enc.encode(answer, add_special_tokens=False)) + 1)
            pad_needed = args.seq_length - used
            if pad_needed < 0:   # the context drew too long for this prompt
                continue
            postpad = exact_token_text(enc, pad_needed, rng)
            total = used + len(enc.encode(postpad, add_special_tokens=False))
            if total != args.seq_length:
                continue

            f.write(json.dumps({"question": prompt, "answer": answer, "postpad": postpad})
                    + "\n")
            n_written += 1
    print(f"wrote {n_written} exact-{args.seq_length}-token examples to {args.train_output}")


if __name__ == "__main__":
    main()
