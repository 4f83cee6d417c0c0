"""Needle-in-a-haystack long-context eval on the port.

Counterpart of `lwm_tpu/apps/eval_needle.py`, with the same flags (parsed by
`utils/flags.py`; `--llama.<field>=value` for the config fields) plus
`--device` (the card by default; `--device=cpu` for the CPU). Haystacks come
from a JSONL text corpus (`--haystack_file`, a `text` field a line); a
"special magic number" needle goes in at a grid of (context length × depth ×
round), at the sentence boundary nearest the depth, counted in the model's
own tokens (`NeedleInserter`); prompts are batched to
`--max_tokens_per_batch`, greedy-decoded by `apps.sampler.TextSampler`,
scored by substring and written to `--output_file` as JSON after every
batch. A rerun over that file skips every (context length, depth, round)
it holds. Seeding (`utils.rng.set_random_seed`) seeds Python's `random` and
numpy as the JAX CLI does (`lwm_tpu/utils/rng.py:59-62`), so one seed draws
the same cities and numbers in both packages.

The port keeps its own copies of the JAX module's prompt template, city
list, `NeedleInserter` and tester (it imports nothing of the JAX package).
Progress is printed (no tqdm). On a mesh (`--mesh_dim` of more than one
device, a process a device under `torchrun`, or `--jax_distributed.*`) every
rank builds the same grid and runs the sampler over its share of each batch
(`apps.sampler`); only rank 0 writes the results.

Run: python -m lwm_tpu_torch.apps.eval_needle --haystack_file=haystack.jsonl \\
    --load_llama_config=7b --load_checkpoint=params::PATH --tokenizer=LOCAL_DIR
(`scripts/run_eval_needle_torch.sh` is the bundle.)
"""

from __future__ import annotations

import json
import math
import random
import sys
import time

import numpy as np

from lwm_tpu_torch.apps.sampler import TextSampler
from lwm_tpu_torch.checkpoint import StreamingCheckpointer
from lwm_tpu_torch.utils.flags import parse_flags, placeholder
from lwm_tpu_torch.utils.io import check_exists, open_file
from lwm_tpu_torch.utils.rng import set_random_seed

DEFAULTS = dict(
    haystack_file="",
    max_tokens_per_batch=2000000,
    output_file="results.json",
    context_lengths_min=1000,
    context_lengths_max=32000,
    n_context_length_intervals=3,
    n_document_depth_intervals=3,
    n_rounds=2,
    seed=1234,
    mesh_dim="1,-1,1,1",
    dtype="fp32",
    load_llama_config="",
    update_llama_config="",
    load_checkpoint="",
    unscan_for_serving=False,
    tokenizer="LargeWorldModel/LWM-Text-1M",
    checkpointer=StreamingCheckpointer.get_default_config(),
    jax_distributed=dict(initialize_jax_distributed=False, coordinator_address=placeholder(str),
                         num_processes=placeholder(int), process_id=placeholder(int),
                         local_device_ids=placeholder(str)),
    device="cuda",
)

PROMPT_TEMPLATE = (
    "You are a helpful assistant. USER: {context} {question} Don't give "
    "information outside the document or repeat your findings. Keep your "
    "response short and direct. ASSISTANT: "
)

RANDOM_NEEDLE_CITIES = [
    "Chicago", "Yangon", "Antananarivo", "Colombo", "Almaty", "Sydney",
    "Mexico City", "Seattle", "Lagos", "Amsterdam", "Belgrade", "Cairo",
    "Baghdad", "Damascus", "Kigali", "Dakar", "Sofia", "Victoria",
    "Tashkent", "Mumbai", "Barcelona", "Amman", "Toronto", "Bratislava",
    "Johannesburg", "Thimphu", "Bangkok", "Santiago", "San Francisco",
    "Paris", "Rabat", "Copenhagen", "Madrid", "Ho Chi Minh City",
    "Sarajevo", "Delhi", "Istanbul", "Khartoum", "Helsinki", "Doha",
    "Kuala Lumpur", "Budapest", "Shanghai", "Moscow", "Los Angeles",
    "Oslo", "Berlin", "Bangalore", "Tokyo", "Melbourne", "Port Louis",
    "Lisbon", "Nairobi", "Kampala", "Lima", "Maputo", "Vancouver",
    "Dubai", "Jakarta", "Yerevan", "Beirut", "Athens", "Bucharest",
    "Brussels", "Tunis", "Astana", "Seoul", "Buenos Aires", "Vienna",
]


def parse_eval_flags(defaults, argv, prog):
    """The flags as a namespace; `llama` holds the `--llama.<field>` values.
    `--jax_distributed.*` joins a multi-process run (`apps.sampler`)."""
    return parse_flags(defaults, argv, prog=prog, free=("llama",))


def log(msg):
    print(msg, flush=True)


class NeedleInserter:
    """Token-level needle insertion at a sentence boundary nearest depth%
    (`lwm_tpu/apps/eval_needle.py:NeedleInserter`)."""

    def __init__(self, tokenizer, final_context_length_buffer=200):
        self.enc = tokenizer
        self.buffer = final_context_length_buffer
        self.period_tokens = set(
            tokenizer.encode(".", add_special_tokens=False)
            + tokenizer.encode("text.", add_special_tokens=False)[-1:]
        )

    def insert(self, needle, context, depth_percent, context_length):
        tokens_needle = self.enc.encode(needle, add_special_tokens=False)
        tokens_context = self.enc.encode(context, add_special_tokens=False)
        context_length -= self.buffer
        if len(tokens_context) + len(tokens_needle) > context_length:
            tokens_context = tokens_context[: context_length - len(tokens_needle)]
        if depth_percent == 100:
            tokens_new = tokens_context + tokens_needle
        else:
            insertion_point = int(len(tokens_context) * (depth_percent / 100))
            tokens_new = tokens_context[:insertion_point]
            while tokens_new and tokens_new[-1] not in self.period_tokens:
                insertion_point -= 1
                tokens_new = tokens_context[:insertion_point]
            tokens_new = tokens_new + tokens_needle + tokens_context[insertion_point:]
        return self.enc.decode(tokens_new)


def run_batches(flags, sampler, contexts, max_input_length, record):
    """`contexts` in batches of the token budget, rounded to the data dims,
    the first padded with copies of contexts[0] to a whole batch
    (`lwm_tpu/apps/eval_needle.py:239-285`). Yields, after each batch, the
    rows `record(context, response)` makes of its answered contexts."""
    data_dim = sampler.data_dim
    B = flags.max_tokens_per_batch / (max_input_length + sampler.block_size)
    B = int(B / data_dim) * data_dim
    if B < data_dim:
        B = data_dim
    elif B > len(contexts):
        B = int(math.ceil(len(contexts) / data_dim) * data_dim)
    n_pad = 0 if len(contexts) % B == 0 else B - len(contexts) % B
    for _ in range(n_pad):
        contexts.insert(0, contexts[0])
    for i in range(0, len(contexts), B):
        contexts_i = contexts[i: i + B]
        prompts = [PROMPT_TEMPLATE.format(context=c["context"], question=c["question"])
                   for c in contexts_i]
        t0 = time.perf_counter()
        outs = sampler(prompts, max_input_length)
        rows = [record(c, out) for j, (c, out) in enumerate(zip(contexts_i, outs))
                if i + j >= n_pad]
        log(f"batch of {len(contexts_i)} prompts at max_input_length {max_input_length}: "
            f"{time.perf_counter() - t0:.1f}s ({min(i + B, len(contexts))}/{len(contexts)})")
        yield rows


class LLMNeedleHaystackTester:
    """`lwm_tpu/apps/eval_needle.py:LLMNeedleHaystackTester`, its flags
    passed in (`flags`: output_file, n_rounds, max_tokens_per_batch and,
    when no `sampler` is given, the model's flags)."""

    def __init__(
        self,
        flags,
        haystack_file="",
        retrieval_question="What is the special magic {} number?",
        rnd_number_digits=7,
        context_lengths_min=1000,
        context_lengths_max=126000,
        context_lengths_num_intervals=10,
        document_depth_percent_min=0,
        document_depth_percent_max=100,
        document_depth_percent_intervals=10,
        sampler=None,
    ):
        assert haystack_file, "haystack_file required"
        self.flags = flags
        self.needle_template = "\nThe special magic {city} number is: {rnd_number}\n"
        self.retrieval_question = retrieval_question
        self.rnd_number_digits = rnd_number_digits
        self.haystack_file = haystack_file
        self.context_lengths = np.round(
            np.linspace(context_lengths_min, context_lengths_max,
                        num=context_lengths_num_intervals, endpoint=True)
        ).astype(int)
        self.document_depth_percents = np.round(
            np.linspace(document_depth_percent_min, document_depth_percent_max,
                        num=document_depth_percent_intervals, endpoint=True)
        ).astype(int)
        # "USER:" stops the rollout at the next dialogue turn
        self.model = sampler if sampler is not None else TextSampler(
            flags, greedy=True, stop_strings=("USER:", "\nUSER"))
        self.enc = self.model.tokenizer
        self.inserter = NeedleInserter(self.enc)

    def generate_random_number(self, num_digits):
        return random.randint(10 ** (num_digits - 1), 10**num_digits - 1)

    def read_context_files(self, n):
        max_context_length = max(self.context_lengths)
        contexts = []
        with open_file(self.haystack_file, "r") as f:
            for _ in range(n):
                context, toks = "", 0
                while toks < max_context_length:
                    line = f.readline()
                    if not line:
                        f.seek(0)
                        line = f.readline()
                    text = json.loads(line)["text"]
                    context += text
                    toks += len(self.enc.encode(text, add_special_tokens=False))
                contexts.append(context)
        return contexts

    def create_context_entry(self, needle_rnd_number, random_city, trim_context,
                             context_length, depth_percent, seed):
        needle = self.needle_template.format(city=random_city, rnd_number=needle_rnd_number)
        question = self.retrieval_question.format(random_city)
        context = self.inserter.insert(needle, trim_context, depth_percent, context_length)
        return {
            "context": context,
            "context_length": int(context_length),
            "depth_percent": float(depth_percent),
            "needle": needle,
            "question": question,
            "needle_rnd_number": needle_rnd_number,
            "seed": seed,
        }

    def compute_max_input_length(self, context_length, buffer=1024):
        block_size = self.model.block_size
        return int(math.ceil((context_length + buffer) / block_size) * block_size)

    def load_results(self, key):
        """(results so far, their keys) from the output file, if it exists."""
        results = []
        if check_exists(self.flags.output_file):
            with open_file(self.flags.output_file, "r") as f:
                results = json.load(f)
        completed = {key(r) for r in results}
        log(f"completed {len(completed)}")
        return results, completed

    def tokenized_haystacks(self):
        log(f"tokenizing {self.flags.n_rounds} haystacks")
        return [self.enc.encode(c, add_special_tokens=False)
                for c in self.read_context_files(self.flags.n_rounds)]

    def save(self, results):
        if getattr(self.model, "is_rank0", True):   # on a mesh, rank 0 writes
            with open_file(self.flags.output_file, "w") as f:
                json.dump(results, f)

    def run_test(self):
        flags = self.flags
        results, completed = self.load_results(
            lambda r: (r["context_length"], r["depth_percent"], r["seed"]))
        full_tokens = self.tokenized_haystacks()

        start = time.time()
        for context_length in self.context_lengths:
            trim_contexts = [self.enc.decode(toks[:context_length]) for toks in full_tokens]
            max_input_length = self.compute_max_input_length(context_length)
            contexts = []
            for depth_percent in self.document_depth_percents:
                for i in range(flags.n_rounds):
                    if (int(context_length), float(depth_percent), i) in completed:
                        continue
                    random_city = random.choice(RANDOM_NEEDLE_CITIES)
                    needle_rnd_number = str(self.generate_random_number(self.rnd_number_digits))
                    contexts.append(self.create_context_entry(
                        needle_rnd_number, random_city, trim_contexts[i], context_length,
                        depth_percent, i))
            if not contexts:
                continue

            def record(context, out):
                row = {
                    "context_length": context["context_length"],
                    "depth_percent": context["depth_percent"],
                    "response": out,
                    "answer": context["needle_rnd_number"],
                    "correct": context["needle_rnd_number"] in out,
                    "seed": context["seed"],
                }
                log(row)
                return row

            for rows in run_batches(flags, self.model, contexts, max_input_length, record):
                results.extend(rows)
                self.save(results)
        log(f"elapsed {time.time() - start}")
        log("done")

    def start_test(self):
        log("\nStarting Needle In A Haystack Testing...")
        log(f"- Context Lengths: {len(self.context_lengths)}, "
            f"Min: {min(self.context_lengths)}, Max: {max(self.context_lengths)}")
        log(f"- Document Depths: {len(self.document_depth_percents)}, "
            f"Min: {min(self.document_depth_percents)}%, "
            f"Max: {max(self.document_depth_percents)}%\n")
        self.run_test()


def main(argv=None):
    flags = parse_eval_flags(DEFAULTS, sys.argv[1:] if argv is None else argv,
                             "python -m lwm_tpu_torch.apps.eval_needle")
    set_random_seed(flags.seed)
    tester = LLMNeedleHaystackTester(
        flags,
        haystack_file=flags.haystack_file,
        context_lengths_min=flags.context_lengths_min,
        context_lengths_max=flags.context_lengths_max,
        context_lengths_num_intervals=flags.n_context_length_intervals,
        document_depth_percent_intervals=flags.n_document_depth_intervals,
    )
    tester.start_test()


if __name__ == "__main__":
    main()
