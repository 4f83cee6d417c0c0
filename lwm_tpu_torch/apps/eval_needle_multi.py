"""Multi-needle haystack eval on the port.

Counterpart of `lwm_tpu/apps/eval_needle_multi.py`, with the same flags plus
`--device`: `n_needles_total` city/number needles go in at sampled depths,
and the model is asked for `n_needles_retrieve` of them; each needle is
scored by substring. Results are keyed by (context length, round), so a
rerun over `--output_file` skips what it holds. The tester shares
`apps/eval_needle.py`'s haystacks, insertion, batching and padding.

One difference from the JAX tester: its `kwargs.setdefault("sampler",
TextSampler(...))` (`lwm_tpu/apps/eval_needle_multi.py:63`) builds a sampler,
and so loads a model, even when a sampler is passed; the port builds one
only when none is given (ROADMAP C6). And its needles' depths stay numpy
ints, which `json.dump` refuses, so its first results write raises
TypeError; the port stores them as Python ints (ROADMAP C7).

Run: python -m lwm_tpu_torch.apps.eval_needle_multi --haystack_file=... ...
(`scripts/run_eval_needle_multi_torch.sh` is the bundle.)
"""

from __future__ import annotations

import random
import sys
import time

from lwm_tpu_torch.apps.eval_needle import (
    DEFAULTS as NEEDLE_DEFAULTS,
    RANDOM_NEEDLE_CITIES,
    LLMNeedleHaystackTester,
    log,
    parse_eval_flags,
    run_batches,
)
from lwm_tpu_torch.apps.sampler import TextSampler
from lwm_tpu_torch.utils.rng import set_random_seed

DEFAULTS = dict(NEEDLE_DEFAULTS, n_needles_total=4, n_needles_retrieve=4)


class MultiNeedleTester(LLMNeedleHaystackTester):
    """`lwm_tpu/apps/eval_needle_multi.py:MultiNeedleTester`."""

    def __init__(self, flags, **kwargs):
        if kwargs.get("sampler") is None:
            kwargs["sampler"] = TextSampler(flags, greedy=True)
        kwargs.setdefault("retrieval_question", "What are the special magic numbers for {}?")
        super().__init__(flags, **kwargs)

    def create_multi_context(self, needles_info, cities_retrieve, context, context_length,
                             seed):
        assert all(city in needles_info for city in cities_retrieve)
        for city, (rnd_number, depth_percent) in needles_info.items():
            needle = self.needle_template.format(city=city, rnd_number=rnd_number)
            context = self.inserter.insert(needle, context, depth_percent, context_length)
        if len(cities_retrieve) == 1:
            question = f"What is the special magic number for {cities_retrieve[0]}?"
        else:
            joined = ", ".join(cities_retrieve[:-1]) + ", and " + cities_retrieve[-1]
            question = self.retrieval_question.format(joined)
        return {
            "context": context,
            "context_length": int(context_length),
            "needles_info": needles_info,
            "question": question,
            "cities_to_retrieve": cities_retrieve,
            "seed": seed,
        }

    def run_test(self):
        flags = self.flags
        results, completed = self.load_results(lambda r: (r["context_length"], r["seed"]))
        full_tokens = self.tokenized_haystacks()

        start = time.time()
        for context_length in self.context_lengths:
            trim_contexts = [self.enc.decode(toks[:context_length]) for toks in full_tokens]
            max_input_length = self.compute_max_input_length(context_length)
            contexts = []
            for i in range(flags.n_rounds):
                if (int(context_length), i) in completed:
                    continue
                cities = random.sample(RANDOM_NEEDLE_CITIES, flags.n_needles_total)
                depths = random.sample(list(self.document_depth_percents), flags.n_needles_total)
                cities_retrieve = random.sample(cities, flags.n_needles_retrieve)
                # the depth as a Python int: the JAX tester keeps numpy's, which
                # json cannot write (ROADMAP C7)
                needles_info = {
                    city: (str(self.generate_random_number(self.rnd_number_digits)), int(depth))
                    for city, depth in zip(cities, depths)
                }
                contexts.append(self.create_multi_context(
                    needles_info, cities_retrieve, trim_contexts[i], context_length, i))
            if not contexts:
                continue

            def record(context, out):
                answers = [context["needles_info"][city][0]
                           for city in context["cities_to_retrieve"]]
                row = {
                    "context_length": context["context_length"],
                    "needles_info": context["needles_info"],
                    "question": context["question"],
                    "answer": answers,
                    "response": out,
                    "correct": [a in out for a in answers],
                    "seed": context["seed"],
                }
                log(f"{row['correct']} {out} {answers}")
                return row

            for rows in run_batches(flags, self.model, contexts, max_input_length, record):
                results.extend(rows)
                self.save(results)
        log(f"elapsed {time.time() - start}")
        log("done")


def main(argv=None):
    flags = parse_eval_flags(DEFAULTS, sys.argv[1:] if argv is None else argv,
                             "python -m lwm_tpu_torch.apps.eval_needle_multi")
    set_random_seed(flags.seed)
    tester = MultiNeedleTester(
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
