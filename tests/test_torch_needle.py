"""The port's needle evals (`lwm_tpu_torch.apps.eval_needle` and
`eval_needle_multi`) against the JAX testers, both driving a recording stub
sampler over one generated haystack and the `tokenizer_bpe` fixture, from
one seed: the same prompts, `max_input_length`s, batches (the first padded
to a whole batch) and results JSON; a rerun over the results file asks for
nothing more. Then each CLI end to end on the CPU over a tiny saved
checkpoint.

The JAX testers run in a subprocess: both JAX modules define the same absl
flags at import (and `lwm_tpu.train`, which the suite imports, some of
them), so neither can be imported beside the suite's other modules. There
the multi-needle tester is built with `eval_needle_multi.TextSampler`
patched to return the stub (its `kwargs.setdefault("sampler",
TextSampler(...))` builds one even when a sampler is passed: ROADMAP C6),
and its results are written with numpy ints as ints (its needles' depths
are numpy ints, which `json.dump` refuses: ROADMAP C7).
"""

import json
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from lwm_tpu_torch import checkpoint
from lwm_tpu_torch.apps import eval_needle, eval_needle_multi
from lwm_tpu_torch.models.llama import LLaMAConfig, LLaMAForCausalLM
from lwm_tpu_torch.utils.convert import flax_params_tree
from lwm_tpu_torch.utils.rng import set_random_seed
from lwm_tpu_torch.utils.tokenizer import Tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
TOKENIZER = os.path.join(FIXTURES, "tokenizer_bpe")
WORDS = ("the grass is green and the sky is blue here we go there and back again over "
         "hills where rivers run cold under stone bridges").split()
SEED = 7
GRID = dict(context_lengths_min=400, context_lengths_max=700, context_lengths_num_intervals=2,
            document_depth_percent_intervals=3)
# each tester's flags: a batch budget that pads the first batch of some
# context length
RUNS = {
    "single": dict(n_rounds=3, max_tokens_per_batch=7000),
    "multi": dict(n_rounds=3, max_tokens_per_batch=3500, n_needles_total=3, n_needles_retrieve=2),
}
BLOCK = 128


def write_haystack(path):
    rng = np.random.default_rng(0)
    with open(path, "w") as f:
        for _ in range(12):
            sentences = [" ".join(rng.choice(WORDS, rng.integers(5, 14))).capitalize() + "."
                         for _ in range(6)]
            f.write(json.dumps({"text": " ".join(sentences) + " "}) + "\n")


# the stub's source: run here and in the JAX testers' subprocess
STUB = '''
class Stub:
    """A sampler that records its calls and answers with the first needle
    number it finds in the prompt."""

    def __init__(self, tokenizer, block_size, calls):
        self.tokenizer, self.block_size, self.data_dim, self.calls = (
            tokenizer, block_size, 1, calls)

    def __call__(self, prompts, max_input_length):
        self.calls.append([list(prompts), max_input_length])
        out = []
        for p in prompts:
            m = re.search(r"number is: ([0-9]+)", p)
            out.append(f"It is {m.group(1)}." if m else "I do not know.")
        return out
'''
exec(STUB)


JAX_SCRIPT = r'''
import json, re, sys, types
import numpy as np
from transformers import AutoTokenizer
from lwm_tpu.utils import set_random_seed
args = json.loads(sys.argv[1])
STUB
calls = {}
tok = AutoTokenizer.from_pretrained(args["tokenizer"])


def run(module, name, tester_cls, with_flags):
    flags = module.FLAGS
    argv = ["prog", f"--haystack_file={args['haystack']}", f"--output_file={args['out'][name]}",
            f"--seed={args['seed']}"] + [f"--{k}={v}" for k, v in args["flags"][name].items()]
    flags(argv)
    calls[name] = []
    for attempt in range(2):   # the second run resumes from the results file
        set_random_seed(args["seed"])
        stub = Stub(tok, args["block"], calls[name])
        module.TextSampler = lambda *a, **k: stub
        kw = dict(haystack_file=args["haystack"], sampler=stub, **args["grid"])
        tester = tester_cls(**kw) if not with_flags else tester_cls(flags=flags, **kw)
        tester.run_test()
        calls[name].append("resumed")


from lwm_tpu.apps import eval_needle as single
run(single, "single", single.LLMNeedleHaystackTester, False)
for name in list(single.FLAGS_DEF):     # the multi module defines the same flags
    delattr(single.FLAGS, name)
from lwm_tpu.apps import eval_needle_multi as multi
real_json = multi.json
multi.json = types.SimpleNamespace(load=real_json.load,
                                   dump=lambda obj, f: real_json.dump(obj, f, default=int))
run(multi, "multi", multi.MultiNeedleTester, True)
print(json.dumps(calls))
'''.replace("STUB", STUB)


def jax_runs(tmp_path, haystack):
    args = dict(tokenizer=TOKENIZER, haystack=str(haystack), seed=SEED, block=BLOCK,
                grid=GRID, flags=RUNS,
                out={k: str(tmp_path / f"jax_{k}.json") for k in RUNS})
    proc = subprocess.run([sys.executable, "-c", JAX_SCRIPT, json.dumps(args)], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    calls = json.loads(proc.stdout.strip().splitlines()[-1])
    return calls, {k: json.loads(open(v).read()) for k, v in args["out"].items()}


def port_run(tmp_path, haystack, name):
    defaults = (eval_needle if name == "single" else eval_needle_multi).DEFAULTS
    tester_cls = (eval_needle.LLMNeedleHaystackTester if name == "single"
                  else eval_needle_multi.MultiNeedleTester)
    out = tmp_path / f"port_{name}.json"
    flags = types.SimpleNamespace(**dict(defaults, haystack_file=str(haystack),
                                         output_file=str(out), seed=SEED, **RUNS[name]))
    calls = []
    for _ in range(2):
        set_random_seed(SEED)
        stub = Stub(Tokenizer(TOKENIZER), BLOCK, calls)
        tester_cls(flags, haystack_file=str(haystack), sampler=stub, **GRID).run_test()
        calls.append("resumed")
    return calls, json.loads(out.read_text())


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("needle")
    haystack = tmp / "haystack.jsonl"
    write_haystack(haystack)
    jax_calls, jax_results = jax_runs(tmp, haystack)
    return tmp, haystack, jax_calls, jax_results


@pytest.mark.parametrize("name", sorted(RUNS))
def test_tester_matches_jax_tester(both, name):
    """The same sampler calls (prompts, max_input_length: so the same
    batches and first-batch padding) and the same results JSON; the rerun
    over the results file makes no call."""
    tmp, haystack, jax_calls, jax_results = both
    calls, results = port_run(tmp, haystack, name)
    assert calls == jax_calls[name]
    assert results == jax_results[name]
    first_run = calls[:calls.index("resumed")]
    assert calls[len(first_run):] == ["resumed", "resumed"]     # nothing left to do
    sizes = [len(prompts) for prompts, _ in first_run]
    assert len(set(sizes)) > 1 or len(first_run) > 2, sizes
    # the first batch of some context length carries copies of its first prompt
    assert any(p[0] == p[1] for p, _ in first_run), "no padded first batch"
    n_rows = {"single": 2 * 3 * 3, "multi": 2 * 3}[name]
    assert len(results) == n_rows
    assert any(r["correct"] if name == "single" else any(r["correct"]) for r in results)


# a tiny model over the fixture tokenizer's 938 tokens, its scan chunks (so
# the sampler's block_size: new tokens a prompt) 16
CLI_MODEL = dict(vocab_size=1024, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                 num_attention_heads=4, max_sequence_length=2048, scan_attention=False,
                 scan_mlp=False, scan_layers=False, scan_query_chunk_size=16,
                 scan_key_chunk_size=16)


@pytest.fixture(scope="module")
def cli_checkpoint(tmp_path_factory):
    cfg = LLaMAConfig.from_dict(CLI_MODEL)
    model = LLaMAForCausalLM(cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    path = tmp_path_factory.mktemp("needle_cli") / "params"
    checkpoint.save_tree(flax_params_tree(model.state_dict(), cfg), str(path))
    return path


@pytest.mark.parametrize("name", ["single", "multi"])
def test_cli_writes_and_resumes(both, cli_checkpoint, name, capsys):
    """Each CLI end to end on the CPU (a saved params stream, greedy
    decoding through the port's TextSampler): one results row per grid
    point, and a rerun adds none."""
    tmp, haystack, _, _ = both
    module = eval_needle if name == "single" else eval_needle_multi
    out = tmp / f"cli_{name}.json"
    update = ", ".join(f"{k}={v!r}" for k, v in CLI_MODEL.items())
    argv = ["--device=cpu", "--load_llama_config=debug", f"--update_llama_config=dict({update})",
            f"--load_checkpoint=params::{cli_checkpoint}", f"--tokenizer={TOKENIZER}", f"--haystack_file={haystack}", f"--output_file={out}",
            "--context_lengths_min=300", "--context_lengths_max=400",
            "--n_context_length_intervals=2", "--n_document_depth_intervals=2", "--n_rounds=1",
            "--max_tokens_per_batch=100000"]
    if name == "multi":
        argv += ["--n_needles_total=2", "--n_needles_retrieve=2"]
    module.main(argv)
    rows = json.loads(out.read_text())
    assert len(rows) == (4 if name == "single" else 2)
    module.main(argv)
    assert json.loads(out.read_text()) == rows
    assert f"completed {len(rows)}" in capsys.readouterr().out


def test_cli_refuses_a_mesh():
    # a mesh runs as a process a device: one process does not cover tp 4
    with pytest.raises(ValueError, match="1 devices not divisible by 4"):
        eval_needle.main(["--device=cpu", "--mesh_dim=1,-1,4,1", "--haystack_file=x"])
