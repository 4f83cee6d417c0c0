"""The port's needle-data generators, summary and probe against the JAX
package on the CPU.

- `create_needle_train_data` and `create_copy_pretrain_data`: the JSONL,
  and the haystack file, byte for byte the JAX generators' at the same
  flags and seed, on both fixture tokenizers (the char-level `tokenizer`
  and the BPE `tokenizer_bpe`), in the three filler modes, with
  distractors, `--qa_all_needles`, a nonzero `--multi_retrieve_frac` and
  both answer formats; every example exactly `--seq_length` tokens.
- `summarize_needle`: the JAX summary's printed lines, single- and
  multi-needle.
- `probe_needle_digits`: the JAX probe's line and its argmaxes at every
  position of every prompt, on a tiny model saved by the port.

The JAX side runs in one subprocess (its generators and probe are CLIs
whose imports pull in JAX and transformers; one process pays the imports
once).
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lwm_tpu_torch import checkpoint
from lwm_tpu_torch.apps import (
    create_copy_pretrain_data,
    create_needle_train_data,
    probe_needle_digits,
    summarize_needle,
)
from lwm_tpu_torch.models.llama import LLaMAConfig, LLaMAForCausalLM
from lwm_tpu_torch.utils.convert import flax_params_tree
from lwm_tpu_torch.utils.tokenizer import Tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
SMALL = ["--seq_length", "512", "--n_train", "4", "--min_context_tokens", "32",
         "--max_context_tokens", "300"]
NEEDLE_CASES = {
    "char_pool_qa_multi": ("tokenizer", ["--filler_mode", "pool", "--n_distractors", "2",
                                         "--qa_all_needles", "--multi_retrieve_frac", "0.5",
                                         "--haystack_sentences", "100"]),
    "bpe_pool_qa_multi": ("tokenizer_bpe", ["--filler_mode", "pool", "--n_distractors", "2",
                                            "--qa_all_needles", "--multi_retrieve_frac", "0.5",
                                            "--seed", "2", "--haystack_sentences", "100"]),
    "bpe_stream_number": ("tokenizer_bpe", ["--n_distractors", "1", "--answer_format", "number",
                                            "--seed", "5"]),
    "char_fresh": ("tokenizer", ["--filler_mode", "fresh", "--seed", "4"]),
}
COPY_CASES = {"char": ("tokenizer", "1024", []), "bpe": ("tokenizer_bpe", "256", ["--seed", "3"])}
PROBE_MODEL = dict(vocab_size=1024, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                   num_attention_heads=2, max_sequence_length=1024, initializer_range=0.2)
PROBE_ARGS = ["--n", "3", "--ctx_min", "100", "--ctx_max", "200", "--n_distractors", "1",
              "--seed", "11"]
SUMMARIES = {
    "single": [dict(context_length=c, depth_percent=d, correct=bool((c + d + r) % 3))
               for c in (400, 1000) for d in (0, 50, 100) for r in range(2)],
    "multi": [dict(context_length=c, correct=[True, bool((c + r) % 2)])
              for c in (400, 700, 1000) for r in range(3)],
}

JAX_RUNS = r'''
import contextlib, io, json, sys
import numpy as np
import jax.numpy as jnp
from lwm_tpu.apps import create_copy_pretrain_data, create_needle_train_data
from lwm_tpu.apps import probe_needle_digits, summarize_needle
argmaxes = []
real_argmax = jnp.argmax
def argmax(x, axis=None):
    out = real_argmax(x, axis)
    argmaxes.append(np.asarray(out).tolist())
    return out
jnp.argmax = argmax
outputs = []
for kind, argv in json.loads(sys.argv[1]):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if kind == "summary":
            summarize_needle.summarize(argv[0])
        else:
            sys.argv = ["prog"] + argv
            dict(needle=create_needle_train_data, copy=create_copy_pretrain_data,
                 probe=probe_needle_digits)[kind].main()
    outputs.append(buf.getvalue())
print(json.dumps(dict(outputs=outputs, argmaxes=argmaxes)))
'''


def needle_argv(case, out_dir, side):
    tok, extra = NEEDLE_CASES[case]
    argv = ["--tokenizer", os.path.join(FIXTURES, tok), *SMALL, *extra,
            "--train_output", str(out_dir / f"{side}_{case}.jsonl")]
    if "--haystack_sentences" in extra:
        argv += ["--haystack_output", str(out_dir / f"{side}_{case}_haystack.jsonl")]
    return argv


def copy_argv(case, out_dir, side):
    tok, seq, extra = COPY_CASES[case]
    return ["--tokenizer", os.path.join(FIXTURES, tok), "--seq_length", seq, "--n_train", "4",
            *extra, "--output", str(out_dir / f"{side}_copy_{case}.jsonl")]


def probe_argv(out_dir):
    update = "dict(" + ",".join(f"{k}={v!r}" for k, v in PROBE_MODEL.items()) + ")"
    return ["--checkpoint", str(out_dir / "probe_params"),
            "--tokenizer", os.path.join(FIXTURES, "tokenizer_bpe"),
            "--update_llama_config", update, *PROBE_ARGS]


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """(the directory, the JAX side's outputs by job): every JAX run in one
    subprocess."""
    out = tmp_path_factory.mktemp("needle_data")
    cfg = LLaMAConfig(**PROBE_MODEL)
    model = LLaMAForCausalLM(cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    checkpoint.save_tree(flax_params_tree(model.state_dict(), cfg), str(out / "probe_params"))
    for name, rows in SUMMARIES.items():
        (out / f"results_{name}.json").write_text(json.dumps(rows))
    jobs = ([("needle", needle_argv(c, out, "jax")) for c in NEEDLE_CASES]
            + [("copy", copy_argv(c, out, "jax")) for c in COPY_CASES]
            + [("summary", [str(out / f"results_{n}.json")]) for n in SUMMARIES]
            + [("probe", probe_argv(out) + ["--platform", "cpu"])])
    proc = subprocess.run([sys.executable, "-c", JAX_RUNS, json.dumps(jobs)], cwd=REPO,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    names = ([f"needle_{c}" for c in NEEDLE_CASES] + [f"copy_{c}" for c in COPY_CASES]
             + [f"summary_{n}" for n in SUMMARIES] + ["probe"])
    return out, dict(zip(names, got["outputs"])), got["argmaxes"]


def run_port(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def token_count(enc, line):
    """bos + question + answer + postpad + eos, each field encoded apart (the
    trainer's "[question],answer,[postpad]" with no separator)."""
    return 2 + sum(len(enc.encode(line[k], add_special_tokens=False))
                   for k in ("question", "answer", "postpad"))


@pytest.mark.parametrize("case", list(NEEDLE_CASES))
def test_needle_train_data_matches_jax_byte_for_byte(jax_side, case):
    out, jax_out, _ = jax_side
    printed = run_port(create_needle_train_data.main, needle_argv(case, out, "port"))
    assert printed == jax_out[f"needle_{case}"].replace(str(out / "jax_"), str(out / "port_"))
    want = (out / f"jax_{case}.jsonl").read_bytes()
    assert (out / f"port_{case}.jsonl").read_bytes() == want
    if "--haystack_sentences" in NEEDLE_CASES[case][1]:
        hay = (out / f"jax_{case}_haystack.jsonl").read_bytes()
        assert (out / f"port_{case}_haystack.jsonl").read_bytes() == hay
        assert len(hay.splitlines()) == 5
    lines = [json.loads(x) for x in want.splitlines()]
    enc = Tokenizer(os.path.join(FIXTURES, NEEDLE_CASES[case][0]))
    assert len(lines) == 4 and all(token_count(enc, x) == 512 for x in lines)


@pytest.mark.parametrize("case", list(COPY_CASES))
def test_copy_pretrain_data_matches_jax_byte_for_byte(jax_side, case):
    out, jax_out, _ = jax_side
    printed = run_port(create_copy_pretrain_data.main, copy_argv(case, out, "port"))
    assert printed == jax_out[f"copy_{case}"].replace(str(out / "jax_"), str(out / "port_"))
    want = (out / f"jax_copy_{case}.jsonl").read_bytes()
    assert (out / f"port_copy_{case}.jsonl").read_bytes() == want
    tok, seq, _ = COPY_CASES[case]
    enc = Tokenizer(os.path.join(FIXTURES, tok))
    lines = [json.loads(x) for x in want.splitlines()]
    assert all(x["question"] == x["answer"] + " REPEAT: " for x in lines)
    assert all(token_count(enc, x) == int(seq) for x in lines)


@pytest.mark.parametrize("name", list(SUMMARIES))
def test_summary_matches_jax(jax_side, name):
    out, jax_out, _ = jax_side
    printed = run_port(summarize_needle.main, [str(out / f"results_{name}.json")])
    assert printed == jax_out[f"summary_{name}"]
    assert ("multi-needle" in printed) == (name == "multi")


def test_probe_line_and_argmaxes_match_jax(jax_side):
    out, jax_out, jax_argmaxes = jax_side
    args = probe_needle_digits.parse_args(probe_argv(out) + ["--device", "cpu"])
    model = probe_needle_digits.load_model(args)
    enc = Tokenizer(args.tokenizer)
    *_, rows = probe_needle_digits.probe(model, enc, args)
    preds = [p for _, p in rows]
    assert preds == jax_argmaxes
    assert len(preds) == 3 and all(len(p) > 100 for p in preds)
    printed = run_port(probe_needle_digits.main, probe_argv(out) + ["--device", "cpu"])
    assert printed == jax_out["probe"]
    assert printed.startswith("digit acc ")


def test_probe_refuses_the_card_without_cuda(jax_side):
    out, _, _ = jax_side
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device=cpu"):
        probe_needle_digits.main(probe_argv(out))


def test_exact_token_text_counts_on_both_tokenizers():
    import random

    for tok in ("tokenizer", "tokenizer_bpe"):
        enc = Tokenizer(os.path.join(FIXTURES, tok))
        rng = random.Random(0)
        for n in (0, 1, 7, 90):
            text = create_needle_train_data.exact_token_text(enc, n, rng)
            assert len(enc.encode(text, add_special_tokens=False)) == n
        filler = enc.encode(create_needle_train_data.make_filler_sentences(rng, 5),
                            add_special_tokens=False)
        periods = create_needle_train_data.period_token_ids(enc)
        got = create_needle_train_data.insert_needle_tokens(enc, filler, "\nX\n", 50, periods)
        needle = enc.encode("\nX\n", add_special_tokens=False)
        at = next(i for i in range(len(got)) if got[i:i + len(needle)] == needle)
        assert at == 0 or got[at - 1] in periods
        assert got[:at] + got[at + len(needle):] == filler
        assert np.array_equal(create_needle_train_data.insert_needle_tokens(
            enc, filler, "\nX\n", 100, periods), filler + needle)


# A stand-in `python` for running a bundle's control flow without its work:
# it records each call's arguments (NUL-separated, one record a call) and,
# for a trainer run, makes the milestone the bundle's `ls` looks for.
FAKE_PYTHON = r'''#!/bin/bash
printf '%s\0' "$@" >> "$CALLS"; printf '\036' >> "$CALLS"
out= id= steps=
for a in "$@"; do
  case "$a" in
    --logger.output_dir=*) out=${a#*=} ;;
    --logger.experiment_id=*) id=${a#*=} ;;
    --total_steps=*) steps=${a#*=} ;;
  esac
done
if [ -n "$out" ]; then mkdir -p "$out/$id" && touch "$out/$id/streaming_params_$steps"; fi
'''


def bundle_calls(tmp, script, work, **env):
    """The python calls of `scripts/<script>` run over `work`, each an argv."""
    fake = tmp / "bin"
    fake.mkdir(exist_ok=True)
    (fake / "python").write_text(FAKE_PYTHON)
    (fake / "python").chmod(0o755)
    calls = tmp / f"calls_{script}"
    calls.unlink(missing_ok=True)
    subprocess.run(["rm", "-rf", str(work)], check=True)
    path = os.path.join(REPO, "scripts", script)
    assert subprocess.run(["bash", "-n", path]).returncode == 0
    proc = subprocess.run(["bash", path, str(work)], cwd=REPO, capture_output=True, text=True,
                          timeout=60, env=dict(os.environ, PATH=f"{fake}:{os.environ['PATH']}",
                                               CALLS=str(calls), **env))
    assert proc.returncode == 0, proc.stderr
    return [rec.split("\0")[:-1] for rec in calls.read_text().split("\036")[:-1]]


def check_port_flags(argv):
    """The port's own parser takes one call's flags."""
    from lwm_tpu_torch import train
    from lwm_tpu_torch.apps import convert_checkpoint, eval_needle

    if argv[0] == "-":   # the inline mixing step
        return None
    assert argv[0] == "-m", argv
    module, args = argv[1], argv[2:]
    if module == "lwm_tpu_torch.train":
        flags = train.parse_flags(train.DEFAULTS, args, prog=train.PROG)
        train.check_supported(flags)
        assert flags.dtype == "fp32" and flags.device == "cuda"
    elif module == "lwm_tpu_torch.apps.eval_needle":
        flags = eval_needle.parse_eval_flags(eval_needle.DEFAULTS, args, prog="bundle")
        assert flags.device == "cuda"
    elif module == "lwm_tpu_torch.apps.convert_checkpoint":
        convert_checkpoint.model_config(convert_checkpoint.parse_flags(
            convert_checkpoint.DEFAULTS, args, prog="bundle"))
    elif module == "lwm_tpu_torch.apps.create_needle_train_data":
        create_needle_train_data.parse_args(args)
    elif module == "lwm_tpu_torch.apps.create_copy_pretrain_data":
        create_copy_pretrain_data.parse_args(args)
    else:
        assert module == "lwm_tpu_torch.apps.summarize_needle" and len(args) == 1, argv
    return module


@pytest.mark.parametrize("name", ["run_needle_validation", "run_context_extension"])
def test_text_bundles_run_the_jax_bundles_calls(tmp_path, name):
    """scripts/<name>_torch.sh passes `bash -n` and makes the JAX bundle's
    calls, in its order and with its flags, each on the port's module of the
    same name; the port's parsers take every one."""
    work = tmp_path / "work"
    want = bundle_calls(tmp_path, f"{name}.sh", work)
    got = bundle_calls(tmp_path, f"{name}_torch.sh", work)
    assert [[a.replace("lwm_tpu_torch.", "lwm_tpu.") for a in c] for c in got] == want
    modules = [check_port_flags(c) for c in got]
    assert modules.count("lwm_tpu_torch.train") == (2 if name == "run_needle_validation" else 4)
    assert "lwm_tpu_torch.apps.eval_needle" in modules
    if name == "run_context_extension":
        data = bundle_calls(tmp_path, f"{name}_torch.sh", work, DATA_ONLY="1")
        assert len(data) == 7 and all("lwm_tpu_torch.train" not in c for c in data)
        assert [c[1] for c in data[:6]] == [c[1] for c in got[:6]]
