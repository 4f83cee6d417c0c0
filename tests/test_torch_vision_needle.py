"""The port's vision-needle and vision-pattern apps against the JAX
package's on the CPU.

- `create_vision_train_data` and `create_vision_needle_data`: the JSONL is
  the JAX generators' byte for byte at three flag sets each, and the
  printed line is theirs.
- `summarize_vision_needle`: the JAX summary's printed grid, character for
  character.
- `eval_vision_needle` on a tiny random VideoLLaMA saved by the port
  (`--n_frames 2,3 --depths 0,100 --rounds 1`, 16 codes a frame): the
  results JSON equals the JAX app's key for key, the printed lines are its
  lines, the first point's prompt is its prompt and that prompt's prefill
  logits sit within 1e-5 of the largest of the JAX model's; a rerun over
  the results skips every key it holds.
- `probe_vision_patterns` at `--n_patterns 2` over the same kind of model:
  its printed lines are the JAX probe's (top-k 1 draws are forced).
- The three bash bundles make the JAX bundles' calls, in their order and
  with their flags, on the port's modules (the probe without the JAX
  bundle's `--platform cpu`), and the port's parsers take every one.

The JAX side runs in one subprocess (its eval and probe import transformers
and set JAX's platform; one process pays the imports once).
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

from lwm_tpu_torch import checkpoint, generation
from lwm_tpu_torch.apps import (
    create_vision_needle_data,
    create_vision_train_data,
    eval_vision_needle,
    probe_vision_patterns,
    summarize_vision_needle,
)
from lwm_tpu_torch.models.vision_llama import VideoLLaMAConfig, VideoLLaMAForCausalLM
from lwm_tpu_torch.utils.convert import flax_params_tree
from lwm_tpu_torch.utils.tokenizer import Tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENIZER = os.path.join(REPO, "tests", "fixtures", "tokenizer")   # 457 tokens
TINY = dict(vocab_size=512, vision_vocab_size=8448, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, max_sequence_length=1024,
            scan_attention=True, scan_mlp=False, scan_layers=True, param_scan_axis=0,
            initializer_range=0.2)
UPDATE = "dict(" + ",".join(f"{k}={v!r}" for k, v in TINY.items()) + ")"
TRAIN_CASES = {
    "defaults": ["--n_train", "40"],
    "few_classes": ["--n_train", "25", "--n_patterns", "3", "--seed", "9"],
    "small_frames": ["--n_train", "30", "--n_patterns", "20", "--n_codes", "100",
                     "--n_per_frame", "17", "--seed", "2"],
}
NEEDLE_CASES = {
    "short": ["--n_train", "6"],
    "long": ["--n_train", "3", "--min_frames", "20", "--max_frames", "40", "--seed", "13"],
    "small_frames": ["--n_train", "10", "--n_patterns", "5", "--n_codes", "64",
                     "--n_per_frame", "8", "--min_frames", "2", "--max_frames", "5",
                     "--seed", "3"],
}
EVAL_ARGS = ["--n_frames", "2,3", "--depths", "0,100", "--rounds", "1", "--n_per_frame", "16",
             "--seed", "7"]
SUMMARY = {f"frames{f}_depth{d}_round{r}": dict(
    n_frames=f, vision_tokens=f * 257, depth_pct=d, round=r, target="one", answer="one",
    correct=bool((f + d + r) % 3)) for f in (32, 64, 128) for d in (0, 25, 50, 75, 100)
    for r in range(2)}

JAX_RUNS = r'''
import contextlib, io, json, sys
import numpy as np
import jax
import jax.numpy as jnp
jobs, cache_dir, update_cfg, params_path = (json.loads(sys.argv[1]), sys.argv[2],
                                            json.loads(sys.argv[3]), json.loads(sys.argv[4]))
real_update = jax.config.update
def update(name, value):   # the eval's compile cache goes to the test's directory
    if name == "jax_compilation_cache_dir":
        value = cache_dir
    return real_update(name, value)
jax.config.update = update
real_jit = jax.jit
lowered = []
class Recorded:   # the eval's AOT compile of each prompt length, its inputs recorded
    def __init__(self, fn):
        self.jitted = real_jit(fn)
    def lower(self, *args):
        lowered.append([np.asarray(a) for a in args[1:]])
        return self.jitted.lower(*args)
jax.jit = lambda fn, *a, **kw: (Recorded(fn) if getattr(fn, "__name__", "") == "_gen"
                                else real_jit(fn, *a, **kw))
from lwm_tpu.apps import create_vision_needle_data, create_vision_train_data
from lwm_tpu.apps import eval_vision_needle, probe_vision_patterns, summarize_vision_needle
mains = dict(train=create_vision_train_data, needle=create_vision_needle_data,
             summary=summarize_vision_needle, eval=eval_vision_needle,
             probe=probe_vision_patterns)
outputs = []
for kind, argv in jobs:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        sys.argv = ["prog"] + argv
        mains[kind].main()
    outputs.append(buf.getvalue())
# the eval's first prompt through the JAX model's prefill: its last logits
from lwm_tpu.checkpoint import StreamingCheckpointer
from lwm_tpu.models.vision_llama import FlaxVideoLLaMAForCausalLM, VideoLLaMAConfig
ids, vm, am = lowered[0]
cfg = VideoLLaMAConfig(mesh_dim=None, sample_mode="text")
cfg.update(dict(eval(update_cfg)))
cfg.update(dict(mesh_dim=None, sample_mode="text", scan_attention=False, remat_block="none"))
params = StreamingCheckpointer.load_checkpoint(params_path)
model = FlaxVideoLLaMAForCausalLM(cfg, input_shape=(1, 8), seed=0, _do_init=False,
                                  dtype=jnp.float32)
kw = model.prepare_inputs_for_generation(jnp.asarray(ids), ids.shape[1] + 10, jnp.asarray(am),
                                         jnp.asarray(vm))
logits = model(jnp.asarray(ids), params=params, **kw).logits[:, -1]
print(json.dumps(dict(outputs=outputs, prompt=[x.tolist() for x in lowered[0]],
                      logits=np.asarray(logits, np.float64).tolist())))
'''


def train_argv(case, out, side):
    return [*TRAIN_CASES[case], "--output", str(out / f"{side}_train_{case}.jsonl")]


def needle_argv(case, out, side):
    return [*NEEDLE_CASES[case], "--output", str(out / f"{side}_needle_{case}.jsonl")]


def eval_argv(out, side):
    return ["--checkpoint", str(out / "params"), "--tokenizer", TOKENIZER,
            "--update_llama_config", UPDATE, *EVAL_ARGS, "--platform", "cpu",
            "--output", str(out / f"{side}_results.json")]


def probe_argv(out):
    return ["--checkpoint", str(out / "params"), "--tokenizer", TOKENIZER,
            "--update_llama_config", UPDATE, "--n_patterns", "2", "--platform", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one CPU thread: its decode steps are small ops,
    which torch's intra-op pool slows when the test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """(the directory, the JAX side's printed output by job, its first eval
    prompt and that prompt's last logits): every JAX run in one
    subprocess, over one tiny VideoLLaMA params stream the port writes."""
    out = tmp_path_factory.mktemp("vision_needle")
    cfg = VideoLLaMAConfig.from_dict(TINY)
    model = VideoLLaMAForCausalLM(cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(4))
    checkpoint.save_tree(flax_params_tree(model.state_dict(), cfg), str(out / "params"))
    (out / "summary.json").write_text(json.dumps(SUMMARY))
    jobs = ([("train", train_argv(c, out, "jax")) for c in TRAIN_CASES]
            + [("needle", needle_argv(c, out, "jax")) for c in NEEDLE_CASES]
            + [("summary", [str(out / "summary.json")]), ("eval", eval_argv(out, "jax")),
               ("probe", probe_argv(out))])
    proc = subprocess.run(
        [sys.executable, "-c", JAX_RUNS, json.dumps(jobs), str(out / "jax_cache"),
         json.dumps(UPDATE), json.dumps(str(out / "params"))], cwd=REPO, capture_output=True,
        text=True, timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    names = ([f"train_{c}" for c in TRAIN_CASES] + [f"needle_{c}" for c in NEEDLE_CASES]
             + ["summary", "eval", "probe"])
    return out, dict(zip(names, got["outputs"])), got["prompt"], got["logits"]


def run_port(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_vision_train_data_matches_jax_byte_for_byte(jax_side, case):
    out, jax_out, *_ = jax_side
    printed = run_port(create_vision_train_data.main, train_argv(case, out, "port"))
    assert printed == jax_out[f"train_{case}"].replace(str(out / "jax_"), str(out / "port_"))
    want = (out / f"jax_train_{case}.jsonl").read_bytes()
    assert (out / f"port_train_{case}.jsonl").read_bytes() == want
    lines = [json.loads(x) for x in want.splitlines()]
    assert len(lines) == int(TRAIN_CASES[case][1])
    assert all(x["fields"] == "[text],vision" and x["text"].startswith("draw pattern ")
               for x in lines)


@pytest.mark.parametrize("case", list(NEEDLE_CASES))
def test_vision_needle_data_matches_jax_byte_for_byte(jax_side, case):
    out, jax_out, *_ = jax_side
    printed = run_port(create_vision_needle_data.main, needle_argv(case, out, "port"))
    assert printed == jax_out[f"needle_{case}"].replace(str(out / "jax_"), str(out / "port_"))
    want = (out / f"jax_needle_{case}.jsonl").read_bytes()
    assert (out / f"port_needle_{case}.jsonl").read_bytes() == want
    lines = [json.loads(x) for x in want.splitlines()]
    assert len(lines) == int(NEEDLE_CASES[case][1])
    assert all(x["question"] == create_vision_needle_data.QUESTION for x in lines)


def test_summary_matches_jax(jax_side):
    out, jax_out, *_ = jax_side
    printed = run_port(summarize_vision_needle.main, [str(out / "summary.json")])
    assert printed == jax_out["summary"]
    assert printed.splitlines()[0].startswith("frames(vis-toks)") and "total: " in printed


def test_eval_results_and_lines_match_jax(jax_side):
    out, jax_out, *_ = jax_side
    printed = run_port(eval_vision_needle.main, eval_argv(out, "port"))
    assert printed == jax_out["eval"]
    want = json.loads((out / "jax_results.json").read_text())
    got = json.loads((out / "port_results.json").read_text())
    assert list(got) == list(want) and got == want
    assert sorted(got) == sorted(f"frames{f}_depth{d}_round0" for f in (2, 3) for d in (0, 100))
    assert all(r["vision_tokens"] == r["n_frames"] * 17 for r in got.values())


def test_eval_prompt_and_prefill_logits_match_jax(jax_side):
    out, _, prompt, logits = jax_side
    args = eval_vision_needle.parse_args(eval_argv(out, "port"))
    proc = eval_vision_needle.processor(Tokenizer(TOKENIZER), args.n_per_frame)
    key, cls, ids, vm, am = eval_vision_needle.point(args, proc, 2, 0, 0)
    for got, want in zip((ids, vm, am), prompt):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert key == "frames2_depth0_round0" and ids.shape == (1, 256) and vm.sum() == 2 * 17
    model = eval_vision_needle.load_vision_model(args, torch.device("cpu"),
                                                 eval_vision_needle.FORCED)
    assert model.config.sample_mode == "text" and model.config.remat_block == "none"
    got, _ = generation.prefill(model, torch.as_tensor(ids), torch.as_tensor(am),
                                args.max_new_tokens, torch.as_tensor(vm))
    want = torch.tensor(logits, dtype=torch.float32)
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


def test_eval_rerun_skips_the_done_keys(jax_side, tmp_path, monkeypatch):
    out, *_ = jax_side
    path = tmp_path / "results.json"
    done = json.loads((out / "jax_results.json").read_text())
    first = "frames2_depth0_round0"
    path.write_text(json.dumps({first: done[first]}))
    calls = []
    real = eval_vision_needle.generate
    monkeypatch.setattr(eval_vision_needle, "generate",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    argv = eval_argv(out, "port")[:-2] + ["--output", str(path)]
    printed = run_port(eval_vision_needle.main, argv)
    assert len(calls) == 3 and first not in printed
    assert json.loads(path.read_text()) == done
    calls.clear()
    again = run_port(eval_vision_needle.main, argv)
    assert not calls and again.splitlines() == [printed.splitlines()[-1]]


def test_probe_lines_match_jax(jax_side):
    out, jax_out, *_ = jax_side
    printed = run_port(probe_vision_patterns.main, probe_argv(out))
    assert printed == jax_out["probe"]
    lines = printed.splitlines()
    assert len(lines) == 3 and lines[0].startswith("pattern  0 (zero): ")
    assert lines[-1].startswith("code acc ")


@pytest.mark.parametrize("app", [eval_vision_needle, probe_vision_patterns])
def test_platforms(jax_side, app):
    """--platform tpu is refused; the default is the card, which raises
    without CUDA."""
    out, *_ = jax_side
    argv = (eval_argv if app is eval_vision_needle else lambda o, *_: probe_argv(o))(out, "x")
    argv = argv[:argv.index("--platform")] + argv[argv.index("--platform") + 2:]
    with pytest.raises(ValueError, match="tpu"):
        app.main(argv + ["--platform", "tpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--platform=cpu"):
            app.main(argv)


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


def bundle_calls(tmp, script, *args):
    """The python calls of `scripts/<script> args...`, each an argv."""
    fake = tmp / "bin"
    fake.mkdir(exist_ok=True)
    (fake / "python").write_text(FAKE_PYTHON)
    (fake / "python").chmod(0o755)
    calls = tmp / f"calls_{script}"
    calls.unlink(missing_ok=True)
    subprocess.run(["rm", "-rf", str(args[0])], check=True)
    path = os.path.join(REPO, "scripts", script)
    assert subprocess.run(["bash", "-n", path]).returncode == 0
    proc = subprocess.run(["bash", path, *map(str, args)], cwd=REPO, capture_output=True,
                          text=True, timeout=60,
                          env=dict(os.environ, PATH=f"{fake}:{os.environ['PATH']}",
                                   CALLS=str(calls)))
    assert proc.returncode == 0, proc.stderr
    return [rec.split("\0")[:-1] for rec in calls.read_text().split("\036")[:-1]]


def check_port_flags(argv):
    """The port's own parser takes one call's flags; returns its module."""
    from lwm_tpu_torch import train
    from lwm_tpu_torch.apps import train_vqgan

    if argv[0] == "-":   # an inline step (the mixing, the photo gathering)
        return None
    assert argv[0] == "-m", argv
    module, args = argv[1], argv[2:]
    if module == "lwm_tpu_torch.train":
        flags = train.parse_flags(train.DEFAULTS, args, prog=train.PROG)
        train.check_supported(flags)
        assert flags.device == "cuda" and flags.modality == "vision,text"
    elif module == "lwm_tpu_torch.apps.eval_vision_needle":
        assert eval_vision_needle.parse_args(args).platform == "default"
    elif module == "lwm_tpu_torch.apps.probe_vision_patterns":
        assert probe_vision_patterns.parse_args(args).platform == "default"
    elif module == "lwm_tpu_torch.apps.create_vision_needle_data":
        create_vision_needle_data.parse_args(args)
    elif module == "lwm_tpu_torch.apps.create_vision_train_data":
        create_vision_train_data.parse_args(args)
    elif module == "lwm_tpu_torch.apps.train_vqgan":
        assert train_vqgan.parse_args(args).device == "cuda"
    else:
        assert module == "lwm_tpu_torch.apps.summarize_vision_needle" and len(args) == 1, argv
    return module


def as_jax(call):
    return [a.replace("lwm_tpu_torch.", "lwm_tpu.") for a in call]


@pytest.mark.parametrize("name", ["run_vision_needle", "run_vision_validation",
                                  "run_vqgan_128px"])
def test_vision_bundles_run_the_jax_bundles_calls(tmp_path, name):
    """scripts/<name>_torch.sh passes `bash -n` and makes the JAX bundle's
    calls, in its order and with its flags, each on the port's module of the
    same name; the port's parsers take every one. The validation probe runs
    on the card (the JAX bundle's --platform cpu dropped); the VQGAN bundle
    with an image directory skips the photo gathering."""
    work = tmp_path / "work"
    want = bundle_calls(tmp_path, f"{name}.sh", work)
    got = bundle_calls(tmp_path, f"{name}_torch.sh", work)
    if name == "run_vision_validation":
        probe = want[-1]
        at = probe.index("--platform")
        want[-1] = probe[:at] + probe[at + 2:]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g[0] == "-" and name == "run_vqgan_128px":   # the same photos, found portably
            assert w[0] == "-" and g[1:] == w[1:]
        else:
            assert as_jax(g) == w
    modules = [check_port_flags(c) for c in got]
    if name == "run_vision_needle":
        assert modules.count("lwm_tpu_torch.train") == 5
        assert modules.count("lwm_tpu_torch.apps.create_vision_needle_data") == 5
        assert modules[-2:] == ["lwm_tpu_torch.apps.eval_vision_needle",
                                "lwm_tpu_torch.apps.summarize_vision_needle"]
    elif name == "run_vision_validation":
        assert modules == ["lwm_tpu_torch.apps.create_vision_train_data",
                           "lwm_tpu_torch.train", "lwm_tpu_torch.apps.probe_vision_patterns"]
    else:
        assert modules == [None, "lwm_tpu_torch.apps.train_vqgan"]
        images = tmp_path / "images"
        given = bundle_calls(tmp_path, f"{name}_torch.sh", work, images)
        assert len(given) == 1 and given[0][given[0].index("--image_dir") + 1] == str(images)
