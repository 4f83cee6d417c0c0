"""The port's serving CLI (`python -m lwm_tpu_torch.apps.serve`, run here by
its `main` with `--device=cpu`) against the JAX server plus
`transformers.AutoTokenizer`, as `lwm_tpu/apps/serve.py` drives them, over
the released-format golden checkpoint and the `tokenizer_bpe` fixture: the
same completions in file mode (plain, and shared prefix with a saved and
reloaded index and prompt-lookup verify) and in interactive mode.

The golden model's vocabulary is 128 tokens, so the prompts are digit
strings: the fixture's `Digits` pre-tokenizer keeps every digit one token,
with an id below 128. The model's outputs (ids below 128) decode as text.
"""

import io
import json
import os

import numpy as np
import pytest
from transformers import AutoTokenizer

from lwm_tpu.checkpoint import StreamingCheckpointer
from lwm_tpu.models import FlaxLLaMAForCausalLM
from lwm_tpu.models import LLaMAConfig as JaxConfig
from lwm_tpu.serve import InflightServer as JaxServer
from lwm_tpu_torch import serve as port_serve
from lwm_tpu_torch.apps import serve as cli

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
GOLDEN = os.path.join(FIXTURES, "v1_golden_params.ckpt")
TOKENIZER = os.path.join(FIXTURES, "tokenizer_bpe")
MODEL = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
             num_attention_heads=4, max_sequence_length=64, scan_attention=False,
             scan_mlp=False, scan_layers=False, theta=50000000)
PROMPTS = ["4819203", "31415926535", "2718281828459", "16180339887498948482", "1"]
PREFIX_TEXT = "57721566490153286060651209008240243104215933593992"
FLAGS = ["--device=cpu", "--dtype=fp32", "--slots=2", "--cache_len=128",
         "--prompt_buckets=16,32", "--max_new_tokens=6", "--load_llama_config=debug",
         f"--update_llama_config=dict({', '.join(f'{k}={v!r}' for k, v in MODEL.items())})",
         f"--load_checkpoint=params::{GOLDEN}", f"--tokenizer={TOKENIZER}"]


def jax_completions(prefix_text=None, **srv_kw):
    """{prompt: completion} from the JAX server as its CLI serves them."""
    enc = AutoTokenizer.from_pretrained(TOKENIZER)
    cfg = JaxConfig.load_config("debug")
    cfg.update(dict(MODEL, bos_token_id=enc.bos_token_id, eos_token_id=enc.eos_token_id,
                    mesh_dim=None, decode_index="per_row", max_sequence_length=128))
    model = FlaxLLaMAForCausalLM(cfg, input_shape=(1, 16), seed=0, _do_init=False)
    _, params = StreamingCheckpointer.load_trainstate_checkpoint(f"params::{GOLDEN}")
    prefix_ids = None
    if prefix_text is not None:
        prefix_ids = enc.encode(prefix_text)
        if prefix_ids[0] != enc.bos_token_id:
            prefix_ids = [enc.bos_token_id] + prefix_ids
    srv = JaxServer(model, params["params"], slots=2, cache_len=128, prompt_buckets=(16, 32),
                    stop_tokens=(enc.eos_token_id,), prefix_ids=prefix_ids, **srv_kw)

    def encode(text):
        ids = enc.encode(text)
        if prefix_ids is not None:
            return [t for t in ids if t != enc.bos_token_id]
        return ids if ids and ids[0] == enc.bos_token_id else [enc.bos_token_id] + ids

    rids = {srv.submit(encode(p), 6): p for p in PROMPTS}
    return {rids[f.req_id]: enc.decode(f.tokens, skip_special_tokens=True) for f in srv.run()}


def run_file_mode(tmp_path, *extra):
    inp, out = tmp_path / "requests.jsonl", tmp_path / "completions.jsonl"
    inp.write_text("".join(json.dumps({"prompt": p}) + "\n" for p in PROMPTS))
    cli.main(FLAGS + [f"--input_file={inp}", f"--output_file={out}", *extra])
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(lines) == len(PROMPTS)
    assert all(r["stopped"] in ("eos", "length") and r["n_tokens"] >= 1 for r in lines)
    return {r["prompt"]: r["completion"] for r in lines}


def test_file_mode_matches_jax_cli(tmp_path):
    assert run_file_mode(tmp_path) == jax_completions()


def test_prefix_index_and_lookup_match_jax_cli(tmp_path, monkeypatch):
    (tmp_path / "doc.txt").write_text(PREFIX_TEXT)
    index = tmp_path / "doc.index"
    extra = [f"--prefix_file={tmp_path / 'doc.txt'}", f"--prefix_cache={index}",
             "--prefix_chunk=32", "--lookup_k=3"]
    want = jax_completions(PREFIX_TEXT, prefix_chunk=32, lookup_k=3)
    assert run_file_mode(tmp_path, *extra) == want
    assert index.exists()

    def boom(*a, **kw):
        raise AssertionError("the saved index should have been loaded")

    monkeypatch.setattr(port_serve, "build_prefix_cache", boom)
    assert run_file_mode(tmp_path, *extra) == want


def test_interactive_mode_matches_jax_cli(monkeypatch, capsys):
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(PROMPTS) + "\n\n"))
    cli.main(FLAGS)
    printed = capsys.readouterr().out.splitlines()
    want = jax_completions()
    assert printed == [want[p] for p in PROMPTS]


def test_flags_and_refusals(tmp_path):
    flags = cli.parse_flags(["--quantize_weights", "--slots=4", "--llama.hidden_size=64",
                             "--noquantize_weights"])
    assert flags.quantize_weights is False and flags.slots == 4
    assert flags.llama == {"hidden_size": 64}
    assert cli.parse_flags(["--quantize_weights=1"]).quantize_weights is True
    assert cli.parse_flags([]).tokenizer == "LargeWorldModel/LWM-Text-1M"
    with pytest.raises(SystemExit):
        cli.parse_flags(["--bogus=1"])
    with pytest.raises(NotImplementedError, match="mesh_dim"):
        cli.main(FLAGS + ["--mesh_dim=1,1,2,1"])
    no_cpu = [f for f in FLAGS if f != "--device=cpu"]
    with pytest.raises(RuntimeError, match="--device=cpu"):
        cli.main(no_cpu)
    with pytest.raises(ValueError, match="local directory"):
        cli.main(FLAGS + ["--tokenizer=LargeWorldModel/LWM-Text-1M"])
    # int8 weights on the CPU: served through the plain twins of K5
    out = run_file_mode(tmp_path, "--quantize_weights")
    assert all(isinstance(v, str) for v in out.values())
    np.testing.assert_equal(sorted(out), sorted(PROMPTS))
