"""The port's checkpoint converter (`lwm_tpu_torch.apps.convert_checkpoint`,
`utils.checkpoint_convert`, `utils.hf_dir`) against the JAX app and
transformers on the CPU.

- `unscan` and `rescan`: streams leaf-equal to the JAX app's, layers
  stacked on axis 0 (an fp32 stream) and on axis 1 (a bf16 one).
- `streaming_to_hf`: the directory the port writes (safetensors, no
  transformers) is read by `transformers.LlamaForCausalLM.from_pretrained`,
  whose logits match the port's model at 1e-5 (fp32), under MHA and GQA;
  above a shard size it is sharded with an index, as `save_pretrained`
  shards.
- `hf_to_streaming`: a directory written by `save_pretrained` (one
  safetensors file, shards with an index, or `pytorch_model.bin`) becomes a
  stream leaf-equal to the JAX app's, and the port's model of that stream
  gives transformers' logits at 1e-5. A round trip through the wrong
  rotary permutation would be the identity, so the logits are what tell.

The JAX app runs in one subprocess, its flags parsed again for each run.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from transformers import LlamaConfig as HFLlamaConfig
from transformers import LlamaForCausalLM

from lwm_tpu_torch import checkpoint
from lwm_tpu_torch.apps import convert_checkpoint as app
from lwm_tpu_torch.models.llama import LLaMAConfig, LLaMAForCausalLM
from lwm_tpu_torch.utils import hf_dir
from lwm_tpu_torch.utils.convert import convert_flax_params, flax_params_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=1e-5)
SHAPES = {
    "mha": dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                num_attention_heads=4, max_sequence_length=64),
    "gqa": dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                num_attention_heads=4, num_key_value_heads=2, max_sequence_length=64,
                theta=500000.0),
}
SHARD_BYTES = 40_000   # splits a 3-layer GQA model of these widths into shards
SCANS = {"axis0_fp32": (0, "fp32"), "axis1_bf16": (1, "bf16")}
HF_DIRS = {"mha_safetensors": ("mha", dict()),
           "gqa_sharded": ("gqa", dict(max_shard_size="60KB")),
           "mha_bin": ("mha", dict(safe_serialization=False))}

JAX_APP = r'''
import json, sys
from lwm_tpu.apps import convert_checkpoint as cc
for argv in json.loads(sys.argv[1]):
    cc.FLAGS(["prog"] + argv)
    cc.main(None)
'''


def update_flag(shape):
    return "dict(" + ",".join(f"{k}={v!r}" for k, v in SHAPES[shape].items()) + ")"


def argv(direction, shape, output, source="", axis=0, scan=True):
    return [f"--direction={direction}", "--llama_config=debug",
            f"--update_llama_config={update_flag(shape)}", f"--scan_layers={scan}",
            f"--param_scan_axis={axis}", "--float_dtype=fp32", f"--output={output}",
            f"--streaming_path={source if direction != 'hf_to_streaming' else ''}",
            f"--hf_path={source if direction == 'hf_to_streaming' else ''}"]


def port_model(shape, axis=0, seed=0):
    cfg = LLaMAConfig(**SHAPES[shape], param_scan_axis=axis)
    model = LLaMAForCausalLM(cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(seed))
    with torch.no_grad():   # norm scales off 1, so that a swapped norm shows
        for name, p in model.named_parameters():
            if "norm" in name:
                p.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(seed + 1))
    return model


def hf_model(shape, seed):
    s = SHAPES[shape]
    torch.manual_seed(seed)
    return LlamaForCausalLM(HFLlamaConfig(
        vocab_size=s["vocab_size"], hidden_size=s["hidden_size"],
        intermediate_size=s["intermediate_size"], num_hidden_layers=s["num_hidden_layers"],
        num_attention_heads=s["num_attention_heads"],
        num_key_value_heads=s.get("num_key_value_heads", s["num_attention_heads"]),
        max_position_embeddings=s["max_sequence_length"], rms_norm_eps=1e-6,
        rope_theta=float(s.get("theta", 10000)), attention_bias=False,
        tie_word_embeddings=False)).eval()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The streams and HF directories of every case, and the JAX app's
    outputs of them (one subprocess)."""
    tmp = tmp_path_factory.mktemp("convert")
    jobs = []
    for case, (axis, dtype) in SCANS.items():
        model = port_model("mha", axis)
        checkpoint.save_tree(flax_params_tree(model.state_dict(), model.config),
                             str(tmp / f"scanned_{case}"), float_dtype=dtype)
        jobs.append(argv("unscan", "mha", tmp / f"jax_unscan_{case}", tmp / f"scanned_{case}",
                         axis))
        jobs.append(argv("rescan", "mha", tmp / f"jax_rescan_{case}",
                         tmp / f"jax_unscan_{case}", axis))
    for i, (case, (shape, kw)) in enumerate(HF_DIRS.items()):
        hf_model(shape, seed=10 + i).save_pretrained(tmp / f"hf_{case}", **kw)
        jobs.append(argv("hf_to_streaming", shape, tmp / f"jax_stream_{case}", tmp / f"hf_{case}"))
    proc = subprocess.run([sys.executable, "-c", JAX_APP,
                           json.dumps([[str(a) for a in job] for job in jobs])],
                          cwd=REPO, capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return tmp


def assert_leaf_equal(path, want_path, ordered=True):
    """The two streams' leaves equal, key for key (in file order when
    `ordered`), dtype for dtype."""
    got, want = checkpoint.load_stream(str(path)), checkpoint.load_stream(str(want_path))
    assert (list(got) if ordered else sorted(got)) == (list(want) if ordered else sorted(want))
    for key in want:
        a, b = got[key], want[key]
        if isinstance(b, torch.Tensor):
            assert isinstance(a, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), key
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), key
    return want


def run(args, capsys):
    app.main([str(a) for a in args])
    return capsys.readouterr().out


@pytest.mark.parametrize("case", list(SCANS))
def test_unscan_and_rescan_match_jax(files, case, capsys):
    axis, _ = SCANS[case]
    out = run(argv("unscan", "mha", files / f"port_unscan_{case}", files / f"scanned_{case}", axis),
              capsys)
    assert out == f"wrote converted params to {files / f'port_unscan_{case}'}\n"
    flat = assert_leaf_equal(files / f"port_unscan_{case}", files / f"jax_unscan_{case}")
    assert ("transformer", "h", "2", "attention", "wq", "kernel") in flat
    assert all(v.dtype == np.float32 for v in flat.values())
    run(argv("rescan", "mha", files / f"port_rescan_{case}", files / f"port_unscan_{case}", axis),
        capsys)
    rescanned = assert_leaf_equal(files / f"port_rescan_{case}", files / f"jax_rescan_{case}")
    scanned = checkpoint.load_stream(str(files / f"scanned_{case}"))
    assert sorted(rescanned) == sorted(scanned)
    for key, value in scanned.items():   # the round trip, widened to fp32
        assert np.array_equal(rescanned[key], torch.as_tensor(value).float().numpy()), key


@pytest.mark.parametrize("shape", list(SHAPES))
def test_streaming_to_hf_reads_back_in_transformers(files, shape, capsys, monkeypatch):
    model = port_model(shape, seed=3)
    stream = files / f"port_params_{shape}"
    checkpoint.save_tree(flax_params_tree(model.state_dict(), model.config), str(stream))
    out_dir = files / f"port_hf_{shape}"
    if shape == "gqa":
        monkeypatch.setattr(hf_dir, "SHARD_BYTES", SHARD_BYTES)
    printed = run(argv("streaming_to_hf", shape, out_dir, stream), capsys)
    assert printed == f"wrote HF model to {out_dir}\n"
    sharded = (out_dir / hf_dir.SAFE_INDEX).exists()
    assert sharded == (shape == "gqa") and (out_dir / hf_dir.SAFE_NAME).exists() != sharded
    hf = LlamaForCausalLM.from_pretrained(out_dir, torch_dtype=torch.float32).eval()
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 128, (2, 40)))
    with torch.no_grad():
        want = hf(ids).logits
        got = model(ids, torch.ones_like(ids))
    torch.testing.assert_close(got, want, **TOL)
    assert want.abs().max() > 0.05
    # the port reads its own directory back into the same stream
    run(argv("hf_to_streaming", shape, files / f"port_back_{shape}", out_dir), capsys)
    assert_leaf_equal(files / f"port_back_{shape}", stream, ordered=False)


@pytest.mark.parametrize("case", list(HF_DIRS))
def test_hf_to_streaming_matches_jax_and_transformers_logits(files, case, capsys):
    shape, kw = HF_DIRS[case]
    src = files / f"hf_{case}"
    assert (src / hf_dir.SAFE_INDEX).exists() == ("max_shard_size" in kw)
    assert (src / hf_dir.BIN_NAME).exists() == ("safe_serialization" in kw)
    run(argv("hf_to_streaming", shape, files / f"port_stream_{case}", src), capsys)
    assert_leaf_equal(files / f"port_stream_{case}", files / f"jax_stream_{case}")
    hf = LlamaForCausalLM.from_pretrained(src, torch_dtype=torch.float32).eval()
    cfg = LLaMAConfig(**SHAPES[shape])
    model = LLaMAForCausalLM(cfg, device="cpu")
    model.load_state_dict(convert_flax_params(
        checkpoint.load_checkpoint(str(files / f"port_stream_{case}")), cfg))
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 128, (2, 33)))
    with torch.no_grad():
        torch.testing.assert_close(model(ids, torch.ones_like(ids)), hf(ids).logits, **TOL)


def test_safetensors_files_interoperate_with_the_package(tmp_path):
    from safetensors.torch import load_file, save_file

    rng = np.random.default_rng(0)
    tensors = {"a.weight": torch.from_numpy(rng.standard_normal((5, 3), np.float32)),
               "b": torch.from_numpy(rng.standard_normal(7)).to(torch.bfloat16),
               "c": torch.arange(6, dtype=torch.int64).reshape(2, 3),
               "empty": torch.zeros((0, 4))}
    hf_dir.write_safetensors(tmp_path / "port.safetensors", tensors)
    theirs = load_file(tmp_path / "port.safetensors")
    save_file(tensors, tmp_path / "theirs.safetensors", metadata={"format": "pt"})
    ours = hf_dir.read_safetensors(tmp_path / "theirs.safetensors")
    for got in (theirs, ours):
        assert sorted(got) == sorted(tensors)
        for k, v in tensors.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_refusals(tmp_path):
    with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
        hf_dir.read_state_dict(str(tmp_path))
    with pytest.raises(ValueError, match="unknown direction"):
        app.main(["--direction=sideways", f"--output={tmp_path / 'x'}"])
    with pytest.raises(ValueError, match="--output"):
        app.main(["--direction=unscan"])
