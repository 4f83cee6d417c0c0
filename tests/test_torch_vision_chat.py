"""The port's image and video QA (`lwm_tpu_torch.apps.vision_chat`) against
the JAX app on the CPU, over one tiny VideoLLaMA params stream and one
small VQGAN pickle that the port writes, a PNG and a 5-frame video:

- the vision tokens of each file (VQ codes, EOF after each frame, EOV after
  the last) equal the JAX app's;
- `Sampler.construct_input`'s ids, vision masks and attention mask equal
  the JAX app's, with the fixture tokenizer and with a LLaMA-layout one,
  whose every encoded part carries a bos (the JAX app's quirk, kept);
- the prefill's last logits (the prompt's vision masks read) match the JAX
  model's at 1e-5, and with both sides at top-k 1 the new tokens, the
  answers and `main`'s printed lines are the JAX app's.

Sampled tokens agree only where the draw is forced, so the JAX app's
`GenerationConfig` gets top_k 1 and the port's `Sampler.top_k` is 1. The
JAX app runs in one subprocess (its absl flags clash with other JAX
modules'), with both apps' VQGAN constructors patched to the small config.
"""

import json
import os
import re
import shlex
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from lwm_tpu_torch import checkpoint, generation
from lwm_tpu_torch.apps import vision_chat as app
from lwm_tpu_torch.models import vqgan as port_vqgan
from lwm_tpu_torch.models.vision_llama import (
    EOV,
    VideoLLaMAConfig,
    VideoLLaMAForCausalLM,
)
from lwm_tpu_torch.models.vqgan import VQGANConfig, VQGANModel
from lwm_tpu_torch.utils.convert import flax_params_tree, save_vqgan_pickle
from lwm_tpu_torch.utils.tokenizer import Tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENIZER = os.path.join(REPO, "tests", "fixtures", "tokenizer")   # 457 tokens, <vision> = 3
TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_sequence_length=2048,
            scan_attention=False, scan_mlp=False, scan_layers=False, sample_mode="text",
            scan_query_chunk_size=32, scan_key_chunk_size=32, initializer_range=0.2)
# a cheap VQGAN at the apps' 256 x 256
APP_VQGAN = dict(hidden_channels=32, channel_mult=(1, 1, 1, 1, 1), num_res_blocks=1,
                 z_channels=8, num_embeddings=64, quantized_embed_dim=8)
FRAMES = 3
QUESTIONS = ("What is in the picture?", "What happens in this video?")
TOL = dict(atol=1e-5, rtol=1e-5)

JAX_APP = r'''
import json, sys, types
import numpy as np
import jax, jax.numpy as jnp
args = json.loads(sys.argv[1])
from transformers import AutoTokenizer, GenerationConfig
from lwm_tpu.apps import vision_chat as vc
from lwm_tpu.utils import set_random_seed
real_vqgan = vc.VQGAN
vc.VQGAN = lambda path, replicate=False: real_vqgan(path, replicate,
                                                    config_updates=args["vqgan"])
vc.GenerationConfig = lambda **kw: GenerationConfig(**kw, top_k=1)
vc.FLAGS(["prog"] + args["argv"])
set_random_seed(vc.FLAGS.seed)
s = vc.Sampler()
prompts = [dict(input_path=p, question=q) for p, q in zip(args["inputs"], args["questions"])]
out = dict(vision=[s._encode_vision(p, args["frames"]) for p in args["inputs"]])
batch = s.construct_input(prompts, args["frames"])
out["batch"] = {k: np.asarray(v).tolist() for k, v in batch.items()}
kw = s.model.prepare_inputs_for_generation(
    jnp.asarray(batch["input_ids"]), batch["input_ids"].shape[1] + s.block_size,
    jnp.asarray(batch["attention_mask"]), jnp.asarray(batch["vision_masks"]))
logits = s.model(jnp.asarray(batch["input_ids"]), params=s.params["params"], **kw).logits
out["logits"] = np.asarray(logits[:, -1], np.float64).tolist()
with s.mesh:
    tokens, _ = s._forward_generate(s.params, s.sharded_rng, batch)
out["tokens"] = np.asarray(jax.device_get(tokens)).tolist()
out["answers"] = s(prompts, args["frames"])
# construct_input alone with a LLaMA-layout tokenizer (a bos in every part)
q = vc.Sampler.__new__(vc.Sampler)
q.tokenizer = AutoTokenizer.from_pretrained(args["llama_tokenizer"])
q.config = types.SimpleNamespace(scan_query_chunk_size=32, scan_key_chunk_size=32)
q.mesh = types.SimpleNamespace(shape={"sp": 1})
q.n_tokens_per_frame, q.min_buffer_size = 257, 256
q._encode_vision = lambda path, n: args["codes"]
b = q.construct_input([dict(input_path="x", question=args["questions"][0])], 1)
out["llama_batch"] = {k: np.asarray(v).tolist() for k, v in b.items()}
print(json.dumps(out))
'''


def app_argv(files, input_file, question):
    update = "dict(" + ",".join(f"{k}={v!r}" for k, v in TINY.items()) + ")"
    return [f"--prompt={question}", f"--input_file={input_file}",
            f"--vqgan_checkpoint={files / 'vqgan.pkl'}", "--mesh_dim=1,-1,1,1", "--dtype=fp32",
            f"--update_llama_config={update}", f"--tokenizer={TOKENIZER}",
            f"--load_checkpoint=params::{files / 'params'}", f"--max_n_frames={FRAMES}",
            "--temperature=0.2", "--seed=5"]


def small_vqgan(path, replicate=False, device="cuda"):
    return port_vqgan.VQGAN(path, replicate, config_updates=APP_VQGAN, device=device)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The inputs, the params stream, the VQGAN pickle, a LLaMA-layout
    tokenizer, and the JAX app's outputs over them."""
    import cv2
    from PIL import Image
    from test_torch_tokenizer import llama_dir

    tmp = tmp_path_factory.mktemp("vision_chat")
    rng = np.random.default_rng(9)
    Image.fromarray(rng.integers(0, 256, (300, 280, 3)).astype(np.uint8)).save(tmp / "a.png")
    out = cv2.VideoWriter(str(tmp / "v.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 4, (48, 40))
    for _ in range(5):
        out.write(rng.integers(0, 256, (40, 48, 3)).astype(np.uint8))
    out.release()
    cfg = VideoLLaMAConfig.from_dict(TINY)
    model = VideoLLaMAForCausalLM(cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(1))
    checkpoint.save_tree(flax_params_tree(model.state_dict(), cfg), str(tmp / "params"))
    vq = VQGANModel(VQGANConfig.get_default_config(APP_VQGAN), device="cpu")
    vq.init_weights(torch.Generator().manual_seed(3))
    save_vqgan_pickle(vq.state_dict(), tmp / "vqgan.pkl")
    codes = rng.integers(0, 64, 256).tolist() + [EOV]
    args = dict(argv=app_argv(tmp, tmp / "a.png", QUESTIONS[0]), vqgan=APP_VQGAN,
                inputs=[str(tmp / "a.png"), str(tmp / "v.mp4")], questions=list(QUESTIONS),
                frames=FRAMES, llama_tokenizer=llama_dir(str(tmp)), codes=codes)
    proc = subprocess.run(
        [sys.executable, "-c", JAX_APP, json.dumps(args)], cwd=REPO, capture_output=True,
        text=True, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu",   # one CPU device: the app's mesh is 1 x 1
                 XLA_FLAGS=os.environ.get("XLA_FLAGS", "").replace(
                     "--xla_force_host_platform_device_count=8", "")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return types.SimpleNamespace(dir=tmp, args=args,
                                 jax=json.loads(proc.stdout.strip().splitlines()[-1]))


@pytest.fixture(scope="module")
def sampler(files):
    """The port's Sampler as `main` builds it, at top-k 1."""
    flags = app.parse_flags(app.DEFAULTS, app_argv(files.dir, files.dir / "a.png", QUESTIONS[0])
                            + ["--device=cpu"], prog="test", free=("llama",))
    real = app.VQGAN
    app.VQGAN = small_vqgan
    try:
        s = app.Sampler(flags)
    finally:
        app.VQGAN = real
    s.top_k = 1
    return s


def prompts(files):
    return [dict(input_path=p, question=q) for p, q in zip(files.args["inputs"], QUESTIONS)]


def test_vision_tokens_match_jax(files, sampler):
    for path, want in zip(files.args["inputs"], files.jax["vision"]):
        assert sampler._encode_vision(dict(input_path=path), FRAMES) == want
    png, video = files.jax["vision"]
    assert len(png) == 257 and len(video) == FRAMES * 257 and video[-1] == EOV


def test_construct_input_matches_jax(files, sampler):
    batch = sampler.construct_input(prompts(files), FRAMES)
    for key, want in files.jax["batch"].items():
        np.testing.assert_array_equal(batch[key], np.asarray(want), err_msg=key)
    assert batch["input_ids"].shape == (2, 1056)   # ceil((3 · 257 + 256) / 32) · 32
    # decoded frames in place of the file give the same prompt
    frames = app.read_frames(files.args["inputs"][1], FRAMES)
    again = sampler.construct_input([dict(frames=frames, question=QUESTIONS[1])], FRAMES)
    np.testing.assert_array_equal(again["input_ids"][0], batch["input_ids"][1])


def test_construct_input_keeps_the_bos_quirks(files):
    s = app.Sampler.__new__(app.Sampler)
    s.tokenizer = Tokenizer(files.args["llama_tokenizer"])
    s.config = types.SimpleNamespace(scan_query_chunk_size=32, scan_key_chunk_size=32)
    s._encode_vision = lambda prompt, n: files.args["codes"]
    batch = s.construct_input([dict(input_path="x", question=QUESTIONS[0])], 1)
    for key, want in files.jax["llama_batch"].items():
        np.testing.assert_array_equal(batch[key], np.asarray(want), err_msg=key)
    text = batch["input_ids"][0][(batch["attention_mask"][0] > 0) & ~batch["vision_masks"][0]]
    bos = s.tokenizer.bos_token_id
    assert text[0] == bos and (text == bos).sum() == 5   # "<s>" + bos, then one a part


def test_prefill_logits_match_jax(files, sampler):
    batch = sampler.construct_input(prompts(files), FRAMES)
    ids, mask, vm = (torch.as_tensor(batch[k]) for k in
                     ("input_ids", "attention_mask", "vision_masks"))
    got, _ = generation.prefill(sampler.model, ids.long(), mask.long(), sampler.block_size, vm)
    want = torch.tensor(files.jax["logits"], dtype=torch.float32)
    torch.testing.assert_close(got, want, **TOL)
    # the masks are read: the codes (below the text vocabulary) read as text
    # differ; EOF and EOV (past it) stay vision
    specials = vm & (ids >= sampler.config.vocab_size)
    other, _ = generation.prefill(sampler.model, ids.long(), mask.long(), sampler.block_size,
                                  specials)
    assert (other - got).abs().max() > 1e-2


def test_top_k_1_tokens_and_answers_match_jax(files, sampler):
    batch = sampler.construct_input(prompts(files), FRAMES)
    tokens = sampler.generate(batch)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(files.jax["tokens"]))
    assert tokens.shape == (2, 32)
    assert sampler(prompts(files), FRAMES) == files.jax["answers"]


def test_main_prints_the_jax_answer(files, monkeypatch, capsys):
    monkeypatch.setattr(app, "VQGAN", small_vqgan)
    monkeypatch.setattr(app.Sampler, "top_k", 1)
    app.main(app_argv(files.dir, files.dir / "a.png", QUESTIONS[0]) + ["--device=cpu"])
    assert capsys.readouterr().out == (f"Question: {QUESTIONS[0]}\n"
                                       f"Answer: {files.jax['answers'][0]}\n")


@pytest.mark.parametrize("argv, err", [
    (["--input_file=x.png"], "--prompt and --input_file"),
    (["--prompt=hi"], "--prompt and --input_file"),
    (["--prompt=hi", "--input_file=x.png", "--mesh_dim=1,2,1,1"], "ROADMAP A4"),
    (["--prompt=hi", "--input_file=x.png", "--jax_distributed.initialize_jax_distributed=True"],
     "ROADMAP A4"),
])
def test_cli_refusals(argv, err):
    with pytest.raises((ValueError, NotImplementedError), match=err):
        app.main(argv + ["--device=cpu"])


def test_input_file_without_pil_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="needs PIL"):
        app.read_frames("x.png", 8)


def test_bundle_parses_as_the_jax_bundle():
    """scripts/run_vision_chat_torch.sh passes `bash -n` and carries the JAX
    bundle's flags; the port's parser takes them, and they resolve to the 7b
    preset in sample_mode 'text' at theta 5e7, 8 frames, temperature 0.2."""
    from lwm_tpu_torch.apps.sampler import resolve_model_config

    def flags_of(name):
        path = os.path.join(REPO, "scripts", name)
        assert subprocess.run(["bash", "-n", path]).returncode == 0
        text = open(path).read()
        cmd = text[text.index("python3 -u -m"):].replace("\\\n", " ")
        env = dict(PROMPT="What is this?", INPUT_FILE="v.mp4", VQGAN_CHECKPOINT="vq.pkl",
                   TOKENIZER=TOKENIZER, CHECKPOINT="ckpt")
        cmd = re.sub(r"\$\{(\w+)(:-[^}]*)?\}", lambda m: env[m.group(1)], cmd)
        return shlex.split(cmd)[4:]

    port_args = flags_of("run_vision_chat_torch.sh")
    assert port_args == flags_of("run_vision_chat.sh")
    flags = app.parse_flags(app.DEFAULTS, port_args, prog="bundle", free=("llama",))
    assert (flags.max_n_frames, flags.temperature, flags.dtype) == (8, 0.2, "fp32")
    cfg = resolve_model_config(flags, None, VideoLLaMAConfig)
    assert (cfg.sample_mode, cfg.theta, cfg.hidden_size, cfg.num_hidden_layers,
            cfg.scan_query_chunk_size) == ("text", 50000000, 4096, 32, 128)
