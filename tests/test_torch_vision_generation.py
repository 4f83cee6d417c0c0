"""The port's text-to-image/video path against the JAX package on the CPU:
`VideoLLaMAForCausalLM.generate_vision` (the classifier-free-guidance
sampler) against `FlaxVideoLLaMAForCausalLM.generate_vision` on the same
converted weights, and `python -m lwm_tpu_torch.apps.vision_generation`'s
`main` against the JAX app's over one tiny params stream and one VQGAN
pickle the port writes.

Sampled tokens agree only where the draw is forced, so the token checks
run at top-k 1: over 2 frames (514 tokens), at cfg 5.0 and 1.0, with and
without a vision prefix, EOF at every 257th token. The first step's guided
and warped logits are held at 1e-5 at a temperature and a wider top-k.

The JAX app runs in a subprocess: its module defines absl flags at import
that clash with those of other JAX modules the suite imports. Both apps'
`VQGAN` constructors are patched to the small config, and `write_video` to
record its frames.
"""

import functools
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import GenerationConfig as HFGenerationConfig
from transformers.generation.flax_logits_process import (
    FlaxTemperatureLogitsWarper,
    FlaxTopKLogitsWarper,
)

from lwm_tpu.models import FlaxVideoLLaMAForCausalLM
from lwm_tpu.models import VideoLLaMAConfig as JaxConfig
from lwm_tpu_torch import checkpoint
from lwm_tpu_torch.apps import vision_generation as app
from lwm_tpu_torch.generation import GenerationConfig
from lwm_tpu_torch.models import vision_llama as port
from lwm_tpu_torch.models.vqgan import VQGANConfig, VQGANModel
from lwm_tpu_torch.utils.convert import convert_flax_params, flax_params_tree, save_vqgan_pickle
from lwm_tpu_torch.utils.image import read_png, write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENIZER = os.path.join(REPO, "tests", "fixtures", "tokenizer")   # 457 tokens, <vision> = 3
FP32_TOL = dict(atol=1e-5, rtol=1e-5)
TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_sequence_length=1024,
            scan_attention=False, scan_mlp=False, scan_layers=False, sample_mode="vision")
FRAMES2 = 2 * port.TOKENS_PER_FRAME
PROMPT_LEN = 12
# the small VQGAN of tests/test_vqgan.py:15-27, at 256 codes (the tiny model
# samples codes below its vision vocabulary)
SMALL_VQGAN = dict(resolution=32, hidden_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                   z_channels=8, num_embeddings=8192, quantized_embed_dim=8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one CPU thread: its steps are small ops, which
    torch's intra-op pool slows ~40x when the test workers share the cores
    (measured: 60 s against 1.5 s for 514 sampler steps)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def models():
    """(JAX model, port model) with the same weights; decode_index shared."""
    jm = FlaxVideoLLaMAForCausalLM(JaxConfig(**TINY, mesh_dim=None, attn_impl="xla"),
                                   input_shape=(1, 8), seed=0)
    cfg = port.VideoLLaMAConfig.from_dict(TINY)
    pm = port.VideoLLaMAForCausalLM(cfg, device="cpu")
    pm.load_state_dict(convert_flax_params(jax.device_get(jm.params), cfg))
    return jm, pm.eval()


def batch(prefix):
    """[cond; uncond] rows of PROMPT_LEN left-padded text tokens, then, with
    `prefix`, one frame's 257 vision tokens appended to both halves."""
    rng = np.random.default_rng(3)
    ids = rng.integers(4, 457, (2, PROMPT_LEN))
    mask = np.ones_like(ids)
    mask[1, :9] = 0                   # the uncond row is shorter
    ids = np.where(mask > 0, ids, 2)
    vm = np.zeros(ids.shape, bool)
    if prefix:
        frame = np.append(rng.integers(0, 8192, 256), port.EOF)[None].repeat(2, 0)
        ids = np.concatenate([ids, frame], 1)
        mask = np.concatenate([mask, np.ones_like(frame)], 1)
        vm = np.concatenate([vm, np.ones(frame.shape, bool)], 1)
    return ids.astype(np.int32), mask.astype(np.int32), vm


@functools.cache
def jax_sampler(width):
    """JAX generate_vision jitted as the app jits it (cfg traced), for
    prompts of `width`."""
    jm, _ = models()

    def run(params, ids, mask, vm, cfg, rng, n_tokens, top_k, temperature, eos):
        return jm.generate_vision(
            ids, cfg, attention_mask=mask, vision_masks=vm, params=params, prng_key=rng,
            generation_config=HFGenerationConfig(
                max_new_tokens=n_tokens, min_new_tokens=n_tokens, pad_token_id=0,
                eos_token_id=eos, temperature=temperature, do_sample=True, top_k=top_k),
        ).sequences

    return jax.jit(run, static_argnums=(6, 7, 8, 9))


def jax_tokens(prefix, cfg, eos=None, n_tokens=FRAMES2):
    jm, _ = models()
    ids, mask, vm = batch(prefix)
    seq = jax_sampler(ids.shape[1])(jm.params, jnp.asarray(ids), jnp.asarray(mask),
                                    jnp.asarray(vm), jnp.full((1,), cfg, jnp.float32),
                                    jax.random.PRNGKey(0), n_tokens, 1, 1.0, eos)
    return np.asarray(seq)


def port_tokens(prefix, cfg, eos=None, n_tokens=FRAMES2, **kw):
    _, pm = models()
    ids, mask, vm = batch(prefix)
    config = GenerationConfig(max_new_tokens=n_tokens, pad_token_id=0, eos_token_id=eos,
                              do_sample=True, top_k=kw.get("top_k", 1),
                              temperature=kw.get("temperature", 1.0))
    return pm.generate_vision(torch.from_numpy(ids).long(), cfg, torch.from_numpy(mask),
                              torch.from_numpy(vm), config, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("prefix", [False, True], ids=["no_prefix", "vision_prefix"])
@pytest.mark.parametrize("cfg", [5.0, 1.0])
def test_cfg_sampler_tokens_match_jax(cfg, prefix):
    """Top-k 1 over 2 frames: the port's sequences are JAX's, both halves
    carry the same new tokens, and every 257th is EOF."""
    want = jax_tokens(prefix, cfg)
    got = port_tokens(prefix, cfg).numpy()
    np.testing.assert_array_equal(got, want)
    new = got[:, -FRAMES2:]
    np.testing.assert_array_equal(new[0], new[1])
    assert new[0, 256] == port.EOF and new[0, 513] == port.EOF
    assert (new[0, :256] != port.EOF).all()


def test_cfg_sampler_stops_at_eos_like_jax():
    """An eos the rows draw mid-way finishes them: both stop there and pad
    the rest of the buffer."""
    free = jax_tokens(False, 5.0)[0, PROMPT_LEN:]
    eos = int(free[40])
    stop = int(np.flatnonzero(free == eos)[0])
    want = jax_tokens(False, 5.0, eos=eos, n_tokens=64)
    got = port_tokens(False, 5.0, eos=eos, n_tokens=64).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, PROMPT_LEN + stop + 1:] == 0).all() and got[0, PROMPT_LEN + stop] == eos


def test_first_step_guided_and_warped_logits_match_jax(monkeypatch):
    """The prefill's guided logits uncond + cfg·(cond − uncond) and their
    warped form (temperature 0.7, top-k 50) within 1e-5."""
    jm, pm = models()
    ids, mask, vm = batch(True)
    kw = jm.prepare_inputs_for_generation(jnp.asarray(ids), ids.shape[1] + 8,
                                          attention_mask=jnp.asarray(mask),
                                          vision_masks=jnp.asarray(vm))
    logits = np.asarray(jm(jnp.asarray(ids), params=jm.params, **kw).logits[:, -1])
    guided = logits[1:] + 5.0 * (logits[:1] - logits[1:])
    warped = FlaxTopKLogitsWarper(50)(None, FlaxTemperatureLogitsWarper(0.7)(
        None, jnp.asarray(guided), 0), 0)
    seen = []
    real = port.warp_logits
    monkeypatch.setattr(port, "warp_logits",
                        lambda x, c: seen.append((x, real(x, c))) or seen[-1][1])
    port_tokens(True, 5.0, n_tokens=2, top_k=50, temperature=0.7)
    got_guided, got_warped = (t.numpy() for t in seen[0])
    np.testing.assert_allclose(got_guided, guided, **FP32_TOL)
    finite = np.isfinite(np.asarray(warped))
    np.testing.assert_array_equal(np.isfinite(got_warped), finite)
    np.testing.assert_allclose(got_warped[finite], np.asarray(warped)[finite], **FP32_TOL)
    assert finite.sum() == 50 and len(seen) == 2


def test_sampler_refuses_greedy_and_odd_batches():
    _, pm = models()
    ids, mask, vm = (torch.from_numpy(x) for x in batch(False))
    with pytest.raises(NotImplementedError, match="sampling"):
        pm.generate_vision(ids.long(), 1.0, mask, vm, GenerationConfig(pad_token_id=0))
    with pytest.raises(ValueError, match="cond over uncond"):
        pm.generate_vision(ids[:1].long(), 1.0, mask[:1], vm[:1],
                           GenerationConfig(pad_token_id=0, do_sample=True))


def test_png_writer_round_trips_through_pil(tmp_path):
    """`write_png`'s file decodes, by PIL and by `read_png`, to the pixels given."""
    from PIL import Image

    pixels = np.random.default_rng(0).integers(0, 256, (9, 13, 3)).astype(np.uint8)
    write_png(tmp_path / "x.png", pixels)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "x.png")), pixels)
    np.testing.assert_array_equal(read_png(tmp_path / "x.png"), pixels)


JAX_APP = r'''
import json, sys
import numpy as np
args = json.loads(sys.argv[1])
from lwm_tpu.apps import vision_generation as vg
from lwm_tpu.models import vqgan
real = vg.VQGAN
decoded = []


def small_vqgan(path, replicate=False):
    vq = real(path, replicate, config_updates=args["vqgan"])
    decode = vq.decode

    def recorded(codes):
        pixels = decode(codes)
        decoded.append(dict(codes=np.asarray(codes).tolist(),
                            pixels=np.asarray(pixels, np.float32).tolist()))
        return pixels

    vq.decode = recorded
    return vq


vg.VQGAN = small_vqgan
frames = []
vg.write_video = lambda path, f, fps=4: frames.append(np.asarray(f).tolist())
for argv in args["runs"]:
    vg.FLAGS(["prog"] + argv)
    vg.main([])
print(json.dumps(dict(frames=frames, decoded=decoded)))
'''


@pytest.fixture(scope="module")
def app_files(tmp_path_factory):
    """A tiny VideoLLaMA params stream and a small VQGAN pickle, both written
    by the port."""
    tmp = tmp_path_factory.mktemp("vision_generation")
    _, pm = models()
    checkpoint.save_tree(flax_params_tree(pm.state_dict(), pm.config), str(tmp / "params"))
    vq = VQGANModel(VQGANConfig.get_default_config(SMALL_VQGAN), device="cpu")
    vq.init_weights(torch.Generator().manual_seed(5))
    save_vqgan_pickle(vq.state_dict(), tmp / "vqgan.pkl")
    return tmp


def app_argv(tmp, out, n_frames):
    llama = dict(TINY, scan_layers=False)
    return [f"--output_file={out}", f"--n_frames={n_frames}", "--prompt=a red bird",
            "--cfg_scale_image=5.0", "--top_k_image=1", "--top_k_video=1",
            "--cfg_scale_video=3.0", "--seed=3", f"--tokenizer={TOKENIZER}",
            f"--vqgan_checkpoint={tmp / 'vqgan.pkl'}", f"--load_checkpoint=params::{tmp / 'params'}",
            "--update_llama_config=dict(" + ",".join(f"{k}={v!r}" for k, v in llama.items())
            + ")"]


def _hold_pixels(got, want, want_float, what):
    """uint8 pixels `got` equal the JAX app's `want` except where the JAX
    app's float (x + 1) · 127.5, truncated to give `want`, lies within the
    fp32 tolerance of an integer: there one ulp across it flips the pixel
    by 1."""
    y = (want_float.astype(np.float64) + 1) * 127.5
    near = np.abs(y - np.round(y)) <= 127.5 * (FP32_TOL["atol"]
                                               + FP32_TOL["rtol"] * np.abs(want_float))
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert got.shape == want.shape, what
    assert not np.any(diff[~near]), f"{what}: {int((diff[~near] > 0).sum())} pixels differ"
    assert diff.max() <= 1, what


def test_cli_matches_the_jax_app(app_files, monkeypatch):
    """`main` with `--top_k_image=1` samples the JAX app's VQ codes (held
    exactly), decodes them to the JAX app's floats (held at fp32 1e-5) and
    writes the JAX app's PNG (read back with PIL), and at n_frames=2 hands
    `write_video` the JAX app's frames: both truncate (x + 1) · 127.5 to
    uint8, so the pixels are held equal except where JAX's float lies
    within that tolerance of an integer (`_hold_pixels`)."""
    from PIL import Image

    tmp = app_files
    runs = [app_argv(tmp, tmp / "jax.png", 1), app_argv(tmp, tmp / "jax.mp4", 2)]
    proc = subprocess.run(
        [sys.executable, "-c", JAX_APP, json.dumps(dict(runs=[list(map(str, r)) for r in runs],
                                                        vqgan=SMALL_VQGAN))],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu",   # one CPU device: the app's mesh is 1 x 1
                 XLA_FLAGS=os.environ.get("XLA_FLAGS", "").replace(
                     "--xla_force_host_platform_device_count=8", "")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    jax_run = json.loads(proc.stdout.strip().splitlines()[-1])
    want_frames = np.asarray(jax_run["frames"], np.uint8)

    from lwm_tpu_torch.models import vqgan as port_vqgan

    real = port_vqgan.VQGAN
    decoded = []

    def small_vqgan(path, replicate=False, device="cuda"):
        vq = real(path, replicate, config_updates=SMALL_VQGAN, device=device)
        decode = vq.decode

        def recorded(codes):
            pixels = decode(codes)
            decoded.append((np.asarray(codes), pixels.float().cpu().numpy()))
            return pixels

        vq.decode = recorded
        return vq

    monkeypatch.setattr(app, "VQGAN", small_vqgan)
    frames = []
    monkeypatch.setattr(app, "write_video", lambda path, f, fps=4: frames.append(f))
    app.main(list(map(str, app_argv(tmp, tmp / "port.png", 1))) + ["--device=cpu"])
    app.main(list(map(str, app_argv(tmp, tmp / "port.mp4", 2))) + ["--device=cpu"])
    assert len(decoded) == len(jax_run["decoded"]) == 2
    for (codes, pixels), want_dec in zip(decoded, jax_run["decoded"]):
        np.testing.assert_array_equal(codes, np.asarray(want_dec["codes"]))
        np.testing.assert_allclose(pixels, np.asarray(want_dec["pixels"], np.float32), **FP32_TOL)
    image_float, video_float = (np.asarray(x["pixels"], np.float32) for x in jax_run["decoded"])
    want = np.asarray(Image.open(tmp / "jax.png"))
    assert want.shape == (32, 32, 3)
    _hold_pixels(np.asarray(Image.open(tmp / "port.png")), want, image_float[0], "png")
    assert want_frames.shape == (1, 2, 32, 32, 3)
    _hold_pixels(np.stack(frames), want_frames, video_float[None], "frames")
    _hold_pixels(frames[0][0], want, image_float[0], "first frame")


@pytest.mark.parametrize("argv, err", [
    (["--output_file=x.gif"], "unsupported output extension"),
    (["--output_file=x.mp4", "--n_frames=1"], "n_frames > 1"),
    (["--output_file=x.png", "--n_frames=3"], "n_frames=1"),
    (["--output_file=x.png", "--mesh_dim=1,2,1,1"], "ROADMAP A4"),
])
def test_cli_refuses_before_loading(argv, err):
    with pytest.raises((ValueError, NotImplementedError), match=err):
        app.main(argv + ["--device=cpu"])


def test_mp4_without_a_writer_raises_before_loading(monkeypatch):
    import importlib.util

    monkeypatch.setattr(importlib.util, "find_spec", lambda name: None)
    with pytest.raises(ImportError, match="imageio.*cv2"):
        app.main(["--output_file=x.mp4", "--n_frames=2", "--device=cpu"])


@pytest.mark.parametrize("kind, n_frames", [("image", 1), ("video", 8)])
def test_bundles_parse_as_the_jax_bundles(kind, n_frames):
    """scripts/run_sample_{image,video}_torch.sh carry the JAX bundles'
    flags: the port's parser takes them, and the model config they resolve
    is the 7b preset in sample_mode 'vision' at theta 5e7."""
    import shlex

    def flags_of(path):
        text = open(os.path.join(REPO, "scripts", path)).read()
        cmd = text[text.index("python3 -u -m"):].replace("\\\n", " ")
        env = dict(PROMPT="a cat", OUTPUT_FILE=f"x.{'png' if n_frames == 1 else 'mp4'}",
                   VQGAN_CHECKPOINT="vq.pkl", TOKENIZER=TOKENIZER, CHECKPOINT="ckpt")
        cmd = re.sub(r"\$\{(\w+)(:-[^}]*)?\}", lambda m: env[m.group(1)], cmd)
        return shlex.split(cmd)[4:]

    port_args = flags_of(f"run_sample_{kind}_torch.sh")
    assert port_args == flags_of(f"run_sample_{kind}.sh")
    flags = app.parse_flags(app.DEFAULTS, port_args, prog="bundle", free=("llama",))
    assert flags.n_frames == n_frames and flags.dtype == "fp32"
    app.check_output(flags)
    from lwm_tpu_torch.apps.sampler import resolve_model_config

    cfg = resolve_model_config(flags, None, port.VideoLLaMAConfig)
    assert (cfg.sample_mode, cfg.theta, cfg.hidden_size, cfg.num_hidden_layers) == (
        "vision", 50000000, 4096, 32)
