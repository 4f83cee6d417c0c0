"""The port's VQGAN (lwm_tpu_torch.models.vqgan) against the JAX package's
on the CPU, at fp32, with the same params carried across by
`utils.convert.vqgan_params_from_flax` and inputs from a numpy seed:
encode (quantized within 1e-5, indices equal), decode (pixels within 1e-5
of the largest), the 5-D time folding, `train_forward`'s four outputs and
the gradients of the VQ-VAE objective against `jax.grad`. Two configs: the
small one of tests/test_vqgan.py:15-27, and one with attention at the 16 x
16 level and in the mid block and resampling without convs (the average
pool). The released tree's 277 leaves map onto the port's parameters, and
the released pickle loads into the port.

The JAX VQGAN's average pool (`nn.avg_pool(h, [2, 2], [2, 2])`,
`lwm_tpu/models/vqgan.py:305`) fails under flax 0.12.3, whose pooling
concatenates the strides to a tuple; the JAX side of the pooled config
runs with `flax.linen.avg_pool` given tuples (ROADMAP C8).
"""

import functools
import json
import os
import pickle

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax.traverse_util import flatten_dict

from lwm_tpu.models.vqgan import VQGAN as JaxVQGAN
from lwm_tpu.models.vqgan import VQGANConfig as JaxConfig
from lwm_tpu.models.vqgan import VQGANModel as JaxModel
from lwm_tpu_torch.models import vqgan as port
from lwm_tpu_torch.utils.convert import (
    load_vqgan_pickle,
    save_vqgan_pickle,
    vqgan_param_name,
    vqgan_params_from_flax,
    vqgan_params_to_flax,
)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TOL = 1e-5
# gaps between the two nearest codes below this are reported, not held
TIE_GAP = 1e-5
# a gradient whose largest element is below this share of the largest of all
# is zero in exact arithmetic
ZERO_GRAD = 1e-4
SMALL = dict(resolution=32, hidden_channels=32, channel_mult=(1, 2), num_res_blocks=1,
             z_channels=8, num_embeddings=64, quantized_embed_dim=8)
CONFIGS = {
    "small": SMALL,
    "attn_avgpool": dict(SMALL, attn_resolutions=(16,), no_attn_mid_block=False,
                         resample_with_conv=False),
}

_avg_pool = flax_nn.avg_pool


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one CPU thread: its steps are small ops, which
    torch's intra-op pool slows ~40x when the test workers share the cores
    (measured: 60 s against 1.5 s for 514 sampler steps)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _avg_pool_tuples(x, window_shape, strides=None, padding="VALID"):
    return _avg_pool(x, tuple(window_shape), None if strides is None else tuple(strides), padding)


@functools.cache
def models(name):
    """(JAX model, its params, port model on the CPU with the same params)."""
    jm = JaxModel(JaxConfig.get_default_config(CONFIGS[name]))
    pixels = np.random.default_rng(0).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    flax_nn.avg_pool = _avg_pool_tuples
    try:
        params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(1),
                                                 jnp.asarray(pixels))["params"])
    finally:
        flax_nn.avg_pool = _avg_pool
    cfg = port.VQGANConfig.get_default_config(CONFIGS[name])
    pm = port.VQGANModel(cfg, device="cpu")
    pm.load_state_dict(vqgan_params_from_flax(params, cfg))
    return jm, params, pm.eval()


@functools.cache
def jax_fn(name, method):
    jm, _, _ = models(name)
    return jax.jit(lambda p, x: jm.apply({"params": p}, x, method=getattr(jm, method)))


def run_jax(name, method, x):
    _, params, _ = models(name)
    flax_nn.avg_pool = _avg_pool_tuples
    try:
        return jax.tree.map(np.asarray, jax_fn(name, method)(params, jnp.asarray(x)))
    finally:
        flax_nn.avg_pool = _avg_pool


def pixels(shape, seed=2):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def close(got, want, what):
    err = np.abs(np.asarray(got) - want).max()
    assert err <= TOL * max(np.abs(want).max(), 1.0), f"{what}: max |diff| {err}"


def hold_codes(got, want, pm, x, what):
    """Codes equal, except where the two nearest codes of the port's z for
    pixels x (held to JAX's z by test_train_forward_matches_jax) are closer
    than TIE_GAP (reported)."""
    got, want = np.asarray(got), np.asarray(want)
    with torch.no_grad():
        z = pm.train_forward(torch.from_numpy(x))[1].numpy()
    codebook = pm.quantize.embeddings.detach().numpy()
    flat = z.reshape(-1, z.shape[-1]).astype(np.float64)
    d = ((flat[:, None, :] - codebook[None].astype(np.float64)) ** 2).sum(-1)
    top2 = np.sort(d, axis=1)[:, :2]
    near = (top2[:, 1] - top2[:, 0]) < TIE_GAP
    apart = (got.reshape(-1) != want.reshape(-1))
    if apart.any():
        print(f"{what}: codes apart at {np.flatnonzero(apart)} (near ties {np.flatnonzero(near)})")
    assert not (apart & ~near).any(), f"{what}: codes differ away from a near tie"
    return ~apart


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encode_matches_jax(name):
    _, _, pm = models(name)
    x = pixels((2, 32, 32, 3))
    want_q, want_i = run_jax(name, "encode", x)
    with torch.no_grad():
        got_q, got_i = pm.encode(torch.from_numpy(x))
    assert got_i.shape == (2, 16, 16) and got_q.shape == (2, 16, 16, 8)
    same = hold_codes(got_i, want_i, pm, x, f"{name} encode")
    close(got_q.numpy().reshape(-1, 8)[same], want_q.reshape(-1, 8)[same], f"{name} quantized")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decode_matches_jax(name):
    _, _, pm = models(name)
    codes = np.random.default_rng(3).integers(0, 64, (2, 16, 16))
    want = run_jax(name, "decode", codes)
    with torch.no_grad():
        got = pm.decode(torch.from_numpy(codes))
    assert got.shape == (2, 32, 32, 3) and float(got.abs().max()) <= 1.0
    close(got.numpy(), want, f"{name} decode")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_video_folds_time_into_the_batch(name):
    """[b, t, H, W, C] encodes to JAX's [b, t, 16, 16] codes, the same as its
    frames one by one, and decodes to JAX's [b, t, H, W, C]."""
    _, _, pm = models(name)
    video = pixels((2, 3, 32, 32, 3), seed=4)
    _, want_i = run_jax(name, "encode", video)
    with torch.no_grad():
        got_q, got_i = pm.encode(torch.from_numpy(video))
        _, flat_i = pm.encode(torch.from_numpy(video.reshape(-1, 32, 32, 3)))
    assert got_q.shape == (2, 3, 16, 16, 8)
    hold_codes(got_i, want_i, pm, video, f"{name} video")
    np.testing.assert_array_equal(got_i.reshape(-1, 16, 16).numpy(), flat_i.numpy())
    want = run_jax(name, "decode", want_i)
    with torch.no_grad():
        got = pm.decode(torch.from_numpy(want_i))
    assert got.shape == (2, 3, 32, 32, 3)
    close(got.numpy(), want, f"{name} video decode")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_forward_matches_jax(name):
    """(recon before the clip, z, z_q_raw, indices), time folded."""
    _, _, pm = models(name)
    x = pixels((1, 2, 32, 32, 3), seed=5)
    want = run_jax(name, "train_forward", x)
    with torch.no_grad():
        got = pm.train_forward(torch.from_numpy(x))
    for what, g, w in zip(("recon", "z", "z_q_raw"), got, want):
        assert g.shape == w.shape, what
        close(g.numpy(), w, f"{name} {what}")
    np.testing.assert_array_equal(got[3].numpy(), want[3])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_objective_gradients_match_jax(name):
    """The port's fp32 grads of mean (recon − x)² + mean (sg(z) − e)² +
    0.25 · mean (z − sg(e))² against `jax.grad` of the same objective,
    each within 1e-5 of its largest element (the straight-through estimator
    carries the recon's grad into the encoder, the codebook term into the
    embeddings). JAX's grads are taken at float64 (`jax.enable_x64`): its
    own fp32 grads sit up to 1.9e-5 of a leaf's largest element from them
    (measured, the attention config), the port's up to 8.4e-6, so two fp32
    runs cannot hold 1e-5 on every leaf. A conv bias that a GroupNorm
    subtracts again (with 32 channels, one a group, every bias ahead of
    one) has a zero gradient but for fp32 rounding, below ZERO_GRAD of the
    largest element of any gradient: it is held at 1e-5 of that largest
    element."""
    jm, params, pm = models(name)
    x = pixels((2, 32, 32, 3), seed=6)

    def loss_jax(p):
        recon, z, e, _ = jm.apply({"params": p}, jnp.asarray(x, jnp.float64),
                                  method=jm.train_forward)
        return (jnp.mean((recon - x) ** 2) + jnp.mean((jax.lax.stop_gradient(z) - e) ** 2)
                + 0.25 * jnp.mean((z - jax.lax.stop_gradient(e)) ** 2))

    flax_nn.avg_pool = _avg_pool_tuples
    try:
        with jax.enable_x64(True):
            p64 = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
            want = jax.device_get(jax.jit(jax.grad(loss_jax))(p64))
    finally:
        flax_nn.avg_pool = _avg_pool
    want = {k: np.asarray(v, np.float64) for k, v in flatten_dict(want).items()}
    pm.zero_grad()
    xt = torch.from_numpy(x)
    recon, z, e, _ = pm.train_forward(xt)
    loss = (F.mse_loss(recon, xt) + F.mse_loss(z.detach(), e)
            + 0.25 * F.mse_loss(z, e.detach()))
    loss.backward()
    got = vqgan_params_to_flax({n: p.grad for n, p in pm.named_parameters()})
    got = flatten_dict(got)
    assert got.keys() == want.keys()
    largest = max(np.abs(w).max() for w in want.values())
    for n, w in want.items():
        err = np.abs(got[n] - w).max()
        scale = np.abs(w).max()
        if scale < ZERO_GRAD * largest:   # zero but for rounding: a bias a GroupNorm cancels
            scale = largest
        assert err <= TOL * scale, f"{name} grad {'/'.join(n)}: {err} of {np.abs(w).max()}"


def test_upsample_equals_jax_nearest_resize():
    """`jax.image.resize(..., "nearest")` at an exact 2x is F.interpolate's
    nearest, element for element."""
    x = pixels((2, 5, 7, 3), seed=7)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 10, 14, 3), method="nearest"))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=2,
                        mode="nearest").permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_released_tree_maps_leaf_for_leaf():
    """Each of the released tree's 277 leaves (146,244,675 params) names one
    parameter of the port's default model, built on `meta`, of its shape;
    none is left over."""
    golden = json.load(open(os.path.join(FIXTURES, "vqgan_released_tree.json")))
    sd = port.VQGANModel(device="meta").state_dict()
    mapped = dict(vqgan_param_name(tuple(k.split("/")), tuple(v)) for k, v in golden.items())
    assert len(golden) == 277 and len(mapped) == 277
    assert mapped == {k: tuple(v.shape) for k, v in sd.items()}
    assert sum(v.numel() for v in sd.values()) == 146_244_675


def test_released_pickle_loads_into_the_port(tmp_path):
    """A pickle written as tests/test_vqgan.py:146-170 writes it (the flax
    tree, `jax.device_get`) gives, through the port's `VQGAN`, the JAX
    wrapper's codes and pixels; the port's own pickle loads into the JAX
    wrapper and gives them too."""
    _, params, pm = models("small")
    path = tmp_path / "vqgan_params.pkl"
    with open(path, "wb") as f:
        pickle.dump(params, f)
    x = pixels((1, 32, 32, 3), seed=8)
    jaxvq = JaxVQGAN(str(path), config_updates=SMALL)
    want_codes = np.asarray(jaxvq.encode(jnp.asarray(x))[1])
    want_img = np.asarray(jaxvq.decode(jnp.asarray(want_codes)))
    vq = port.VQGAN(str(path), config_updates=SMALL, device="cpu")
    np.testing.assert_array_equal(vq.encode(x)[1].numpy(), want_codes)
    close(vq.decode(want_codes).numpy(), want_img, "pickle decode")
    save_vqgan_pickle(vq.model.state_dict(), tmp_path / "port.pkl")
    back = JaxVQGAN(str(tmp_path / "port.pkl"), config_updates=SMALL)
    np.testing.assert_array_equal(np.asarray(back.encode(jnp.asarray(x))[1]), want_codes)


def test_pickle_reader_refuses_other_classes(tmp_path):
    """A flax FrozenDict (or any class but builtins and numpy arrays) is
    refused, by name; `replicate=True` raises and names A4."""
    from flax.core import FrozenDict

    _, params, _ = models("small")
    path = tmp_path / "frozen.pkl"
    with open(path, "wb") as f:
        pickle.dump(FrozenDict(params), f)
    with pytest.raises(pickle.UnpicklingError, match="flax.core.frozen_dict.FrozenDict"):
        load_vqgan_pickle(path)
    with pytest.raises(NotImplementedError, match="A4"):
        port.VQGAN(str(path), replicate=True, device="cpu")


# a cheap VQGAN at the apps' 256 x 256 (serve_vision center-crops to 256)
APP_VQGAN = dict(hidden_channels=32, channel_mult=(1, 1, 1, 1, 1), num_res_blocks=1,
                 z_channels=8, num_embeddings=64, quantized_embed_dim=8)

JAX_ENCODE = r"""
import json, sys
args = json.loads(sys.argv[1])
from lwm_tpu.apps import serve_vision as sv
from lwm_tpu.models import vqgan
import lwm_tpu.utils
# the JAX app's file path imports lwm_tpu.apps.vision_chat, whose absl flags
# clash with its own (ROADMAP C9): import it with its flags left undefined
define = lwm_tpu.utils.define_flags_with_default
lwm_tpu.utils.define_flags_with_default = lambda **kw: (None, None)
import lwm_tpu.apps.vision_chat
lwm_tpu.utils.define_flags_with_default = define
real = vqgan.VQGAN
vqgan.VQGAN = lambda path, replicate=False: real(path, replicate, config_updates=args["vqgan"])
out = []
for path in args["inputs"]:
    sv.FLAGS(["prog", f"--input_file={path}", f"--vqgan_checkpoint={args['ckpt']}",
              "--max_n_frames=3"])
    out.append(sv.encode_video_tokens())
print(json.dumps(out))
"""


def test_serve_vision_input_file_matches_the_jax_app(tmp_path, monkeypatch):
    """`serve_vision --input_file` for a PNG and a 5-frame video (3 frames
    sampled) gives the JAX app's tokens: the same crops through the port's
    VQGAN, EOF after each frame and EOV after the last."""
    import subprocess
    import sys

    import cv2
    from PIL import Image

    from lwm_tpu_torch.apps import serve_vision as cli
    from lwm_tpu_torch.apps.serve_vision import parse_flags

    rng = np.random.default_rng(9)
    Image.fromarray(rng.integers(0, 256, (300, 280, 3)).astype(np.uint8)).save(tmp_path / "a.png")
    out = cv2.VideoWriter(str(tmp_path / "v.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 4, (48, 40))
    for _ in range(5):
        out.write(rng.integers(0, 256, (40, 48, 3)).astype(np.uint8))
    out.release()
    vq = port.VQGANModel(port.VQGANConfig.get_default_config(APP_VQGAN), device="cpu")
    vq.init_weights(torch.Generator().manual_seed(3))
    save_vqgan_pickle(vq.state_dict(), tmp_path / "vq.pkl")
    inputs = [str(tmp_path / "a.png"), str(tmp_path / "v.mp4")]
    proc = subprocess.run(
        [sys.executable, "-c", JAX_ENCODE,
         json.dumps(dict(inputs=inputs, ckpt=str(tmp_path / "vq.pkl"), vqgan=APP_VQGAN))],
        cwd=os.path.dirname(os.path.dirname(FIXTURES)), capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    real = port.VQGAN
    monkeypatch.setattr(cli, "VQGAN", lambda path, replicate=False, device="cuda": real(
        path, replicate, config_updates=APP_VQGAN, device=device))
    for path, tokens in zip(inputs, want):
        flags = parse_flags([f"--input_file={path}", f"--vqgan_checkpoint={tmp_path / 'vq.pkl'}",
                             "--max_n_frames=3", "--device=cpu"])
        assert cli.encode_video_tokens(flags) == tokens
    assert len(want[0]) == 257 and len(want[1]) == 3 * 257 and want[1][-1] == 8193
