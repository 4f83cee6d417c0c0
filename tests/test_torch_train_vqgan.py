"""The port's VQ tokenizer trainer (`lwm_tpu_torch.apps.train_vqgan`)
against the JAX app's, step by step, on the CPU.

Both train at 16 px (channel mult 1,2, hidden 32, z 8, 64 codes, batch 2)
for 4 steps with revival every 2 over PNGs written to a temporary
directory, the port from the JAX run's initial params (carried across by
`utils.convert.vqgan_params_from_flax`). The JAX app's `main` runs in this
process with `sys.argv` set, its `crop_batch` wrapped to record the crops
and its `jax.value_and_grad` and `optax.apply_updates` to record, through
`jax.debug.callback` inside its jitted step, each step's params, loss,
reconstruction loss, grads and updated params. Held:
- each step's loss and reconstruction loss at 1e-5 relative;
- step 1's grads within 1e-5 of the largest grad element;
- every step's codes equal (JAX's from its step's params and crops);
- the rows each revival sets, and their values (random encoder outputs
  of the updated params, so params of their own) as the params below;
- the final params within 2 · lr · steps of JAX's in every element: the
  most Adam's unit-size update can move an element whose gradient is at
  the fp32 noise, in the two runs' opposite directions;
- the held-out round-trip line's codebook usage, and its PSNR at 0.01 dB;
- the JAX `VQGAN` wrapper loads the port's pickle and decodes the codes
  to the port's pixels at 1e-5.
`read_png` equals PIL's decode of filtered, gray, palette and alpha PNGs,
and a JPEG without PIL raises, naming the file.
"""

import contextlib
import io
import pickle
import sys

import numpy as np
import pytest
import torch

from lwm_tpu_torch.apps import train_vqgan
from lwm_tpu_torch.models.vqgan import VQGAN, VQGANConfig
from lwm_tpu_torch.utils.convert import vqgan_params_from_flax, vqgan_params_to_flax
from lwm_tpu_torch.utils.image import read_png, write_png

TOL = 1e-5
STEPS, LR = 4, 3e-4
ARGV = ["--resolution", "16", "--steps", str(STEPS), "--batch", "2", "--channel_mult", "1,2",
        "--hidden_channels", "32", "--z_channels", "8", "--num_embeddings", "64",
        "--revive_every", "2", "--eval_crops", "6", "--seed", "3", "--lr", str(LR)]


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, (*prefix, k))
        else:
            yield (*prefix, k), np.asarray(v)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Six smooth-plus-noise RGB PNGs of 20-30 px a side."""
    d = tmp_path_factory.mktemp("vq_images")
    rng = np.random.default_rng(11)
    for i in range(6):
        h, w = 20 + 2 * i, 30 - i
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([yy * 9 + i * 20, xx * 7, (yy + xx) * 5], -1) % 256
        px = np.clip(base + rng.integers(-30, 30, (h, w, 3)), 0, 255).astype(np.uint8)
        write_png(d / f"img{i}.png", px)
    return d


@pytest.fixture(scope="module")
def jax_run(images, tmp_path_factory):
    """The JAX app's run, recorded (see the module note)."""
    import jax
    import optax

    from lwm_tpu.apps import train_vqgan as app

    out = tmp_path_factory.mktemp("vq_jax") / "vq.pkl"
    crops, steps, updated = [], [], []
    real_crop, real_vg, real_apply = app.crop_batch, jax.value_and_grad, optax.apply_updates

    def crop_batch(*a):
        crops.append(real_crop(*a))
        return crops[-1]

    def value_and_grad(fn, has_aux=False):
        run = real_vg(fn, has_aux=has_aux)

        def recorded(params):
            (loss, (l_rec, used)), grads = run(params)
            jax.debug.callback(lambda *a: steps.append(dict(zip(
                ("params", "loss", "rec", "grads"), jax.device_get(a)))), params, loss, l_rec,
                grads, ordered=True)
            return (loss, (l_rec, used)), grads
        return recorded

    def apply_updates(params, updates):
        out = real_apply(params, updates)
        jax.debug.callback(lambda p: updated.append(jax.device_get(p)), out, ordered=True)
        return out

    argv, printed = sys.argv, io.StringIO()
    app.crop_batch, jax.value_and_grad, optax.apply_updates = (crop_batch, value_and_grad,
                                                               apply_updates)
    sys.argv = ["prog", "--image_dir", str(images), "--output", str(out), *ARGV]
    try:
        with contextlib.redirect_stdout(printed):
            app.main()
    finally:
        sys.argv = argv
        app.crop_batch, jax.value_and_grad, optax.apply_updates = (real_crop, real_vg,
                                                                   real_apply)
    from lwm_tpu.models.vqgan import VQGANConfig as JaxConfig
    from lwm_tpu.models.vqgan import VQGANModel as JaxModel

    args = train_vqgan.parse_args(["--image_dir", "x", "--output", "x", *ARGV])
    model = JaxModel(JaxConfig.get_default_config(train_vqgan.config_updates(args)))
    codes = [np.asarray(model.apply({"params": s["params"]}, crops[i],
                                    method=model.train_forward)[3])
             for i, s in enumerate(steps)]
    with open(out, "rb") as f:
        final = pickle.load(f)
    return dict(steps=steps, updated=updated, codes=codes, final=final, crops=crops[:STEPS],
                line=printed.getvalue().strip(), args=args)


@pytest.fixture(scope="module")
def port_run(images, jax_run, tmp_path_factory):
    """The port's run from the JAX run's initial params: (its records, its
    pickle, its printed round-trip line)."""
    out = tmp_path_factory.mktemp("vq_port") / "vq.pkl"
    args = jax_run["args"]
    cfg = VQGANConfig.get_default_config(train_vqgan.config_updates(args))
    init = vqgan_params_from_flax(jax_run["steps"][0]["params"], cfg)
    records, printed = [], io.StringIO()

    def record(step, info):
        if "model" in info:   # the step's grads, before the update
            info = dict(info, grads={n: p.grad.clone() for n, p in info.pop("model")
                                     .named_parameters()})
        records.append((step, info))

    with contextlib.redirect_stdout(printed):
        train_vqgan.main(["--image_dir", str(images), "--output", str(out), *ARGV,
                          "--device", "cpu"], state_dict=init,
                         record=record)
    with open(out, "rb") as f:
        final = pickle.load(f)
    return records, final, printed.getvalue().strip(), out


def test_losses_and_codes_match_jax_every_step(jax_run, port_run):
    steps = [info for _, info in port_run[0] if "loss" in info]
    assert len(steps) == STEPS == len(jax_run["steps"])
    for i, (got, want) in enumerate(zip(steps, jax_run["steps"])):
        for key in ("loss", "rec"):
            assert abs(got[key] - want[key]) <= TOL * abs(want[key]), (i + 1, key)
        np.testing.assert_array_equal(got["codes"], jax_run["codes"][i], err_msg=f"step {i + 1}")
    assert steps[-1]["loss"] < steps[0]["loss"]


def test_step_1_grads_match_jax(jax_run, port_run):
    got = dict(_flat(vqgan_params_to_flax(port_run[0][0][1]["grads"])))
    want = dict(_flat(jax_run["steps"][0]["grads"]))
    assert got.keys() == want.keys()
    largest = max(np.abs(w).max() for w in want.values())
    worst = max(np.abs(got[k] - w).max() for k, w in want.items())
    assert worst <= TOL * largest, (worst, largest)


def test_revivals_match_jax(jax_run, port_run):
    """The rows each revival sets are JAX's, with JAX's values: after step 2
    (step 3's input against step 2's update) and after step 4 (the pickle
    against step 4's update)."""
    revived = [(step, info["revived"]) for step, info in port_run[0] if "revived" in info]
    assert [step for step, _ in revived] == [2, 4]
    emb = ("quantize", "embeddings")
    before = [dict(_flat(jax_run["updated"][1]))[emb], dict(_flat(jax_run["updated"][3]))[emb]]
    after = [dict(_flat(jax_run["steps"][2]["params"]))[emb], dict(_flat(jax_run["final"]))[emb]]
    for (step, (rows, values)), b, a in zip(revived, before, after):
        assert len(rows) > 0 and list(rows) == list(np.flatnonzero((a != b).any(1))), step
        assert np.abs(values - a[rows]).max() <= 2 * LR * step, step


def test_final_params_match_jax(jax_run, port_run):
    got, want = dict(_flat(port_run[1])), dict(_flat(jax_run["final"]))
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert got[key].shape == w.shape and got[key].dtype == np.float32, key
        assert np.abs(got[key] - w).max() <= 2 * LR * STEPS, key


def test_round_trip_line_matches_jax(jax_run, port_run):
    got, want = port_run[2], jax_run["line"]
    psnr = [float(line.split("PSNR ")[1].split(" dB")[0]) for line in (got, want)]
    assert got.split(" dB")[1] == want.split(" dB")[1]
    assert abs(psnr[0] - psnr[1]) <= 0.01
    assert want.startswith("round-trip: PSNR ") and "codebook usage " in want


def test_jax_wrapper_decodes_the_port_pickle(jax_run, port_run):
    from lwm_tpu.models.vqgan import VQGAN as JaxVQGAN

    updates = train_vqgan.config_updates(jax_run["args"])
    path = port_run[3]
    port = VQGAN(str(path), config_updates=updates, device="cpu")
    jax_vq = JaxVQGAN(str(path), config_updates=updates)
    x = np.concatenate(jax_run["crops"])
    codes = port.encode(x)[1].numpy()
    np.testing.assert_array_equal(np.asarray(jax_vq.encode(x)[1]), codes)
    got, want = port.decode(codes).numpy(), np.asarray(jax_vq.decode(codes))
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def _filtered_png(path, px, filters):
    """An 8-bit RGB PNG whose row y carries filter filters[y % len]."""
    import struct
    import zlib

    h, w, _ = px.shape
    a = px.astype(np.int64).reshape(h, w * 3)
    raw = bytearray()
    for y in range(h):
        kind = filters[y % len(filters)]
        up = a[y - 1] if y else np.zeros(w * 3, np.int64)
        left = np.concatenate([np.zeros(3, np.int64), a[y, :-3]])
        upleft = np.concatenate([np.zeros(3, np.int64), up[:-3]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        raw += bytes([kind]) + ((a[y] - pred) % 256).astype(np.uint8).tobytes()

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


def test_read_png_equals_pil(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(5)
    px = rng.integers(0, 256, (23, 17, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:23, 0:17]
    smooth = np.stack([yy * 11, xx * 13, yy * xx], -1).astype(np.uint8)
    cases = {"filters": None,
             "rgb": Image.fromarray(px), "smooth": Image.fromarray(smooth),
             "rgba": Image.fromarray(np.concatenate([smooth, px[..., :1]], -1), "RGBA"),
             "gray": Image.fromarray(smooth[..., 0]),
             "gray_alpha": Image.fromarray(smooth[..., :2], "LA"),
             "palette": Image.fromarray(smooth).convert("P", palette=Image.ADAPTIVE, colors=40)}
    for name, img in cases.items():
        path = tmp_path / f"{name}.png"
        if img is None:
            _filtered_png(path, px, [0, 1, 2, 3, 4])
        else:
            img.save(path)
        want = np.asarray(Image.open(path).convert("RGB"))
        np.testing.assert_array_equal(read_png(path), want, err_msg=name)
    np.testing.assert_array_equal(read_png(tmp_path / "filters.png"), px)


def test_images_without_pil(tmp_path, monkeypatch):
    """Without PIL a PNG of the resolution reads, and a JPEG, or a PNG
    below the resolution, raises naming the file; neither is skipped."""
    px = np.random.default_rng(1).integers(0, 256, (20, 18, 3)).astype(np.uint8)
    write_png(tmp_path / "a.png", px)
    monkeypatch.setitem(sys.modules, "PIL", None)
    imgs = train_vqgan.load_images(str(tmp_path), 16)
    np.testing.assert_array_equal(imgs[0], px.astype(np.float32) / 127.5 - 1.0)
    with pytest.raises(ImportError, match="a.png.*PIL"):
        train_vqgan.load_images(str(tmp_path), 19)
    (tmp_path / "b.jpg").write_bytes(b"\xff\xd8\xff\xe0 not read")
    with pytest.raises(ImportError, match="b.jpg.*PIL"):
        train_vqgan.load_images(str(tmp_path), 16)


def test_small_image_upsized_as_jax(tmp_path):
    """An image below the resolution is upsized by PIL's default resize, as
    the JAX app's reader does."""
    from PIL import Image

    from lwm_tpu.apps.train_vqgan import load_images as jax_load

    px = np.random.default_rng(2).integers(0, 256, (12, 9, 3)).astype(np.uint8)
    Image.fromarray(px).save(tmp_path / "s.png")
    Image.fromarray(px).save(tmp_path / "t.jpg")
    got, want = train_vqgan.load_images(str(tmp_path), 16), jax_load(str(tmp_path), 16)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert min(got[0].shape[:2]) >= 16


def test_main_refuses_the_card_without_cuda(images, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device=cpu"):
        train_vqgan.main(["--image_dir", str(images), "--output", str(tmp_path / "x.pkl"),
                          *ARGV])
