"""Train a small VQ image tokenizer on a directory of images, and report
its held-out round trip.

Counterpart of `lwm_tpu/apps/train_vqgan.py`, with its flags, defaults and
printed lines: the VQ-VAE objective ‖x − x̂‖² + ‖sg(z) − e‖² + β·‖z −
sg(e)‖² (no GAN or perceptual term) on `models.vqgan.VQGANModel.
train_forward` over random crops, with dead-code revival (every
`--revive_every` steps the codes no step of that span used are set to
random encoder outputs of the last batch), saved as the released pickle
layout (`utils.convert.save_vqgan_pickle`), then `--eval_crops` held-out
crops through the `VQGAN` wrapper: PSNR and codebook usage.

What the port keeps of the JAX run:
- one `np.random.RandomState(--seed)` draws, in order, each crop's image
  index, y and x, and after a revival step the rows of the last batch's z
  (recomputed with the updated params) that the dead codes take; the
  held-out crops come from `RandomState(--seed + 1)`;
- the optimizer is `optax.adamw(lr, weight_decay=1e-5)`: a constant lr, no
  clipping, b1 0.9, b2 0.999, eps 1e-8, every parameter decayed (the
  codebook too), the bias correction in fp32 (`optim.AdamW` with a constant
  schedule and an infinite clip);
- the whole step (forward, loss, backward, optimizer) runs at fp32 with
  TF32 off (`models.vqgan.full_fp32`): cuDNN would otherwise take the
  convolutions' backward as TF32 on the card.
The weights start from `VQGANModel.init_weights` with a `torch.Generator`
seeded by `--seed` (not JAX's draws); `main(argv, state_dict=...)` starts
from given weights instead, e.g. JAX's initial params through
`utils.convert.vqgan_params_from_flax`. The run is on the card; `--device
cpu` runs it on the CPU (without CUDA the default raises).

Images: a `.png` is read by `utils.image.read_png` (no PIL needed; PNG is
lossless, so the pixels are PIL's); a JPEG, BMP or WebP, and any image
smaller than `--resolution` on a side (upsized as the JAX app does, by
PIL's default resize), need PIL, and without it raise naming the file.

Run: python -m lwm_tpu_torch.apps.train_vqgan --image_dir=... \\
    --output=params.pkl --resolution=64 --steps=2000
"""

from __future__ import annotations

import argparse
import glob
import math
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from lwm_tpu_torch.models.vqgan import VQGAN, VQGANConfig, VQGANModel, full_fp32
from lwm_tpu_torch.optim import AdamW
from lwm_tpu_torch.utils.convert import save_vqgan_pickle
from lwm_tpu_torch.utils.image import read_png

EXTENSIONS = ("png", "jpg", "jpeg", "bmp", "webp")
WEIGHT_DECAY = 1e-5                 # optax.adamw's weight_decay in the JAX app
ADAM_B1, ADAM_B2 = 0.9, 0.999       # optax.adamw's defaults


def _pil(path):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: reading this image needs PIL, which is not installed "
                          "(PNG files of at least --resolution pixels a side are read "
                          "without it)") from e
    return Image


def read_image(path, resolution):
    """One image as float32 [H, W, 3] in [-1, 1], upsized (PIL's default
    resize) when its short side is below `resolution` (`:38-56`)."""
    pixels = read_png(path) if path.lower().endswith(".png") else None
    if pixels is None or min(pixels.shape[:2]) < resolution:
        Image = _pil(path)
        im = Image.fromarray(pixels) if pixels is not None else Image.open(path).convert("RGB")
        if min(im.size) < resolution:
            scale = resolution / min(im.size)
            im = im.resize((int(im.width * scale + 1), int(im.height * scale + 1)))
        pixels = np.asarray(im)
    return np.asarray(pixels, np.float32) / 127.5 - 1.0


def load_images(image_dir, resolution):
    paths = sorted(p for ext in EXTENSIONS
                   for p in glob.glob(os.path.join(image_dir, f"*.{ext}")))
    if not paths:
        raise FileNotFoundError(f"no images under {image_dir}")
    return [read_image(p, resolution) for p in paths]


def crop_batch(imgs, rng, batch, resolution):
    out = np.empty((batch, resolution, resolution, 3), np.float32)
    for i in range(batch):
        im = imgs[rng.randint(len(imgs))]
        y = rng.randint(im.shape[0] - resolution + 1)
        x = rng.randint(im.shape[1] - resolution + 1)
        out[i] = im[y:y + resolution, x:x + resolution]
    return out


def psnr(a, b):
    mse = float(np.mean((a - b) ** 2))  # inputs in [-1, 1] → peak 2.0
    return 10.0 * np.log10(4.0 / max(mse, 1e-12))


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m lwm_tpu_torch.apps.train_vqgan")
    p.add_argument("--image_dir", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--resolution", type=int, default=64)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--beta", type=float, default=0.25)
    p.add_argument("--hidden_channels", type=int, default=64)
    p.add_argument("--channel_mult", type=str, default="1,2,4")
    p.add_argument("--num_res_blocks", type=int, default=2)
    p.add_argument("--z_channels", type=int, default=32)
    p.add_argument("--num_embeddings", type=int, default=512)
    p.add_argument("--revive_every", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval_crops", type=int, default=64)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def config_updates(args):
    return dict(
        resolution=args.resolution,
        hidden_channels=args.hidden_channels,
        channel_mult=tuple(int(x) for x in args.channel_mult.split(",")),
        num_res_blocks=args.num_res_blocks,
        z_channels=args.z_channels,
        num_embeddings=args.num_embeddings,
        quantized_embed_dim=args.z_channels,
    )


def objective(model, x, beta):
    """(loss, reconstruction loss, codes) of the VQ-VAE objective on x."""
    recon, z, z_q_raw, idx = model.train_forward(x)
    l_rec = F.mse_loss(recon, x)
    l_code = F.mse_loss(z.detach(), z_q_raw)
    l_commit = F.mse_loss(z, z_q_raw.detach())
    return l_rec + l_code + beta * l_commit, l_rec, idx


def train(model, imgs, args, rng, record=None):
    """`args.steps` steps on crops drawn from `rng` (see the module note).
    `record(step, info)`, when given, sees each step after its backward
    (`info`: its loss, reconstruction loss and codes, and the model, whose
    grads are the step's until the update), and each revival
    (`info["revived"]`: the rows set, none when every code was used, and
    their new values)."""
    device = model.quantize.embeddings.device
    lr = args.lr
    opt = AdamW(model.named_parameters(), learning_rate_schedule=lambda count: lr,
                b1=ADAM_B1, b2=ADAM_B2, weight_decay=WEIGHT_DECAY, clip_gradient=math.inf)
    usage = torch.zeros(args.num_embeddings, dtype=torch.long, device=device)
    t0 = time.time()
    for i in range(args.steps):
        x = torch.from_numpy(crop_batch(imgs, rng, args.batch, args.resolution)).to(device)
        with full_fp32():
            model.zero_grad(set_to_none=True)
            loss, l_rec, idx = objective(model, x, args.beta)
            loss.backward()
            if record is not None:
                record(i + 1, dict(loss=loss.item(), rec=l_rec.item(), codes=idx.cpu().numpy(),
                                   model=model))
            opt.step()
        usage += torch.bincount(idx.reshape(-1), minlength=args.num_embeddings)
        if (i + 1) % args.revive_every == 0:
            # dead-code revival: the unused codes take random encoder outputs
            dead = torch.nonzero(usage == 0)[:, 0].cpu().numpy()
            values = np.zeros((0, args.z_channels), np.float32)
            if dead.size:
                with torch.no_grad():
                    z = model.train_forward(x)[1]
                flat = z.reshape(-1, z.shape[-1])
                rows = torch.from_numpy(rng.randint(len(flat), size=dead.size)).to(device)
                with torch.no_grad():
                    model.quantize.embeddings[torch.from_numpy(dead).to(device)] = flat[rows]
                values = flat[rows].cpu().numpy()
            if record is not None:
                record(i + 1, dict(revived=(dead, values)))
            usage.zero_()
        if (i + 1) % 100 == 0:
            print(f"step {i+1}: loss {loss.item():.4f} rec {l_rec.item():.4f} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)", file=sys.stderr, flush=True)


def round_trip(vq, imgs, args):
    """(PSNR, distinct codes) of `--eval_crops` held-out crops through the
    wrapper, and the line the JAX app prints."""
    x = crop_batch(imgs, np.random.RandomState(args.seed + 1), args.eval_crops, args.resolution)
    codes = vq.encode(x)[1].cpu().numpy()
    recon = vq.decode(codes).cpu().numpy()
    score, uniq = psnr(x, recon), len(np.unique(codes))
    return score, uniq, (f"round-trip: PSNR {score:.2f} dB on {args.eval_crops} held-out "
                         f"{args.resolution}px crops; codebook usage "
                         f"{uniq}/{args.num_embeddings} codes")


def main(argv=None, state_dict=None, record=None):
    """The CLI; `state_dict` (VQGANModel's) replaces the seeded init,
    `record` is `train`'s."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass --device=cpu to train on the CPU")
    cfg = VQGANConfig.get_default_config(config_updates(args))
    model = VQGANModel(cfg, device=device)
    if state_dict is None:
        model.init_weights(torch.Generator(device=device).manual_seed(args.seed))
    else:
        model.load_state_dict(state_dict)
    rng = np.random.RandomState(args.seed)
    imgs = load_images(args.image_dir, args.resolution)
    print(f"{len(imgs)} images; training {args.steps} steps "
          f"at {args.resolution}px", file=sys.stderr, flush=True)
    train(model, imgs, args, rng, record)

    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    save_vqgan_pickle(model.state_dict(), args.output)   # the released pickle layout
    print(f"saved {args.output}", file=sys.stderr, flush=True)
    del model

    # the held-out round trip through the wrapper (the released-artifact path)
    vq = VQGAN(args.output, config_updates=config_updates(args), device=device)
    print(round_trip(vq, imgs, args)[2])


if __name__ == "__main__":
    main()
