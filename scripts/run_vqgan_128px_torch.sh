#!/bin/bash
# The VQ tokenizer trained at 128 px with a 1024-code book on one GPU (the
# PyTorch port): scripts/run_vqgan_128px.sh with its flags, on the port's
# lwm_tpu_torch.apps.train_vqgan (4000 steps of batch 16, channels 64 x
# 1,2,2,4, 2 res blocks, z 64; 128 px -> a 16 x 16 latent, 256 codes a
# frame, the released tokenizer's contract), then the held-out round trip
# through the released-pickle load path: PSNR and codebook usage.
#
# IMAGE_DIR (the second argument) is a directory of images. Without one,
# the photographs that installed Python packages ship (matplotlib's, scikit-
# learn's, pygame's) are gathered into WORKDIR/imgs, as the JAX bundle
# does. JPEGs need PIL where this runs; a machine without PIL (or without
# those packages) takes a directory of PNG files of at least 128 px a side,
# which the port reads without PIL.
#
# Usage: bash scripts/run_vqgan_128px_torch.sh [WORKDIR] [IMAGE_DIR]
set -eu
WORK=${1:-/tmp/vq128}
IMAGES=${2:-}
REPO=$(cd "$(dirname "$0")/.." && pwd)
cd "$REPO"
mkdir -p "$WORK"

if [ -z "$IMAGES" ]; then
  IMAGES="$WORK/imgs"
  mkdir -p "$IMAGES"
  python - "$IMAGES" <<'EOF2'
# gather the real photographs shipped inside installed packages
import glob, os, shutil, sys, sysconfig
dst = sys.argv[1]
lib = sysconfig.get_paths()["purelib"]
pats = [
    "matplotlib/mpl-data/sample_data/grace_hopper.jpg",
    "sklearn/datasets/images/*.jpg",
    "pygame/docs/generated/_images/camera_*.jpg",
    "pygame/docs/generated/_images/intro_*.jpg",
]
n = 0
for pat in pats:
    for p in glob.glob(os.path.join(lib, pat)):
        shutil.copy(p, os.path.join(dst, os.path.basename(p)))
        n += 1
print(f"{n} photos -> {dst}")
assert n >= 6, "photo gathering failed: pass a directory of images as IMAGE_DIR"
EOF2
fi

python -m lwm_tpu_torch.apps.train_vqgan \
  --image_dir "$IMAGES" --output "$WORK/vqgan128.pkl" \
  --resolution 128 --steps 4000 --batch 16 \
  --hidden_channels 64 --channel_mult 1,2,2,4 --num_res_blocks 2 \
  --z_channels 64 --num_embeddings 1024 \
  --eval_crops 64 2>&1 | tee "$WORK/train.log"
grep -E "PSNR|usage|psnr" "$WORK/train.log" | tail -5
