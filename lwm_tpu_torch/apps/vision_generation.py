"""Text to image or video on the port: LWM's classifier-free-guidance
sampler, then VQGAN's decoder.

Counterpart of `lwm_tpu/apps/vision_generation.py`, with its flags and
defaults, parsed by `utils/flags.py` (`--llama.<field>` and
`--jax_distributed.*` as in the JAX flag tree), plus `--device` (the card
by default; "cpu" for the CPU). Two phases:
- the first frame: the image prompt "<s>You are a helpful assistant. USER:
  Generate an image of {prompt} ASSISTANT: <vision>" (the cond row) over
  "<s><vision>" (the uncond row), both left-truncated and left-padded to
  128 tokens, 257 tokens (256 codes and the EOF) sampled with the image
  knobs (`cfg_scale_image`, `top_k_image`, `temperature_image`);
- for a video, the other frames in one call of (n_frames - 1) x 257 tokens
  from the video prompt, the first frame's 257 tokens appended to both rows
  as a vision-masked prefix, with the video knobs.
Sampling is `VideoLLaMAForCausalLM.generate_vision` (the bundles set
`sample_mode='vision'`); the codes decode through `models.vqgan.VQGAN`
(`--vqgan_checkpoint`, the released pickle) to pixels ((x + 1) · 127.5 as
uint8). A `.png` is written by `utils.image.write_png` (no PIL needed), a
`.jpg` through PIL, an `.mp4` (n_frames > 1) by `utils.image.write_video`
(imageio, else OpenCV; checked before anything loads).

`--seed` seeds the port's generators: the sampled tokens are not JAX's PRNG
draws, and agree with JAX only where a draw is forced (top-k 1). A
`mesh_dim` of more than one device and `--jax_distributed.
initialize_jax_distributed` raise: multi-GPU is ROADMAP A4.

Run: python -m lwm_tpu_torch.apps.vision_generation --prompt='...' \\
    --output_file=out.png --load_llama_config=7b \\
    --update_llama_config="dict(sample_mode='vision',theta=50000000)" \\
    --vqgan_checkpoint=vqgan.pkl --tokenizer=LOCAL_DIR \\
    --load_checkpoint='params::...'
(`scripts/run_sample_image_torch.sh` and `run_sample_video_torch.sh` are
the bundles.)
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from lwm_tpu_torch.apps.sampler import load_model, resolve_model_config
from lwm_tpu_torch.generation import GenerationConfig
from lwm_tpu_torch.models.vision_llama import (
    TOKENS_PER_FRAME,
    VideoLLaMAConfig,
    VideoLLaMAForCausalLM,
)
from lwm_tpu_torch.models.vqgan import VQGAN
from lwm_tpu_torch.train import check_single_device_mesh, log
from lwm_tpu_torch.utils.flags import parse_flags, placeholder
from lwm_tpu_torch.utils.image import check_video_writer, write_png, write_video
from lwm_tpu_torch.utils.rng import set_random_seed
from lwm_tpu_torch.utils.tokenizer import Tokenizer

DEFAULTS = dict(
    prompt="Fireworks over the city", output_file="", temperature_image=1.0,
    temperature_video=1.0, top_k_image=8192, top_k_video=100, cfg_scale_image=1.0,
    cfg_scale_video=1.0, vqgan_checkpoint="", n_frames=1, seed=1234, mesh_dim="1,-1,1,1",
    dtype="fp32", load_llama_config="", update_llama_config="", load_checkpoint="",
    tokenizer="LargeWorldModel/LWM-Text-1M",
    jax_distributed=dict(initialize_jax_distributed=False, coordinator_address=placeholder(str),
                         num_processes=placeholder(int), process_id=placeholder(int),
                         local_device_ids=placeholder(str)),
    device="cuda",
)
MAX_INPUT_LENGTH = 128
UNCOND_PROMPT = "<s><vision>"


def image_prompt(prompt):
    return (f"<s>You are a helpful assistant. USER: Generate an image of {prompt} "
            "ASSISTANT: <vision>")


def video_prompt(prompt):
    return (f"<s>You are a helpful assistant. USER: Generate a video of {prompt} "
            "ASSISTANT: <vision>")


def to_uint8(pixels):
    """Decoded pixels in [-1, 1] → uint8 as the JAX app computes them, in
    numpy on the host: ((x + 1) · 127.5) truncated."""
    return ((pixels.float().cpu().numpy() + 1) * 127.5).astype(np.uint8)


class VisionGenerator:
    """The model, tokenizer, generator and VQGAN of one run, and
    `generate_frames` (`vision_generation.py:124-158`)."""

    def __init__(self, model, tokenizer, vqgan, seed):
        self.model, self.tokenizer, self.vqgan = model, tokenizer, vqgan
        self.device = model.wte.weight.device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def batch(self, prompts, vision_prefix=None):
        """(input_ids, attention_mask, vision_masks) [2b, s] of the cond
        prompts over as many uncond rows, with `vision_prefix` (codes [b, n])
        appended to both halves, vision-masked."""
        ids, mask = self.tokenizer.batch_encode(
            list(prompts) + [UNCOND_PROMPT] * len(prompts), MAX_INPUT_LENGTH)
        ids = torch.tensor(ids, dtype=torch.long, device=self.device)
        mask = torch.tensor(mask, dtype=torch.long, device=self.device)
        vm = torch.zeros(ids.shape, dtype=torch.bool, device=self.device)
        if vision_prefix is not None:
            pre = torch.as_tensor(np.asarray(vision_prefix), dtype=torch.long,
                                  device=self.device).repeat(2, 1)
            ids = torch.cat([ids, pre], 1)
            mask = torch.cat([mask, torch.ones_like(pre)], 1)
            vm = torch.cat([vm, torch.ones(pre.shape, dtype=torch.bool, device=self.device)], 1)
        return ids, mask, vm

    def generate_frames(self, prompts, vision_prefix, n_tokens, cfg, top_k, temperature):
        """The cond rows' n_tokens new tokens [b, n_tokens] as numpy."""
        ids, mask, vm = self.batch(prompts, vision_prefix)
        config = GenerationConfig(max_new_tokens=n_tokens,
                                  pad_token_id=self.tokenizer.pad_token_id,
                                  temperature=temperature, do_sample=True, top_k=top_k)
        seq = self.model.generate_vision(ids, cfg, mask, vm, config, self.generator)
        return seq[: len(prompts), ids.shape[1]:].cpu().numpy()

    def decode(self, codes):
        """Codes [.., 16, 16] → uint8 pixels [.., 256, 256, 3]."""
        return to_uint8(self.vqgan.decode(codes))


def load(flags):
    """(VisionGenerator) for the flags: the VideoLLaMA at `--dtype` and the
    VQGAN, both on `--device`."""
    device = torch.device(flags.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass --device=cpu to run on the CPU")
    vqgan = VQGAN(flags.vqgan_checkpoint, replicate=False, device=device)
    tokenizer = Tokenizer(flags.tokenizer)
    config = resolve_model_config(flags, tokenizer, VideoLLaMAConfig)
    model, _ = load_model(config, flags.load_checkpoint, flags.dtype, device,
                          model_cls=VideoLLaMAForCausalLM)
    return VisionGenerator(model, tokenizer, vqgan, flags.seed)


def check_output(flags):
    """The output's extension against n_frames (`:61-67`), and for a video
    an importable writer, before anything loads."""
    if not flags.output_file:
        raise ValueError("--output_file is required")
    if flags.output_file.endswith("mp4"):
        if flags.n_frames <= 1:
            raise ValueError("an .mp4 needs --n_frames > 1")
        check_video_writer()
    elif flags.output_file.endswith(("png", "jpg")):
        if flags.n_frames != 1:
            raise ValueError("an image needs --n_frames=1")
    else:
        raise ValueError(f"unsupported output extension: {flags.output_file}")


def write_image(path, pixels):
    if path.endswith("png"):
        write_png(path, pixels)
    else:
        from PIL import Image

        Image.fromarray(pixels).save(path)


def main(argv=None):
    flags = parse_flags(DEFAULTS, sys.argv[1:] if argv is None else argv,
                        prog="python -m lwm_tpu_torch.apps.vision_generation", free=("llama",))
    check_output(flags)
    check_single_device_mesh(flags.mesh_dim)
    if flags.jax_distributed["initialize_jax_distributed"]:
        raise NotImplementedError("multi-process generation comes with the multi-GPU module "
                                  "(ROADMAP A4)")
    set_random_seed(flags.seed)
    gen = load(flags)

    prompts = [flags.prompt]
    first = gen.generate_frames(
        [image_prompt(p) for p in prompts], None, TOKENS_PER_FRAME,
        flags.cfg_scale_image, flags.top_k_image, flags.temperature_image,
    ).reshape(len(prompts), TOKENS_PER_FRAME)
    if flags.n_frames == 1:
        write_image(flags.output_file, gen.decode(first[:, :-1].reshape(-1, 16, 16))[0])
        log(f"wrote {flags.output_file}")
        print("done")
        return

    rest = gen.generate_frames(
        [video_prompt(p) for p in prompts], first, (flags.n_frames - 1) * TOKENS_PER_FRAME,
        flags.cfg_scale_video, flags.top_k_video, flags.temperature_video,
    ).reshape(len(prompts), flags.n_frames - 1, TOKENS_PER_FRAME)
    frames = np.concatenate([first[:, None], rest], axis=1)
    codes = frames[:, :, :-1].reshape(-1, flags.n_frames, 16, 16)
    for v in codes:
        write_video(flags.output_file, gen.decode(v), fps=4)
    log(f"wrote {flags.output_file}")
    print("done")


if __name__ == "__main__":
    main()
