"""Image and video question answering on the port (the reference's
lwm/vision_chat.py).

Counterpart of `lwm_tpu/apps/vision_chat.py`, with its flags and defaults,
parsed by `utils/flags.py` (`--llama.<field>` and `--jax_distributed.*` as
in the JAX flag tree), plus `--device` (the card by default; "cpu" for the
CPU; without CUDA the default raises). The image or video
(`--input_file`, up to `--max_n_frames` frames sampled evenly) is read
and center-cropped to 256 x 256 (`utils.image.read_frames`: PIL, and
OpenCV for a video, imported only then; where they are not installed,
as on the card's machine, `--input_file` raises ImportError), then encoded
by the port's VQGAN (`--vqgan_checkpoint`): each frame's 256 codes and
EOF, EOV after the last. A prompt dict may carry those decoded `frames`
in place of its `input_path`.

The prompt (`Sampler.construct_input`, `:167-204`) is the text
"<s>You are a helpful assistant. USER: {question}\\n", then "<vision>", the
codes (vision-masked), "</vision>" and " ASSISTANT:", each part encoded
apart with the tokenizer's special tokens, as the JAX app encodes them (so
with a LLaMA tokenizer each part carries its own bos), left-padded to a
multiple of `block_size` = max(scan chunks) at least max_n_frames x 257 +
256 long. `generation.generate` samples `block_size` new tokens at
`--temperature` with transformers' default top-k 50 (the JAX app's
`GenerationConfig(do_sample=True)`; `Sampler.top_k` changes it), the
prompt's vision masks read by the prefill alone; the answer is decoded
without special tokens and cut at the eos text. The model runs in the
config's `sample_mode` (the bundle's 'text': each new token embeds through
`wte`).

`--seed` seeds the port's generator: sampled tokens agree with the JAX
app's only where the draw is forced (top-k 1). A `--mesh_dim` of more than
one device and `--jax_distributed.initialize_jax_distributed` raise: the
port runs on one device (ROADMAP A4).

Run: python -m lwm_tpu_torch.apps.vision_chat --prompt='What is happening?' \\
    --input_file=video.mp4 --vqgan_checkpoint=vqgan.pkl --load_llama_config=7b \\
    --update_llama_config="dict(sample_mode='text',theta=50000000)" \\
    --tokenizer=LOCAL_DIR --load_checkpoint='params::...'
(`scripts/run_vision_chat_torch.sh` is the bundle.)
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from lwm_tpu_torch.apps.sampler import load_model, resolve_model_config
from lwm_tpu_torch.generation import GenerationConfig, generate
from lwm_tpu_torch.models.vision_llama import (
    VideoLLaMAConfig,
    VideoLLaMAForCausalLM,
    frame_tokens,
)
from lwm_tpu_torch.models.vqgan import VQGAN
from lwm_tpu_torch.train import check_single_device_mesh
from lwm_tpu_torch.utils.flags import parse_flags, placeholder
from lwm_tpu_torch.utils.image import read_frames
from lwm_tpu_torch.utils.rng import set_random_seed
from lwm_tpu_torch.utils.tokenizer import Tokenizer

DEFAULTS = dict(
    prompt="", input_file="", vqgan_checkpoint="", temperature=0.2, max_n_frames=8,
    seed=1234, mesh_dim="1,-1,1,1", dtype="fp32", load_llama_config="",
    update_llama_config="", load_checkpoint="", tokenizer="LargeWorldModel/LWM-Text-1M",
    jax_distributed=dict(initialize_jax_distributed=False, coordinator_address=placeholder(str),
                         num_processes=placeholder(int), process_id=placeholder(int),
                         local_device_ids=placeholder(str)),
    device="cuda",
)


class Sampler:
    """`lwm_tpu/apps/vision_chat.py:Sampler` on the port: `Sampler(flags)`
    loads the model, tokenizer and VQGAN; `from_model` wraps built ones."""

    n_tokens_per_frame = 257
    min_buffer_size = 256
    top_k = 50   # transformers' GenerationConfig default, which the JAX app keeps

    def __init__(self, flags):
        check_single_device_mesh(flags.mesh_dim)
        device = torch.device(flags.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass --device=cpu to run on the CPU")
        vqgan = VQGAN(flags.vqgan_checkpoint, replicate=False, device=device)
        tokenizer = Tokenizer(flags.tokenizer)
        config = resolve_model_config(flags, tokenizer, VideoLLaMAConfig)
        model, _ = load_model(config, flags.load_checkpoint, flags.dtype, device,
                              model_cls=VideoLLaMAForCausalLM)
        self._setup(model, tokenizer, vqgan, flags.temperature, flags.seed)

    @classmethod
    def from_model(cls, model, tokenizer, vqgan, temperature=0.2, seed=1234):
        self = cls.__new__(cls)
        self._setup(model, tokenizer, vqgan, temperature, seed)
        return self

    def _setup(self, model, tokenizer, vqgan, temperature, seed):
        self.model, self.tokenizer, self.vqgan = model, tokenizer, vqgan
        self.config, self.temperature = model.config, temperature
        self.device = model.wte.weight.device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    @property
    def block_size(self):
        return max(self.config.scan_query_chunk_size, self.config.scan_key_chunk_size)

    def encode_frames(self, frames):
        """Decoded frames [t, 256, 256, 3] in [-1, 1] → the vision tokens."""
        return frame_tokens(self.vqgan.encode(frames)[1].cpu().numpy())

    def _encode_vision(self, prompt, max_n_frames):
        frames = prompt.get("frames")
        if frames is None:
            frames = read_frames(prompt["input_path"], max_n_frames)
        return self.encode_frames(frames)

    def construct_input(self, prompts, max_n_frames):
        """(input_ids, vision_masks, attention_mask) numpy [len(prompts), n]
        left-padded to a block_size multiple (`:167-204`)."""
        max_input_length = max_n_frames * self.n_tokens_per_frame + self.min_buffer_size
        max_input_length = int(math.ceil(max_input_length / self.block_size) * self.block_size)
        vision_start = self.tokenizer.encode("<vision>")
        vision_end = self.tokenizer.encode("</vision>")

        input_ids = np.zeros((len(prompts), max_input_length), dtype=int)
        vision_masks = np.zeros((len(prompts), max_input_length), dtype=bool)
        attention_mask = np.zeros((len(prompts), max_input_length), dtype=int)
        for i, prompt in enumerate(prompts):
            vision = self._encode_vision(prompt, max_n_frames)
            head = self.tokenizer.encode(
                f"<s>You are a helpful assistant. USER: {prompt['question']}\n")
            tail = self.tokenizer.encode(" ASSISTANT:")
            tokens = head + vision_start + vision + vision_end + tail
            vm = ([False] * (len(head) + len(vision_start)) + [True] * len(vision)
                  + [False] * (len(vision_end) + len(tail)))
            assert len(tokens) < max_input_length, (len(tokens), max_input_length)
            input_ids[i, -len(tokens):] = tokens
            vision_masks[i, -len(tokens):] = vm
            attention_mask[i, -len(tokens):] = 1
        return dict(input_ids=input_ids, vision_masks=vision_masks,
                    attention_mask=attention_mask)

    def generation_config(self):
        """`:217-223`."""
        return GenerationConfig(
            max_new_tokens=self.block_size, pad_token_id=self.tokenizer.pad_token_id,
            eos_token_id=self.tokenizer.eos_token_id, temperature=self.temperature,
            do_sample=True, top_k=self.top_k)

    def generate(self, batch):
        """The new tokens [b, block_size] of `construct_input`'s batch."""
        def on(x):
            return torch.as_tensor(x, device=self.device)

        return generate(self.model, on(batch["input_ids"]).long(),
                        on(batch["attention_mask"]).long(), self.generation_config(),
                        self.generator, vision_masks=on(batch["vision_masks"]))

    def answers(self, output):
        """The new tokens [b, n] as text: decoded without special tokens,
        each cut at the eos text (`:238-250`)."""
        texts = []
        eos = self.tokenizer.eos_token
        for text in self.tokenizer.batch_decode(output.tolist(), skip_special_tokens=True):
            if eos and eos in text:
                text = text.split(eos, maxsplit=1)[0]
            texts.append(text)
        return texts

    def __call__(self, prompts, max_n_frames):
        return self.answers(self.generate(self.construct_input(prompts, max_n_frames)))


def main(argv=None):
    flags = parse_flags(DEFAULTS, sys.argv[1:] if argv is None else argv,
                        prog="python -m lwm_tpu_torch.apps.vision_chat", free=("llama",))
    if not flags.prompt or not flags.input_file:
        raise ValueError("--prompt and --input_file are required")
    check_single_device_mesh(flags.mesh_dim)
    if flags.jax_distributed["initialize_jax_distributed"]:
        raise NotImplementedError("multi-process vision chat comes with the multi-GPU module "
                                  "(ROADMAP A4)")
    set_random_seed(flags.seed)
    prompts = [{"input_path": flags.input_file, "question": flags.prompt}]
    sampler = Sampler(flags)
    output = sampler(prompts, flags.max_n_frames)[0]
    print(f"Question: {flags.prompt}\nAnswer: {output}")


if __name__ == "__main__":
    main()
