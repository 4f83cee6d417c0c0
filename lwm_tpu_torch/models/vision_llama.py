"""VideoLLaMA (the multimodal LWM) in PyTorch: the text LLaMA plus a vision
token embedding (`vte`), a `vision_head` beside the `lm_head`, and the
embedding mix by vision masks.

Counterpart of `lwm_tpu/models/vision_llama.py:54-280`. Everything below the
embedding and above the final norm is the port's `LLaMAForCausalLM`: its
blocks, caches, shared-prefix block and kernels; this module supplies the
two hooks, `_embed` and `_head`.

- The vision vocabulary is 8448: 8192 VQ codes and 256 specials, EOF 8192
  closing each frame and EOV 8193 the last (`EOF`, `EOV`).
- A forward of several tokens embeds text rows through `wte` and vision
  rows (`vision_masks` True) through `vte`, each lookup on ids zeroed where
  the other table reads, and mixes them with the mask as fp32
  (`:131-145`): JAX promotes bf16 × f32 to f32, so a multi-token forward
  carries an fp32 residual stream into the blocks, every token text or
  not. A single token embeds through the table of `sample_mode` ("text":
  `wte`, "vision": `vte`) in the model dtype; "all" refuses it.
  `vision_masks=None` reads as all text (the JAX server's `_mk_apply`
  passes zeros).
- `sample_mode` picks the logits (`:203-280`): "text" the `lm_head`'s,
  "vision" the `vision_head`'s, "all" the pair `VideoLLaMADualOutput`
  (vision, lm). Only the head returned is computed. A tied head
  (`tie_vision_embeddings`, `tie_word_embeddings`) is its embedding's
  product.

Training (`lwm_tpu/train.py:273-296`): a forward without a cache under
autograd returns `sample_mode="all"`'s pair for the dual loss
(`utils.losses.dual_cross_entropy`), its blocks rematerialized as the text
model's; `init_weights` draws `vte` and `vision_head` N(0,
initializer_range) as the JAX init does; `--freeze_base` trains only the
two (`LLaMAConfig.get_frozen_param_exclusions`).

Not in this slice: the classifier-free-guidance sampler (`:443-594`, it
needs the VQGAN decoder).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn.functional as F

from lwm_tpu_torch.models.llama import Embed, LLaMAConfig, LLaMAForCausalLM, _dense_cls

EOF, EOV = 8192, 8193   # the frame and video ends among the vision specials
SAMPLE_MODES = ("all", "text", "vision")


@dataclass
class VideoLLaMAConfig(LLaMAConfig):
    """`lwm_tpu/models/vision_llama.py:64-94`: the text config plus the vision
    vocabulary, its tie and `sample_mode`; the same presets (`load_config`)."""

    vision_vocab_size: int = 8448
    tie_vision_embeddings: bool = False
    sample_mode: str = "all"

    def __post_init__(self):
        super().__post_init__()
        if self.sample_mode not in SAMPLE_MODES:
            raise ValueError(f"invalid sample_mode: {self.sample_mode}")


class VideoLLaMADualOutput(NamedTuple):
    """The logits of `sample_mode="all"`: (vision, lm)."""

    vision_logits: torch.Tensor
    lm_logits: torch.Tensor


class VideoLLaMAForCausalLM(LLaMAForCausalLM):
    """`FlaxVideoLLaMAForCausalLMModule` (`lwm_tpu/models/vision_llama.py:
    185-280`) on the port's text model; arguments as `LLaMAForCausalLM`."""

    takes_vision_masks = True

    def __init__(self, config, *, dtype=torch.float32, param_dtype=None, device="cuda"):
        super().__init__(config, dtype=dtype, param_dtype=param_dtype, device=device)
        kw = dict(dtype=dtype, param_dtype=param_dtype or dtype, device=device)
        self.vte = Embed(config.vision_vocab_size, config.hidden_size, **kw)
        self.vision_head = (
            None if config.tie_vision_embeddings
            else _dense_cls(config, "vision_head")(config.hidden_size,
                                                   config.vision_vocab_size, **kw)
        )

    def _embed(self, input_ids, vision_masks):
        if input_ids.shape[1] == 1:
            mode = self.config.sample_mode
            if mode == "text":
                return self.wte(input_ids)
            if mode == "vision":
                return self.vte(input_ids)
            raise ValueError(f"single-token decode requires sample_mode text|vision, got {mode}")
        if vision_masks is None:
            vision_masks = torch.zeros(input_ids.shape, dtype=torch.bool, device=input_ids.device)
        vm = vision_masks.to(device=input_ids.device, dtype=torch.bool)
        text = self.wte(torch.where(vm, 0, input_ids))
        vision = self.vte(torch.where(vm, input_ids, 0))
        m = vm[..., None].float()
        return text * (1 - m) + vision * m

    def _vision_logits(self, x):
        if self.vision_head is None:
            return F.linear(x, self.vte.weight.to(self.dtype))
        return self.vision_head(x)

    def _head(self, x):
        mode = self.config.sample_mode
        if mode == "text":
            return super()._head(x)
        if mode == "vision":
            return self._vision_logits(x)
        return VideoLLaMADualOutput(self._vision_logits(x), super()._head(x))
