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
model's; on a mesh `vte` is split over fsdp × sp and kept whole over tp
as `wte` is, the `vision_head` split over tp by vocab (its logits
gathered) and over fsdp × sp, as `lwm_tpu/models/vision_llama.py:80-86`
shards them; `init_weights` draws `vte` and `vision_head` N(0,
initializer_range) as the JAX init does; `--freeze_base` trains only the
two (`LLaMAConfig.get_frozen_param_exclusions`).

Generation (`:409-594`): `prepare_inputs_for_generation` also carries the
prompt's vision masks, which the prompt's forward reads; the one-token
steps embed through `sample_mode`'s table. `generate_vision` is the
classifier-free-guidance sampler of `_sample_vision`/`generate_vision`
(`:443-594`), on the shared-index cache of `generation.generate`: its
prefill reaches K1 (`ops.flash`, the fp32 route at fp32) and every step K4
(`ops.decode`, its fp32 instance at fp32).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from lwm_tpu_torch.generation import GenerationConfig, warp_logits
from lwm_tpu_torch.models.llama import Embed, LLaMAConfig, LLaMAForCausalLM, _dense_cls
from lwm_tpu_torch.parallel.fsdp import full_weight
from lwm_tpu_torch.parallel.mesh import gather_tp, tp_enter

EOF, EOV = 8192, 8193   # the frame and video ends among the vision specials
TOKENS_PER_FRAME = 257  # 256 VQ codes and the EOF that closes the frame
SAMPLE_MODES = ("all", "text", "vision")


def frame_tokens(frames):
    """Frames of VQ codes (each any shape, e.g. [16, 16]) → the token stream:
    each frame's codes then EOF, EOV after the last frame."""
    tokens = []
    for t, codes in enumerate(frames):
        tokens.extend(np.asarray(codes).reshape(-1).tolist())
        tokens.append(EOV if t == len(frames) - 1 else EOF)
    return tokens


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

    def __init__(self, config, *, dtype=torch.float32, param_dtype=None, device="cuda",
                 mesh=None):
        super().__init__(config, dtype=dtype, param_dtype=param_dtype, device=device, mesh=mesh)
        kw = dict(dtype=dtype, param_dtype=param_dtype or dtype, device=device)
        tp = 1 if mesh is None else mesh.tp
        self.vte = Embed(config.vision_vocab_size, config.hidden_size, **kw)
        self.vision_head = (
            None if config.tie_vision_embeddings
            else _dense_cls(config, "vision_head")(config.hidden_size,
                                                   config.vision_vocab_size // tp, **kw)
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
            return F.linear(x, full_weight(self.vte).to(self.dtype))
        mesh = self._mesh
        return gather_tp(self.vision_head(tp_enter(x, mesh)), mesh)

    def _head(self, x):
        mode = self.config.sample_mode
        if mode == "text":
            return super()._head(x)
        if mode == "vision":
            return self._vision_logits(x)
        return VideoLLaMADualOutput(self._vision_logits(x), super()._head(x))

    def prepare_inputs_for_generation(self, input_ids, max_length, attention_mask=None,
                                      vision_masks=None):
        """The text model's (`LLaMAForCausalLM.prepare_inputs_for_generation`)
        plus the prompt's `vision_masks` [b, s] (`:409-433`)."""
        kwargs = super().prepare_inputs_for_generation(input_ids, max_length, attention_mask)
        kwargs["vision_masks"] = vision_masks
        return kwargs

    @torch.no_grad()
    def generate_vision(self, input_ids, cfg_scales, attention_mask=None, vision_masks=None,
                        config=None, generator=None):
        """Sampling with classifier-free guidance (`:443-594`). input_ids
        [2b, s] stacks the cond rows over the uncond ones (left-padded,
        `attention_mask` [2b, s], 1 = real; `vision_masks` [2b, s] marks
        vision tokens), cfg_scales [b] (or a number) the guidance of each
        cond row. Returns the sequences [2b, s + config.max_new_tokens]:
        the prompt, then the new tokens, `pad_token_id` after an early end.

        A step mixes the last logits as uncond + cfg·(cond − uncond) over
        the cond rows, runs the warpers (`generation.warp_logits`), and
        draws one token a cond row from `generator`; the 257k-th new token
        is EOF (a frame's end), and the same token goes to the row's cond
        and uncond halves. The first token comes from the prefill. A row
        is finished at `eos_token_id` (the config's, else the model
        config's, as JAX falls back to the model's generation config), and
        the loop stops at max_length or when every row has finished.
        `sample_mode` must be "vision" for the steps to embed VQ codes.

        The JAX run's logits processors (transformers 4.57.6's Flax
        `_get_logits_processor`, `flax_utils.py:499-552`, from the app's
        config) change nothing: without an eos id in the generation config
        (the app's) the list is empty, and with one it holds a min-length
        processor at min_length 0, which only acts while the length is
        below it; so none is applied here."""
        config = config or GenerationConfig(do_sample=True)
        if not (config.do_sample and config.num_beams == 1):
            raise NotImplementedError(
                "generate_vision supports sampling (do_sample=True, num_beams=1)")
        eos = config.eos_token_id if config.eos_token_id is not None else self.config.eos_token_id
        pad = config.pad_token_id
        if pad is None:
            pad = config.eos_token_id   # `:566-570`: the config's eos, not the model's
        if pad is None:
            raise ValueError("generate_vision needs a pad_token_id")
        pairs, s = input_ids.shape
        if pairs % 2:
            raise ValueError(f"{pairs} rows: the batch stacks cond over uncond rows")
        dev = input_ids.device
        cfg = torch.as_tensor(cfg_scales, dtype=torch.float32, device=dev).reshape(-1)
        cfg = cfg.expand(pairs // 2)
        max_length = s + config.max_new_tokens
        seq = torch.full((pairs, max_length), pad, dtype=torch.long, device=dev)
        seq[:, :s] = input_ids
        kw = self.prepare_inputs_for_generation(input_ids, max_length, attention_mask,
                                                vision_masks)
        logits = self(input_ids, kw["attention_mask"], kw["position_ids"], kw["cache"],
                      vision_masks=kw["vision_masks"], logits_tail=1)[:, -1]
        finished = torch.zeros(pairs, dtype=torch.bool, device=dev)
        for pos in range(s, max_length):
            if pos > s:
                kw = self.update_inputs_for_generation(kw)
                logits = self(token[:, None], kw["attention_mask"], kw["position_ids"],
                              kw["cache"])[:, -1]
            cond, uncond = logits.chunk(2)
            # as JAX promotes: cond − uncond in the logits' dtype, the mix fp32
            guided = uncond.float() + cfg[:, None] * (cond - uncond).float()
            guided = warp_logits(guided, config)
            sampled = torch.multinomial(torch.softmax(guided, -1), 1, generator=generator)[:, 0]
            if (pos - s + 1) % TOKENS_PER_FRAME == 0:
                sampled = torch.full_like(sampled, EOF)
            token = sampled.repeat(2)
            seq[:, pos] = token
            if eos is not None:
                finished |= token == eos
                if bool(finished.all()):
                    break
        return seq
