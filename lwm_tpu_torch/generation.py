"""Batched generation over a left-padded prompt batch: the port's
`GenerationConfig` and decoding loop.

Counterpart of `FlaxLLaMAForCausalLM.generate` (`lwm_tpu/models/llama.py:
1814-1839`), whose loop is transformers' `FlaxGenerationMixin` (4.57.6:
`generate` `flax_utils.py:270`, `_greedy_search` `:575-650`, `_sample`
`:661-745`, `_get_logits_warper` `:483-497`); the port imports neither
transformers nor flax, so it keeps its own copy of those semantics:

- the prompt (left-padded, with its attention mask) is prefilled once into
  a shared-index cache of `round_cache_length(prompt + max_new_tokens)`
  slots (`model.prepare_inputs_for_generation`); the first new token comes
  from the prefill's last logits, each later one from a one-token step
  (`model.update_inputs_for_generation`). A VideoLLaMA's prompt may carry
  `vision_masks`: the prefill reads them, and the one-token steps embed by
  the model's `sample_mode`, as the JAX model keeps the masks for the
  prompt alone (`lwm_tpu/models/vision_llama.py:139-149, 409-441`);
- greedy (`do_sample` False) takes the argmax (the first of equal logits);
  sampling applies the warpers in transformers' order: temperature when it
  is not 1.0, top-k when it is not 0, top-p when it is below 1.0, then
  draws from the softmax with an explicit `torch.Generator`;
- a row that has emitted `eos_token_id` is finished and emits
  `pad_token_id` from then on; the loop stops after `max_new_tokens` tokens
  or when every row has finished. The result is the new tokens
  [b, max_new_tokens], `pad_token_id` past a row's end.

On a mesh (the model's `mesh`, inference on dp × fsdp × tp × sp) the rows
are this rank's batch shard; the ranks that compute them (the "model"
group, tp × sp) take each token as its first rank picks it.

Beam search (`num_beams` > 1) raises: no caller of the JAX package asks for
it. The same seed draws other numbers than JAX's PRNG, so sampled tokens
agree with JAX only where the draw is forced (top_k 1). Generic over the
model: anything with `prepare_inputs_for_generation`,
`update_inputs_for_generation` and a forward taking (input_ids,
attention_mask, position_ids, cache, logits_tail) — `LLaMAForCausalLM` and
its subclasses.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from lwm_tpu_torch.parallel.mesh import mesh_of


@dataclass
class GenerationConfig:
    """The fields of transformers' `GenerationConfig` that the JAX callers
    set (`lwm_tpu/apps/sampler.py:74-83`), with its defaults."""

    max_new_tokens: int = 20
    pad_token_id: Optional[int] = None
    eos_token_id: Optional[int] = None
    temperature: float = 1.0
    do_sample: bool = False
    num_beams: int = 1
    top_k: int = 50
    top_p: float = 1.0


def warp_logits(logits, config):
    """transformers' logits warpers in their order (`flax_utils.py:483-497`,
    `flax_logits_process.py:96-192`): logits / temperature, then all but the
    top_k largest set to -inf, then all but the smallest set whose softmax
    mass reaches top_p set to -inf (the first token always kept). logits
    [b, vocab] fp32."""
    if config.temperature is not None and config.temperature != 1.0:
        if not config.temperature > 0:
            raise ValueError(f"temperature {config.temperature} must be > 0 when sampling")
        logits = logits / config.temperature
    if config.top_k is not None and config.top_k != 0:
        k = min(max(int(config.top_k), 1), logits.shape[-1])
        top, idx = torch.topk(logits, k, dim=-1)
        logits = torch.full_like(logits, -float("inf")).scatter(-1, idx, top)
    if config.top_p is not None and config.top_p < 1.0:
        top, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
        keep = torch.softmax(top, -1).cumsum(-1) < config.top_p
        keep = torch.roll(keep, 1, dims=-1)   # the token that crosses top_p stays too
        keep[:, 0] = True
        top = torch.where(keep, top, -float("inf"))
        logits = torch.full_like(logits, -float("inf")).scatter(-1, idx, top)
    return logits


def _next_token(logits, config, generator):
    if not config.do_sample:
        return logits.argmax(-1)
    probs = torch.softmax(warp_logits(logits, config), -1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def prefill(model, input_ids, attention_mask, max_new_tokens, vision_masks=None):
    """The prompt's forward into a fresh shared-index cache: returns (its
    last position's logits [b, vocab] fp32, the model kwargs of the next
    step). `vision_masks` [b, s] (a VideoLLaMA's) marks the prompt's vision
    tokens."""
    length = input_ids.shape[1] + max_new_tokens
    if vision_masks is None:
        kwargs = model.prepare_inputs_for_generation(input_ids, length, attention_mask)
    else:
        kwargs = model.prepare_inputs_for_generation(input_ids, length, attention_mask,
                                                     vision_masks)
    logits = model(input_ids, kwargs["attention_mask"], kwargs["position_ids"],
                   kwargs["cache"], vision_masks=vision_masks, logits_tail=1)
    return logits[:, -1].float(), kwargs


@torch.no_grad()
def generate(model, input_ids, attention_mask=None, config=None, generator=None,
             vision_masks=None):
    """New tokens [b, max_new_tokens] (int64, on input_ids' device) for the
    left-padded prompts input_ids [b, s] with attention_mask [b, s] (1 =
    real token; None: all real) and, for a VideoLLaMA, the prompt's
    vision_masks [b, s], under `config` (a GenerationConfig). See the
    module note."""
    config = config or GenerationConfig()
    if config.num_beams != 1:
        raise NotImplementedError("beam search (num_beams > 1) is not ported: no caller uses it")
    pad = config.pad_token_id
    if pad is None:
        pad = config.eos_token_id   # transformers' fallback (`flax_utils.py:326-333`)
    if pad is None:
        raise ValueError("generate needs a pad_token_id or an eos_token_id")
    b = input_ids.shape[0]
    out = torch.full((b, config.max_new_tokens), pad, dtype=torch.long, device=input_ids.device)
    if config.max_new_tokens <= 0:
        return out
    logits, kwargs = prefill(model, input_ids, attention_mask, config.max_new_tokens,
                             vision_masks)
    mesh = mesh_of(model)
    finished = torch.zeros(b, dtype=torch.bool, device=input_ids.device)
    for i in range(config.max_new_tokens):
        if i:
            kwargs = model.update_inputs_for_generation(kwargs)
            logits = model(token[:, None], kwargs["attention_mask"], kwargs["position_ids"],
                           kwargs["cache"])[:, -1].float()
        token = torch.where(finished, pad, _next_token(logits, config, generator))
        if mesh is not None:   # the model group's first rank picks
            token = mesh.broadcast(token, "model")
        out[:, i] = token
        if config.eos_token_id is not None:
            finished |= token == config.eos_token_id
        if bool(finished.all()):
            break
    return out
