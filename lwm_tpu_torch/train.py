"""The single-device train step of the text model (`lwm_tpu/train.py:95-121`,
`:216-313`), as library pieces.

    config = build_model_config("7b", update_llama_config=dict(num_hidden_layers=2))
    model = LLaMAForCausalLM(config, dtype=torch.bfloat16, param_dtype=torch.float32,
                             device="cuda")
    state = create_train_state(model, {"adamw_optimizer": {"lr": 8e-5}})
    metrics = train_step(state, {"input_tokens": ..., "target_tokens": ...,
                                 "loss_masks": ...})

The JAX step keeps fp32 params and computes in the `--dtype` (bf16 in
`scripts/run_train_text.sh`); here that is the model's `param_dtype` and
`dtype`. The loss is `cross_entropy_loss_and_accuracy` over full logits
(the default `fused_lm_loss=False`), the optimizer `optim.OptimizerFactory`
with every parameter decayed (the text model's weight-decay exclusions are
empty, `lwm_tpu/models/llama.py:279-280`), and the metrics carry the JAX
step's names. Not ported yet: the CLI (`lwm_tpu.train.main`: tokenizer,
dataset, msgpack checkpoints, logging, the eval loop), meshes, the
vision-text modality and the fused loss.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lwm_tpu_torch.models.llama import LLaMAConfig
from lwm_tpu_torch.optim import AdamW, OptimizerFactory
from lwm_tpu_torch.utils.losses import cross_entropy_loss_and_accuracy, global_norm

# fields a preset takes from the flags' llama config (`lwm_tpu/train.py:107-113`)
SCAN_KEYS = ("scan_attention", "scan_mlp", "scan_query_chunk_size", "scan_key_chunk_size",
             "scan_mlp_chunk_size", "scan_layers", "param_scan_axis")


def build_model_config(load_llama_config="", llama=None, update_llama_config=None):
    """Preset (or `llama` alone) → the scan knobs of `llama` overlaid on a
    preset → `update_llama_config` (a dict; the JAX flag is its string)."""
    llama = dict(llama or {})
    if load_llama_config:
        config = LLaMAConfig.load_config(load_llama_config)
        updates = LLaMAConfig.from_dict(llama)
        config = config.replace(**{key: getattr(updates, key) for key in SCAN_KEYS})
    else:
        config = LLaMAConfig.from_dict(llama)
    return config.replace(**(update_llama_config or {}))


@dataclass
class TrainState:
    """The model (its parameters in `param_dtype`), the optimizer with its
    state, and the number of train steps taken."""

    model: torch.nn.Module
    optimizer: AdamW
    step: int = 0


def create_train_state(model, optimizer_config=None):
    return TrainState(model, OptimizerFactory.get_optimizer(optimizer_config,
                                                            model.named_parameters()))


def compute_loss(model, batch, loss_chunk_size=0):
    """Masked cross-entropy of the model's logits on
    {"input_tokens", "target_tokens", "loss_masks"}. Returns (loss,
    {"acc": accuracy})."""
    logits = model(batch["input_tokens"])
    loss, acc = cross_entropy_loss_and_accuracy(
        logits, batch["target_tokens"], batch["loss_masks"], chunk_size=loss_chunk_size or None,
    )
    return loss, dict(acc=acc)


def train_step(state, batch, loss_chunk_size=0):
    """One forward, backward and optimizer step, updating `state` in place.
    Returns the JAX step's metrics as 0-dim tensors: loss, acc,
    learning_rate (the schedule at the new step count), param_norm (after
    the update) and gradient_norm."""
    model = state.model
    model.zero_grad(set_to_none=True)
    loss, aux = compute_loss(model, batch, loss_chunk_size)
    loss.backward()
    params = list(model.parameters())
    gradient_norm = global_norm([p.grad for p in params if p.grad is not None])
    state.optimizer.step()
    model.zero_grad(set_to_none=True)
    state.step += 1
    return dict(
        loss=loss.detach(),
        learning_rate=torch.tensor(state.optimizer.schedule(state.step)),
        param_norm=global_norm(params),
        gradient_norm=gradient_norm,
        **{k: v.detach() for k, v in aux.items()},
    )

