"""The text trainer on one device: `python -m lwm_tpu_torch.train`, the
counterpart of `lwm_tpu/train.py` (`main`, `:124-447`) for `--modality=text`,
and the library pieces of its step.

    python -m lwm_tpu_torch.train --load_llama_config=7b --dtype=bf16 \
        --tokenizer=LOCAL_DIR --train_dataset.type=json \
        --train_dataset.text_processor.fields=text \
        --train_dataset.json_dataset.path=data.jsonl ...

(`scripts/run_train_torch.sh` is the bundle.) The flags are the JAX
trainer's tree (`utils/flags.py`), plus `--device` (default `cuda`; `cpu`
is the CLI's counterpart of JAX's `LWM_PLATFORM`, and without CUDA the CLI
raises unless it is given). The loop: logger (`utils/logging.py`), the
tokenizer from a local directory, autoresume from `<output_dir>/
streaming_train_state` and `dataset.pkl` (`:148-153`), the JSONL dataset
(`data/`), the model config (a preset or `--llama.*`, the eval'd
`--update_llama_config`, the vocab widened to the tokenizer's length, its
bos and eos), the model in fp32 params computing in `--dtype`, the init
from `--seed` or from `--load_checkpoint` (`params::`,
`trainstate_params::`, `flax_params::`, `trainstate::`), a save at the start
when `save_model_freq` > 0, then one step a batch up to `total_steps`:
`--profile_*` through `torch.profiler`, every `log_freq` steps the JAX
step's metrics (`loss`, `acc`, `learning_rate`, `param_norm`,
`gradient_norm`, `step`, the `dataset_*` ones, and the mean of `eval_steps`
batches of `eval_dataset` as `eval_loss`, `eval_acc`) read off the device,
milestone and rolling saves, and a last milestone save
(`checkpoint.StreamingCheckpointer`: the JAX trainer's streams).

The step: the JAX step keeps fp32 params and computes in the `--dtype`
(bf16 in `scripts/run_train_text.sh`); here that is the model's
`param_dtype` and `dtype`. The loss is `cross_entropy_loss_and_accuracy`
over full logits, or with `fused_lm_loss` `fused_lm_cross_entropy` on
`forward_hidden` (`:241-266`); the optimizer `optim.OptimizerFactory` with
every parameter decayed (the text model's weight-decay exclusions are
empty, `lwm_tpu/models/llama.py:279-280`). Metrics stay on the device
until a log reads them.

Refused, naming what they wait for: a mesh of more than one device, an
`sp_layout` but "contiguous" and `jax_distributed` (multi-GPU, ROADMAP
A4); `--modality=vision,text`, `--freeze_base` and the PaLM optimizer (the
vision slice, A5); the `huggingface` dataset type and `gs://` paths.
"""

from __future__ import annotations

import dataclasses
import os
import pprint
import sys
import time
from dataclasses import dataclass

import torch

from lwm_tpu_torch.checkpoint import StreamingCheckpointer
from lwm_tpu_torch.data import DatasetFactory
from lwm_tpu_torch.models.llama import LLaMAConfig, LLaMAForCausalLM
from lwm_tpu_torch.optim import AdamW, OptimizerFactory
from lwm_tpu_torch.utils.dtypes import get_float_dtype_by_name
from lwm_tpu_torch.utils.flags import get_user_flags, parse_flags, placeholder
from lwm_tpu_torch.utils.io import check_exists, load_pickle, makedirs
from lwm_tpu_torch.utils.logging import DEFAULTS as LOGGER_DEFAULTS
from lwm_tpu_torch.utils.logging import MetricsLogger
from lwm_tpu_torch.utils.losses import (
    average_metrics, cross_entropy_loss_and_accuracy, fused_lm_cross_entropy, global_norm,
)
from lwm_tpu_torch.utils.rng import init_generator, set_random_seed
from lwm_tpu_torch.utils.tokenizer import Tokenizer

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


def compute_loss(model, batch, loss_chunk_size=0, fused_lm_loss=False):
    """Masked cross-entropy on {"input_tokens", "target_tokens",
    "loss_masks"}: of the model's logits, or with `fused_lm_loss` of its
    final hidden states through the lm_head (the embedding when tied) in
    fp32 chunks of `loss_chunk_size` (2048 when 0). Returns (loss, {"acc":
    accuracy})."""
    if fused_lm_loss:
        hidden = model.forward_hidden(batch["input_tokens"])
        weight = model.wte.weight if model.lm_head is None else model.lm_head.weight
        loss, acc = fused_lm_cross_entropy(hidden, weight, batch["target_tokens"],
                                           batch["loss_masks"], chunk_size=loss_chunk_size or 2048)
        return loss, dict(acc=acc)
    logits = model(batch["input_tokens"])
    loss, acc = cross_entropy_loss_and_accuracy(
        logits, batch["target_tokens"], batch["loss_masks"], chunk_size=loss_chunk_size or None,
    )
    return loss, dict(acc=acc)


def train_step(state, batch, loss_chunk_size=0, fused_lm_loss=False):
    """One forward, backward and optimizer step, updating `state` in place.
    Returns the JAX step's metrics as 0-dim tensors: loss, acc,
    learning_rate (the schedule at the new step count), param_norm (after
    the update) and gradient_norm."""
    model = state.model
    model.zero_grad(set_to_none=True)
    loss, aux = compute_loss(model, batch, loss_chunk_size, fused_lm_loss)
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



def eval_step(state, batch, loss_chunk_size=0, fused_lm_loss=False):
    """The loss of the current params on `batch`, without gradients:
    {"eval_loss", "eval_acc"} as 0-dim tensors."""
    with torch.no_grad():
        loss, aux = compute_loss(state.model, batch, loss_chunk_size, fused_lm_loss)
    return dict(eval_loss=loss, **{f"eval_{k}": v for k, v in aux.items()})


# ------------------------------------------------------------------ the CLI

PROG = "python -m lwm_tpu_torch.train"
# one device: this host is rank 0 of 1 on every axis (`get_ranks_and_size`)
NODE_INFO = dict(dp_node_size=1, dp_node_rank=0, mp_node_size=1, mp_node_rank=0)
BATCH_KEYS = ("input_tokens", "target_tokens", "loss_masks")


def _llama_flag_defaults():
    """The `--llama.*` tree: the config's fields and defaults, plus the JAX
    config's mesh fields (`mesh_dim`, `sp_layout`, `sp_slot_caches`), which
    the port reads nowhere."""
    out = {}
    for f in dataclasses.fields(LLaMAConfig):
        out[f.name] = placeholder(int) if f.default is None else f.default
    out.update(mesh_dim=placeholder(str), sp_layout="contiguous", sp_slot_caches=False)
    return out


DEFAULTS = dict(
    seed=42, mesh_dim="1,-1,1,1", dtype="fp32", modality="text", total_steps=10000,
    load_llama_config="", update_llama_config="", load_checkpoint="", load_dataset_state="",
    log_freq=50, profile_start_step=0, profile_steps=0, profile_dir="", save_model_freq=0,
    save_milestone_freq=0, eval_steps=0, tokenizer="openlm-research/open_llama_3b_v2",
    use_data_sharded_loader=True, sp_layout="contiguous", freeze_base=False,
    loss_chunk_size=0, fused_lm_loss=False, autoresume=False,
    train_dataset=DatasetFactory.get_default_config(),
    eval_dataset=DatasetFactory.get_default_config(),
    optimizer=OptimizerFactory.get_default_config(),
    checkpointer=StreamingCheckpointer.get_default_config(),
    llama=_llama_flag_defaults(),
    logger=LOGGER_DEFAULTS,
    log_all_worker=False,
    jax_distributed=dict(initialize_jax_distributed=False, coordinator_address=placeholder(str),
                         num_processes=placeholder(int), process_id=placeholder(int),
                         local_device_ids=placeholder(str)),
    device="cuda",
)


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def check_single_device_mesh(mesh_dim):
    """`mesh_dim` must resolve to one device (every axis 1, one of them
    possibly -1), as the port trains on one."""
    text = mesh_dim.strip().lstrip("!")
    try:
        dims = [int(d) for d in text.split(",")]
    except ValueError:
        raise ValueError(f"--mesh_dim={mesh_dim}: not a list of 4 integers") from None
    if len(dims) != 4 or dims.count(-1) > 1:
        raise ValueError(f"--mesh_dim={mesh_dim}: want 4 axis sizes, at most one of them -1")
    if any(d not in (1, -1) for d in dims):
        raise NotImplementedError(
            f"--mesh_dim={mesh_dim}: the port trains on one device (a mesh such as 1,-1,1,1); "
            "meshes of more devices come with the multi-GPU module (ROADMAP A4)")


def check_supported(flags):
    """Refuse, before anything is built, what the port does not train."""
    if flags.modality == "vision,text":
        raise NotImplementedError(
            "--modality=vision,text is not ported yet: it comes with the vision model "
            "(ROADMAP A5)")
    if flags.modality != "text":
        raise ValueError(f"unsupported modality: {flags.modality}")
    check_single_device_mesh(flags.mesh_dim)
    if flags.sp_layout != "contiguous":
        raise NotImplementedError(
            f"--sp_layout={flags.sp_layout}: sequence-parallel layouts come with the "
            "multi-GPU module (ROADMAP A4)")
    if flags.jax_distributed["initialize_jax_distributed"]:
        raise NotImplementedError("multi-process training comes with the multi-GPU module "
                                  "(ROADMAP A4)")
    if flags.freeze_base:
        raise NotImplementedError(
            "--freeze_base (a vision finetune recipe: only vte and vision_head train) is not "
            "ported yet: it comes with the vision model (ROADMAP A5)")


def _on_device(batch, device):
    return {k: torch.from_numpy(batch[k]).to(device) for k in BATCH_KEYS}


def _host(value):
    return value.item() if isinstance(value, torch.Tensor) else value


def main(argv=None):
    """Run the trainer on `argv` (the flags, without the program name;
    sys.argv when None). Returns a summary: the experiment's output_dir, the
    start and end steps, what was loaded, and the seconds each checkpoint
    save and the load took."""
    flags = parse_flags(DEFAULTS, sys.argv[1:] if argv is None else argv, prog=PROG)
    check_supported(flags)
    device = torch.device(flags.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass --device=cpu to train on the CPU")
    variant = get_user_flags(flags, DEFAULTS)
    set_random_seed(flags.seed)
    logger = MetricsLogger(flags.logger, variant)
    output_dir = logger.output_dir
    tokenizer = Tokenizer(flags.tokenizer)

    load_checkpoint, load_dataset_state = flags.load_checkpoint, flags.load_dataset_state
    if flags.autoresume and check_exists(os.path.join(output_dir, "streaming_train_state")):
        log(f"autoresuming from {output_dir}")
        load_checkpoint = "trainstate::" + os.path.join(output_dir, "streaming_train_state")
        load_dataset_state = os.path.join(output_dir, "dataset.pkl")

    dataset = DatasetFactory.load_dataset(flags.train_dataset, tokenizer, node_info=NODE_INFO)
    if load_dataset_state:
        dataset.load_state_dict(load_pickle(load_dataset_state))
    eval_batches = None
    if flags.eval_steps > 0:
        eval_dataset = DatasetFactory.load_dataset(flags.eval_dataset, dataset.tokenizer,
                                                   node_info=NODE_INFO)
        eval_batches = iter(eval_dataset)

    updates = {}
    if flags.update_llama_config:
        # the JAX CLI's spelling: a Python expression, "dict(theta=5e7, ...)"
        updates = dict(eval(flags.update_llama_config, {"dict": dict}))  # noqa: S307
    config = build_model_config(flags.load_llama_config, flags.llama, updates)
    config = config.replace(vocab_size=max(config.vocab_size, dataset.vocab_size),
                            bos_token_id=tokenizer.bos_token_id,
                            eos_token_id=tokenizer.eos_token_id)
    model = LLaMAForCausalLM(config, dtype=get_float_dtype_by_name(flags.dtype),
                             param_dtype=torch.float32, device=device)
    state = create_train_state(model, flags.optimizer)
    checkpointer = StreamingCheckpointer(flags.checkpointer, output_dir)
    summary = dict(output_dir=output_dir, loaded=None, load_seconds=None, save_seconds=[])
    if load_checkpoint:
        t0 = time.perf_counter()
        summary["loaded"] = checkpointer.load_into(load_checkpoint, state)
        summary["load_seconds"] = time.perf_counter() - t0
        log(f"loaded {load_checkpoint} (step {state.step}) in {summary['load_seconds']:.1f}s")
    else:
        model.init_weights(init_generator(flags.seed, device))
    summary["start_step"] = start_step = state.step

    def save_checkpoint(milestone=False):
        metadata = dict(step=state.step, variant=variant, flags=variant,
                        llama_config=dataclasses.asdict(config))
        seconds = checkpointer.save_all(state, metadata=metadata,
                                        dataset=dataset.get_state_dict(), milestone=milestone)
        summary["save_seconds"].append(seconds)
        log(f"saved step {state.step}{' (milestone)' if milestone else ''} in {seconds:.1f}s")

    if flags.save_model_freq > 0:
        save_checkpoint()

    profiler = None
    profile_end = flags.profile_start_step + flags.profile_steps - 1
    batches = iter(dataset)
    try:
        for step, (batch, dataset_metrics) in zip(range(start_step, flags.total_steps), batches):
            if flags.profile_steps > 0 and step == flags.profile_start_step:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=activities)
                profiler.start()
            metrics = train_step(state, _on_device(batch, device), flags.loss_chunk_size,
                                 flags.fused_lm_loss)
            if profiler is not None and step >= profile_end:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                profiler.stop()
                profile_dir = flags.profile_dir or os.path.join(output_dir, "profile")
                makedirs(profile_dir)
                profiler.export_chrome_trace(os.path.join(profile_dir, f"trace_{step + 1}.json"))
                profiler = None
            if flags.log_freq > 0 and (step + 1) % flags.log_freq == 0:
                if eval_batches is not None:
                    metrics.update(average_metrics([
                        eval_step(state, _on_device(next(eval_batches)[0], device),
                                  flags.loss_chunk_size, flags.fused_lm_loss)
                        for _ in range(flags.eval_steps)]))
                log_metrics = {"step": step + 1, **metrics, **dataset_metrics}
                log_metrics = {k: _host(v) for k, v in log_metrics.items()}
                logger.log(log_metrics)
                log(pprint.pformat({k: v for k, v in log_metrics.items()
                                    if not k.startswith("dataset_")}))
            if flags.save_milestone_freq > 0 and (step + 1) % flags.save_milestone_freq == 0:
                save_checkpoint(milestone=True)
            elif flags.save_model_freq > 0 and (step + 1) % flags.save_model_freq == 0:
                save_checkpoint()
        if flags.save_model_freq > 0:
            save_checkpoint(milestone=True)
    finally:
        batches.close()   # ends the tokenizer pool, if any
        if eval_batches is not None:
            eval_batches.close()
        logger.close()
    summary["end_step"] = state.step
    return summary


if __name__ == "__main__":
    main()
