"""The trainer: `python -m lwm_tpu_torch.train`, the counterpart of
`lwm_tpu/train.py` (`main`, `:124-447`) for `--modality=text` and
`--modality=vision,text`, and the library pieces of its step.

    python -m lwm_tpu_torch.train --load_llama_config=7b --dtype=bf16 \
        --tokenizer=LOCAL_DIR --train_dataset.type=json \
        --train_dataset.text_processor.fields=text \
        --train_dataset.json_dataset.path=data.jsonl ...

    torchrun --nproc_per_node=4 -m lwm_tpu_torch.train --mesh_dim=2,1,1,2 \
        --sp_layout=striped ...          # dp 2 x sp 2, one rank a card
    torchrun --nproc_per_node=4 -m lwm_tpu_torch.train --mesh_dim='!1,-1,2,2' \
        ...                              # tp 2 x sp 2 (run_train_text.sh's mesh)

(`scripts/run_train_torch.sh` and, for vision-text, `scripts/
run_train_vision_torch.sh` are the bundles.) The flags are the JAX
trainer's tree (`utils/flags.py`), plus `--device` (default `cuda`; `cpu`
is the CLI's counterpart of JAX's `LWM_PLATFORM`, and without CUDA the CLI
raises unless it is given). The loop: logger (`utils/logging.py`), the
tokenizer from a local directory, autoresume from `<output_dir>/
streaming_train_state` and `dataset.pkl` (`:148-153`), the JSONL dataset
(`data/`: `json`, or `json_vision` for vision-text), the model config (a
preset or `--llama.*`, the eval'd `--update_llama_config`, the vocab
widened to the tokenizer's length, its bos and eos; a `VideoLLaMAConfig`
for vision-text, whose `sample_mode` must be "all"), the model in fp32
params computing in `--dtype`, the init from `--seed` or from
`--load_checkpoint` (`params::`, `trainstate_params::`, `flax_params::`,
`trainstate::`), a save at the start when `save_model_freq` > 0, then one
step a batch up to `total_steps`: `--profile_*` through `torch.profiler`,
every `log_freq` steps the JAX step's metrics (`loss`, `acc` or, for
vision-text, `vision_loss`, `vision_acc`, `text_loss`, `text_acc`;
`learning_rate`, `param_norm`, `gradient_norm`, `step`, the `dataset_*`
ones, and the mean of `eval_steps` batches of `eval_dataset` as
`eval_loss` and `eval_` + each loss metric) read off the device, milestone
and rolling saves, and a last milestone save
(`checkpoint.StreamingCheckpointer`: the JAX trainer's streams).

The step: the JAX step keeps fp32 params and computes in the `--dtype`
(bf16 in `scripts/run_train_text.sh`); here that is the model's
`param_dtype` and `dtype`. The text loss is `cross_entropy_loss_and_accuracy`
over full logits, or with `fused_lm_loss` `fused_lm_cross_entropy` on
`forward_hidden` (`:241-266`); the vision-text loss is `dual_cross_entropy`
over the VideoLLaMA's (vision, text) logits (`:273-296`; `fused_lm_loss` is
not read there, as in JAX), its log-softmax in chunks of 2048 rows unless
`loss_chunk_size` names others (`compute_loss`). The optimizer is `optim.OptimizerFactory`'s
(AdamW or PaLM) with the config's weight-decay exclusions and, under
`--freeze_base`, its frozen-param mask (`param_masks`); the logged
`gradient_norm` counts every gradient, frozen ones included, as JAX's
does. Metrics stay on the device until a log reads them.

On a mesh (`--mesh_dim` over the job's ranks, dp × fsdp × tp × sp,
`parallel.mesh`; the process group from torchrun's environment, or from
`--jax_distributed.*` when `initialize_jax_distributed` is set; NCCL on the
card, gloo on the CPU) every rank reads the same global batch and keeps its
rows (split over dp × fsdp) and sp columns (`data.text.shard_batch`, after
the stripe permutation under `--sp_layout=striped`), as JAX's
`PS(("dp", "fsdp"), "sp")` (`lwm_tpu/train.py:300`); the model is built at
its tp width and `create_train_state` shards it over fsdp × sp by the rule
table (`parallel.fsdp`: params and moments alike, `lwm_tpu/train.py:
322-359`); the model runs its sp slice through the ring
(`ops.ring.ring_attention`), its blocks on the rank's heads and features,
the loss is the one-device mean on every rank (`utils.losses`), a sharded
leaf's gradient is reduce-scattered over fsdp × sp in the backward, and the
gradients are summed over dp (a leaf held whole over fsdp × sp first over
it) before the optimizer (`reduce_gradients`), never over tp. `param_norm`
and `gradient_norm` are the whole leaves' (`lwm_tpu/train.py:307-310`).
Only rank 0 logs (unless `log_all_worker`), writes metrics and saves
checkpoints (`lwm_tpu/train.py:132`, `:332`), each leaf gathered from the
ranks' parts as it is written; autoresume reads on every rank, each leaf
cut to the rank's part as it is read (`checkpoint`).

Refused, naming what they wait for: dropout and the other remat policies
(ROADMAP A3); the `huggingface` dataset type and `gs://` paths.
"""

from __future__ import annotations

import dataclasses
import os
import pprint
import sys
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

from lwm_tpu_torch.checkpoint import StreamingCheckpointer, checkpoint_gathers
from lwm_tpu_torch.data import DatasetFactory
from lwm_tpu_torch.data.text import shard_batch
from lwm_tpu_torch.models.llama import LLaMAConfig, LLaMAForCausalLM
from lwm_tpu_torch.models.vision_llama import VideoLLaMAConfig, VideoLLaMAForCausalLM
from lwm_tpu_torch.optim import OptimizerFactory, none_match
from lwm_tpu_torch.parallel.fsdp import shard_model
from lwm_tpu_torch.parallel.mesh import (
    SP_LAYOUTS, create_mesh, get_ranks_and_size, initialize_distributed, mesh_of,
)
from lwm_tpu_torch.utils.convert import flax_param_path
from lwm_tpu_torch.utils.dtypes import get_float_dtype_by_name
from lwm_tpu_torch.utils.flags import get_user_flags, parse_flags, placeholder
from lwm_tpu_torch.utils.io import check_exists, load_pickle, makedirs
from lwm_tpu_torch.utils.logging import DEFAULTS as LOGGER_DEFAULTS
from lwm_tpu_torch.utils.logging import MetricsLogger
from lwm_tpu_torch.utils.losses import (
    average_metrics, cross_entropy_loss_and_accuracy, dual_cross_entropy,
    fused_lm_cross_entropy, global_norm,
)
from lwm_tpu_torch.utils.rng import init_generator, set_random_seed
from lwm_tpu_torch.utils.tokenizer import Tokenizer

# fields a preset takes from the flags' llama config (`lwm_tpu/train.py:107-113`)
SCAN_KEYS = ("scan_attention", "scan_mlp", "scan_query_chunk_size", "scan_key_chunk_size",
             "scan_mlp_chunk_size", "scan_layers", "param_scan_axis")
# --modality → (config, model) (`lwm_tpu/train.py:93-98, 181-197`)
MODALITIES = {"text": (LLaMAConfig, LLaMAForCausalLM),
              "vision,text": (VideoLLaMAConfig, VideoLLaMAForCausalLM)}


def build_model_config(load_llama_config="", llama=None, update_llama_config=None,
                       config_cls=LLaMAConfig):
    """Preset (or `llama` alone) → the scan knobs of `llama` overlaid on a
    preset → `update_llama_config` (a dict; the JAX flag is its string), as
    a `config_cls` (`VideoLLaMAConfig` for vision-text)."""
    llama = dict(llama or {})
    if load_llama_config:
        config = config_cls.load_config(load_llama_config)
        updates = config_cls.from_dict(llama)
        config = config.replace(**{key: getattr(updates, key) for key in SCAN_KEYS})
    else:
        config = config_cls.from_dict(llama)
    return config.replace(**(update_llama_config or {}))


def param_masks(config, freeze_base=False):
    """(decayed, frozen): predicates on parameter names from the config's
    weight-decay and frozen-param exclusions, matched against each param's
    flax path as the JAX trainer's masks are (`lwm_tpu/train.py:209-221`);
    frozen is None without `freeze_base` (no multi_transform)."""
    def by_path(predicate):
        return lambda name: predicate(flax_param_path(name, config))

    decayed = by_path(none_match(config.get_weight_decay_exclusions()))
    if not freeze_base:
        return decayed, None
    return decayed, by_path(none_match(config.get_frozen_param_exclusions(True)))


@dataclass
class TrainState:
    """The model (its parameters in `param_dtype`), the optimizer with its
    state, and the number of train steps taken."""

    model: torch.nn.Module
    optimizer: object   # optim.AdamW or optim.Palm
    step: int = 0


def create_train_state(model, optimizer_config=None, freeze_base=False):
    """The model with the optimizer of `optimizer_config` over its params,
    decayed and frozen as its config's exclusions say (`param_masks`), each
    param in the block of its JAX tree leaf (`flax_param_path`). On the
    model's mesh the params are sharded over fsdp × sp first
    (`parallel.fsdp.shard_model`), so the optimizer's moments are parts
    too."""
    decayed, frozen = param_masks(model.config, freeze_base)
    shard_model(model)
    return TrainState(model, OptimizerFactory.get_optimizer(
        optimizer_config, model.named_parameters(), decayed, frozen,
        param_block=lambda name: flax_param_path(name, model.config),
        placements=model.placements if mesh_of(model) is not None else None))


def compute_loss(model, batch, loss_chunk_size=0, fused_lm_loss=False):
    """The masked cross-entropy of a batch {"input_tokens",
    "target_tokens", "loss_masks"[, "input_vision_masks",
    "target_vision_masks"]}. A VideoLLaMA (its sample_mode "all", as
    `main` requires): the dual loss of its (vision, text) logits, with
    {"vision_loss", "vision_acc", "text_loss", "text_acc"}, its fp32
    log-softmax in chunks of `loss_chunk_size` rows recomputed in the
    backward, 2048 when 0, and any chunk longer than 2048 rows in 2048-row
    pieces (where the JAX trainer takes the whole sequence at once: over
    32768 rows the two heads' fp32 copies put a 7b-width step at a 66.3 GiB
    peak, which failed on an 80 GB card when the allocator's cache was
    fragmented; the values are the same). A text model:
    of its logits, or with
    `fused_lm_loss` of its final hidden states through the lm_head (the
    embedding when tied) in fp32 chunks of `loss_chunk_size` (2048 when
    0), with {"acc"}. On the model's mesh (`model.mesh`) the batch is this
    rank's part and the loss the whole batch's. Returns (loss, metrics)."""
    mesh = mesh_of(model)
    if model.takes_vision_masks:
        out = model(batch["input_tokens"], vision_masks=batch["input_vision_masks"])
        return dual_cross_entropy(out.vision_logits, out.lm_logits, batch["target_tokens"],
                                  batch["loss_masks"], batch["target_vision_masks"],
                                  chunk_size=loss_chunk_size or 2048, mesh=mesh)
    if fused_lm_loss:
        hidden = model.forward_hidden(batch["input_tokens"])
        weight = model.head_weight()
        loss, acc = fused_lm_cross_entropy(hidden, weight, batch["target_tokens"],
                                           batch["loss_masks"], chunk_size=loss_chunk_size or 2048,
                                           mesh=mesh)
        return loss, dict(acc=acc)
    logits = model(batch["input_tokens"])
    loss, acc = cross_entropy_loss_and_accuracy(
        logits, batch["target_tokens"], batch["loss_masks"], chunk_size=loss_chunk_size or None,
        mesh=mesh,
    )
    return loss, dict(acc=acc)


GRAD_BUCKET_BYTES = 256 << 20   # gradients summed in flat buckets of about this size,
GRAD_BUCKETS_IN_FLIGHT = 4      # this many at a time


def all_reduce_grads(params, group=None):
    """Sum every parameter's gradient over the ranks of `group` (every
    rank when None), in flat buckets of GRAD_BUCKET_BYTES, up to
    GRAD_BUCKETS_IN_FLIGHT all-reduces in flight (a bucket is packed while
    the ones before it travel)."""
    grads = [p.grad for p in params if p.grad is not None]
    buckets, i = [], 0
    while i < len(grads):
        j, size = i, 0
        while j < len(grads) and (j == i or size + grads[j].nbytes <= GRAD_BUCKET_BYTES):
            size += grads[j].nbytes
            j += 1
        buckets.append(grads[i:j])
        i = j
    pending = []

    def finish():
        work, flat, bucket = pending.pop(0)
        work.wait()
        for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
            g.copy_(part.view_as(g))

    for bucket in buckets:
        flat = torch.cat([g.reshape(-1) for g in bucket])
        pending.append((dist.all_reduce(flat, group=group, async_op=True), flat, bucket))
        if len(pending) >= GRAD_BUCKETS_IN_FLIGHT:
            finish()
    while pending:
        finish()


def reduce_gradients(model):
    """Sum the gradients of a model on a mesh where the ranks computed
    parts of them: a leaf held whole over fsdp × sp over that group, then
    every leaf over dp (a sharded leaf's gradient was reduce-scattered over
    fsdp × sp in the backward: `parallel.mesh.GatherShards`); nothing over
    tp, whose ranks hold their own slices or the same whole gradient."""
    mesh = model.mesh
    places = model.placements
    named = [(n, p) for n, p in model.named_parameters() if p.grad is not None]
    if mesh.shard > 1:
        all_reduce_grads([p for n, p in named if not places[n].over_shard], mesh.group("shard"))
    if mesh.dp > 1:
        all_reduce_grads([p for _, p in named], mesh.group("dp"))


def _norm(model, tensors):
    """The global norm of `tensors` (one for each of the model's params, or
    None), over the whole leaves on the model's mesh."""
    named = [(n, t) for (n, _), t in zip(model.named_parameters(), tensors) if t is not None]
    places = model.placements if mesh_of(model) is not None else None
    return global_norm([t for _, t in named], None if places is None
                       else [places[n] for n, _ in named])


def train_step(state, batch, loss_chunk_size=0, fused_lm_loss=False):
    """One forward, backward and optimizer step, updating `state` in place.
    Returns the JAX step's metrics as 0-dim tensors: loss, the loss's
    metrics (`compute_loss`), learning_rate (the schedule at the new step
    count), param_norm (after the update) and gradient_norm (of every
    gradient, frozen params' included), both over the whole leaves. On the
    model's mesh the gradients are summed over its ranks before the
    optimizer (`reduce_gradients`)."""
    model = state.model
    model.zero_grad(set_to_none=True)
    loss, aux = compute_loss(model, batch, loss_chunk_size, fused_lm_loss)
    loss.backward()
    params = list(model.parameters())
    if mesh_of(model) is not None:
        reduce_gradients(model)
    gradient_norm = _norm(model, [p.grad for p in params])
    state.optimizer.step()
    model.zero_grad(set_to_none=True)
    state.step += 1
    return dict(
        loss=loss.detach(),
        learning_rate=torch.tensor(state.optimizer.schedule(state.step)),
        param_norm=_norm(model, params),
        gradient_norm=gradient_norm,
        **{k: v.detach() for k, v in aux.items()},
    )



def eval_step(state, batch, loss_chunk_size=0, fused_lm_loss=False):
    """The loss of the current params on `batch`, without gradients:
    {"eval_loss", "eval_" + each loss metric} as 0-dim tensors."""
    with torch.no_grad():
        loss, aux = compute_loss(state.model, batch, loss_chunk_size, fused_lm_loss)
    return dict(eval_loss=loss, **{f"eval_{k}": v for k, v in aux.items()})


# ------------------------------------------------------------------ the CLI

PROG = "python -m lwm_tpu_torch.train"
# one device: this host is rank 0 of 1 on every axis (`get_ranks_and_size`)
NODE_INFO = dict(dp_node_size=1, dp_node_rank=0, mp_node_size=1, mp_node_rank=0)
BATCH_KEYS = ("input_tokens", "target_tokens", "loss_masks", "input_vision_masks",
              "target_vision_masks")


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


def _mesh_dims(mesh_dim):
    """The four axis sizes of `mesh_dim` as written (a -1 not inferred)."""
    text = mesh_dim.strip().lstrip("!")
    try:
        dims = [int(d) for d in text.split(",")]
    except ValueError:
        raise ValueError(f"--mesh_dim={mesh_dim}: not a list of 4 integers") from None
    if len(dims) != 4 or dims.count(-1) > 1:
        raise ValueError(f"--mesh_dim={mesh_dim}: want 4 axis sizes, at most one of them -1")
    return dims


def check_single_device_mesh(mesh_dim):
    """`mesh_dim` must resolve to one device (every axis 1, one of them
    possibly -1): the vision apps run on one (their meshes come with a later
    multi-GPU slice)."""
    if any(d not in (1, -1) for d in _mesh_dims(mesh_dim)):
        raise NotImplementedError(
            f"--mesh_dim={mesh_dim}: the port runs this on one device (a mesh such as "
            "1,-1,1,1); the vision apps' meshes come with a later multi-GPU slice (ROADMAP A4)")


def check_mesh(mesh_dim):
    """`mesh_dim` in the grammar (four axis sizes, at most one -1); the port
    trains on every axis. The sizes are checked against the job's ranks
    when the mesh is built."""
    _mesh_dims(mesh_dim)


def check_supported(flags):
    """Refuse, before anything is built, what the port does not train."""
    if flags.modality not in MODALITIES:
        raise ValueError(f"unsupported modality: {flags.modality}")
    check_mesh(flags.mesh_dim)
    if flags.sp_layout not in SP_LAYOUTS:
        raise ValueError(f"--sp_layout={flags.sp_layout}: use one of {SP_LAYOUTS}")


def _on_device(batch, device, node_info=NODE_INFO):
    batch = shard_batch({k: batch[k] for k in BATCH_KEYS}, node_info)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _rank0_value(value):
    """Rank 0's `value` on every rank (the value itself on one rank)."""
    if not dist.is_initialized():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


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
    joined = not dist.is_initialized()
    initialize_distributed(flags.jax_distributed, device)
    joined = joined and dist.is_initialized()
    try:
        return _main(flags, device)
    finally:
        if joined:
            dist.destroy_process_group()


def _main(flags, device):
    mesh = create_mesh(flags.mesh_dim, device, flags.sp_layout)
    if device.type == "cuda" and dist.is_initialized():
        device = torch.device("cuda", torch.cuda.current_device())
    node_info = get_ranks_and_size(mesh)
    variant = get_user_flags(flags, DEFAULTS)
    set_random_seed(flags.seed)
    logger = MetricsLogger(flags.logger, variant, enable=mesh.is_rank0 or flags.log_all_worker)
    output_dir = _rank0_value(logger.output_dir)
    tokenizer = Tokenizer(flags.tokenizer)

    load_checkpoint, load_dataset_state = flags.load_checkpoint, flags.load_dataset_state
    if flags.autoresume and check_exists(os.path.join(output_dir, "streaming_train_state")):
        log(f"autoresuming from {output_dir}")
        load_checkpoint = "trainstate::" + os.path.join(output_dir, "streaming_train_state")
        load_dataset_state = os.path.join(output_dir, "dataset.pkl")

    dataset = DatasetFactory.load_dataset(flags.train_dataset, tokenizer, node_info=node_info)
    if load_dataset_state:
        dataset.load_state_dict(load_pickle(load_dataset_state))
    eval_batches = None
    if flags.eval_steps > 0:
        eval_dataset = DatasetFactory.load_dataset(flags.eval_dataset, dataset.tokenizer,
                                                   node_info=node_info)
        eval_batches = iter(eval_dataset)

    updates = {}
    if flags.update_llama_config:
        # the JAX CLI's spelling: a Python expression, "dict(theta=5e7, ...)"
        updates = dict(eval(flags.update_llama_config, {"dict": dict}))  # noqa: S307
    config_cls, model_cls = MODALITIES[flags.modality]
    config = build_model_config(flags.load_llama_config, flags.llama, updates, config_cls)
    config = config.replace(vocab_size=max(config.vocab_size, dataset.vocab_size),
                            bos_token_id=tokenizer.bos_token_id,
                            eos_token_id=tokenizer.eos_token_id)
    if model_cls.takes_vision_masks and config.sample_mode != "all":
        raise ValueError(   # the JAX trainer's message (`lwm_tpu/train.py:186-197`)
            "vision,text training needs sample_mode='all' (dual vision+text logits); got "
            f"sample_mode='{config.sample_mode}' — 'vision'/'text' are sampling-time modes "
            "(set them at generation, not here)")
    model = model_cls(config, dtype=get_float_dtype_by_name(flags.dtype),
                      param_dtype=torch.float32, device=device, mesh=mesh)
    state = create_train_state(model, flags.optimizer, flags.freeze_base)
    checkpointer = StreamingCheckpointer(flags.checkpointer, output_dir, enable=mesh.is_rank0)
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
        # a mesh holding parts of the leaves gathers each one as rank 0 writes it
        if not mesh.is_rank0 and not checkpoint_gathers(state):
            return
        metadata = dict(step=state.step, variant=variant, flags=variant,
                        llama_config=dataclasses.asdict(config))
        seconds = checkpointer.save_all(state, metadata=metadata,
                                        dataset=dataset.get_state_dict(), milestone=milestone)
        if mesh.is_rank0:
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
            metrics = train_step(state, _on_device(batch, device, node_info),
                                 flags.loss_chunk_size, flags.fused_lm_loss)
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
                        eval_step(state, _on_device(next(eval_batches)[0], device, node_info),
                                  flags.loss_chunk_size, flags.fused_lm_loss)
                        for _ in range(flags.eval_steps)]))
                log_metrics = {"step": step + 1, **metrics, **dataset_metrics}
                log_metrics = {k: _host(v) for k, v in log_metrics.items()}
                logger.log(log_metrics)
                if mesh.is_rank0:
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
