"""Train-state checkpoints across the packages: a JAX `TrainState` after a
few optax steps, saved by the JAX `StreamingCheckpointer.save_all`, loads
into the port's model and AdamW (`lwm_tpu_torch.checkpoint.
StreamingCheckpointer.load_into`), the port writes it back byte for byte
as the JAX writer did, the next step matches the JAX step from the same
file, and the JAX checkpointer reads the state the port saves after it.
Scanned trees on axis 0 and 1, an unscanned one and `optax.MultiSteps`
(accumulate 2), with `float_dtype` None and "bf16"; and a VideoLLaMA's
state under AdamW and PaLM (adafactor's FactoredState with its one-element
placeholders, the EMA and the schedules' counts), with and without
`--freeze_base` (`optax.multi_transform`: the trainable params' moments
alone, under `inner_states/False/inner_state`). The stream's keys,
dtypes and order are read off the JAX writer's file, never written down.

Tolerances: the next step's metrics 1e-5 relative and the params after it
1e-5 absolute, as `tests/test_torch_train.py` holds the port's AdamW to
optax (fp32 on both sides; only summation orders differ). Everything read
across packages is compared exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.serialization import to_state_dict
from flax.traverse_util import flatten_dict
from flax.training.train_state import TrainState as JaxTrainState

from lwm_tpu.checkpoint import StreamingCheckpointer as JaxCheckpointer
from lwm_tpu.models import FlaxLLaMAForCausalLM, FlaxVideoLLaMAForCausalLM
from lwm_tpu.models import LLaMAConfig as JaxConfig
from lwm_tpu.models import VideoLLaMAConfig as JaxVideoConfig
from lwm_tpu.models.llama import FlaxLLaMAForCausalLMModule
from lwm_tpu.models.vision_llama import FlaxVideoLLaMAForCausalLMModule
from lwm_tpu.optim import OptimizerFactory as JaxOptimizerFactory
from lwm_tpu.parallel.partition import get_frozen_base_mask, get_weight_decay_mask
from lwm_tpu.utils import cross_entropy_loss_and_accuracy as jax_cross_entropy
from lwm_tpu_torch import checkpoint, train
from lwm_tpu_torch.models.llama import LLaMAConfig, LLaMAForCausalLM
from lwm_tpu_torch.models.vision_llama import VideoLLaMAConfig, VideoLLaMAForCausalLM
from lwm_tpu_torch.utils.convert import convert_flax_params, materialize

BASE = dict(
    vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
    num_attention_heads=4, max_sequence_length=64, scan_attention=False,
    scan_query_chunk_size=16, scan_key_chunk_size=16, scan_mlp=False, scan_mlp_chunk_size=16,
    remat_block="save_flash",
)
B, S = 2, 32
OPT = dict(adamw_optimizer=dict(init_lr=1e-3, lr=1e-2, end_lr=1e-3, lr_warmup_steps=2,
                                lr_decay_steps=10, weight_decay=0.1))
# name: (llama fields, accumulate_gradient_steps, steps before the save)
STRUCTURES = {
    "scan0": (dict(scan_layers=True, param_scan_axis=0), 1, 2),
    "scan1": (dict(scan_layers=True, param_scan_axis=1), 1, 2),
    "unscanned": (dict(scan_layers=False), 1, 2),
    # 3 micro-steps: the saved state has mini_step 1 and a live accumulator
    "accumulate2": (dict(scan_layers=True, param_scan_axis=0), 2, 3),
}


def _batch(seed):
    rng = np.random.default_rng(seed)
    masks = (rng.random((B, S)) > 0.2).astype(np.float32)
    return dict(input_tokens=rng.integers(0, 128, (B, S)).astype(np.int32),
                target_tokens=rng.integers(0, 128, (B, S)).astype(np.int32), loss_masks=masks)


def _opt(structure):
    return dict(OPT, accumulate_gradient_steps=STRUCTURES[structure][1])


@functools.cache
def _unscanned_params():
    cfg = JaxConfig(**BASE, scan_layers=False, mesh_dim=None, attn_impl="xla")
    return jax.device_get(FlaxLLaMAForCausalLM(cfg, input_shape=(1, 8), seed=0).params)


def _initial_params(fields):
    """One init for every structure (a JAX init is seconds): the unscanned
    tree, its layers stacked on `param_scan_axis` for a scanned one."""
    params = _unscanned_params()
    if not fields["scan_layers"]:
        return params
    h = params["transformer"]["h"]
    layers = [h[str(i)] for i in range(BASE["num_hidden_layers"])]
    stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs, fields["param_scan_axis"]),
                                     *layers)
    return dict(params, transformer=dict(params["transformer"], h={"scan_decoder": stacked}))


@functools.cache
def _jax_run(structure):
    """(jitted JAX train step, the TrainState after the structure's steps)."""
    fields, _, steps = STRUCTURES[structure]
    cfg = JaxConfig(**BASE, **fields, mesh_dim=None, attn_impl="xla")
    module = FlaxLLaMAForCausalLMModule(cfg, dtype=jnp.float32)
    rngs = {"dropout": jax.random.PRNGKey(0), "params": jax.random.PRNGKey(1)}
    tx, info = JaxOptimizerFactory.get_optimizer(_opt(structure), get_weight_decay_mask(()))

    def loss_fn(params, batch):
        logits = module.apply(params, batch["input_tokens"], deterministic=False,
                              rngs=rngs).logits
        return jax_cross_entropy(logits, batch["target_tokens"], batch["loss_masks"])

    @jax.jit
    def step(state, batch):
        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params, batch)
        state = state.apply_gradients(grads=grads)
        return state, dict(loss=loss, acc=acc, gradient_norm=optax.global_norm(grads),
                           param_norm=optax.global_norm(state.params),
                           learning_rate=info["learning_rate_schedule"](state.step))

    state = JaxTrainState.create(params={"params": _initial_params(fields)}, tx=tx,
                                 apply_fn=None)
    for i in range(steps):
        state, _ = step(state, _batch(i))
    return step, state


def _casts(state):
    """Shard functions that cast each loaded leaf to the target's dtype, as
    the JAX trainer's do."""
    return jax.tree_util.tree_map(lambda t: lambda v: jnp.asarray(v, t.dtype), state)


def _port_state(structure):
    fields = STRUCTURES[structure][0]
    cfg = LLaMAConfig.from_dict(dict(BASE, **fields))
    model = LLaMAForCausalLM(cfg, dtype=torch.float32, param_dtype=torch.float32, device="cpu")
    return train.create_train_state(model, _opt(structure))


def _ckpt_config(float_dtype, save_optimizer_state=True):
    return dict(float_dtype=float_dtype, save_optimizer_state=save_optimizer_state)


def _flat_numpy(tree):
    out = {}
    for k, v in flatten_dict(to_state_dict(tree)).items():
        v = np.asarray(jax.device_get(v))
        out[k] = v.astype(np.float32) if v.dtype.name == "bfloat16" else v
    return out


@pytest.mark.parametrize("float_dtype", [None, "bf16"])
@pytest.mark.parametrize("structure", sorted(STRUCTURES))
def test_train_state_round_trips_with_jax(tmp_path, structure, float_dtype):
    step, jstate = _jax_run(structure)
    steps = STRUCTURES[structure][2]
    state = _port_state(structure)

    def check_loaded(state):
        assert state.optimizer.count == int(jstate.opt_state.gradient_step if STRUCTURES[
            structure][1] > 1 else jstate.opt_state[1][0].count)

    _round_trip(tmp_path, step, jstate, state, steps, float_dtype, _batch(steps), check_loaded)


def _round_trip(tmp_path, step, jstate, state, steps, float_dtype, batch, check_loaded=None):
    """The JAX checkpointer's train state of `jstate` (after `steps`) loads
    into the port's `state`, which writes the same bytes back (and the same
    params milestone); the next step on `batch` from that file matches in
    both packages; the JAX checkpointer reads the state the port saves
    after it. `check_loaded(state)` runs right after the load."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    JaxCheckpointer(_ckpt_config(float_dtype), str(jdir)).save_all(
        jstate, None, metadata=dict(step=steps), dataset=dict(index=0))

    # the port loads it and writes the same bytes back
    kind = checkpoint.StreamingCheckpointer.load_into(
        f"trainstate::{jdir / 'streaming_train_state'}", state)
    assert kind == "trainstate" and state.step == steps
    if check_loaded is not None:
        check_loaded(state)
    port_ckpt = checkpoint.StreamingCheckpointer(_ckpt_config(float_dtype), str(pdir))
    port_ckpt.save_all(state, metadata=dict(step=steps), dataset=dict(index=0))
    want = (jdir / "streaming_train_state").read_bytes()
    assert (pdir / "streaming_train_state").read_bytes() == want

    # params only, as milestones: the same names and bytes
    identity = jax.tree_util.tree_map(lambda t: lambda v: v, jstate)
    JaxCheckpointer(_ckpt_config(float_dtype, False), str(jdir)).save_all(
        jstate, identity, metadata=dict(step=steps), dataset=dict(index=0), milestone=True)
    checkpoint.StreamingCheckpointer(_ckpt_config(float_dtype, False), str(pdir)).save_all(
        state, metadata=dict(step=steps), dataset=dict(index=0), milestone=True)
    assert sorted(p.name for p in jdir.iterdir()) == sorted(p.name for p in pdir.iterdir())
    name = f"streaming_params_{steps}"
    assert (pdir / name).read_bytes() == (jdir / name).read_bytes()

    # the next step from the same file, in both packages
    loaded, _ = JaxCheckpointer.load_trainstate_checkpoint(
        f"trainstate::{jdir / 'streaming_train_state'}", jstate, _casts(jstate))
    jnext, want_metrics = step(loaded, {k: jnp.asarray(v) for k, v in batch.items()})
    got = train.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for key, value in want_metrics.items():
        np.testing.assert_allclose(got[key].item(), float(value), rtol=1e-5, err_msg=key)
    want_params = convert_flax_params(jax.device_get(jnext.params), state.model.config)
    for n, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_params[n].numpy(), atol=1e-5,
                                   err_msg=n)

    # the JAX checkpointer reads what the port saves after that step
    port_ckpt.save_all(state)
    read, _ = JaxCheckpointer.load_trainstate_checkpoint(
        f"trainstate::{pdir / 'streaming_train_state'}", jnext, _casts(jnext))
    assert int(read.step) == steps + 1
    ours = {k: materialize(v) for k, v in
            checkpoint.flatten_dict(checkpoint.train_state_tree(state)).items()}
    theirs = _flat_numpy(read)
    assert list(theirs) == list(ours)
    for k, v in ours.items():
        v = torch.as_tensor(v).detach()
        if float_dtype and v.is_floating_point():
            v = v.to(torch.bfloat16)
        np.testing.assert_array_equal(theirs[k], v.float().numpy() if v.is_floating_point()
                                      else v.numpy(), err_msg=str(k))


# A VideoLLaMA's train state: name → (optimizer config, freeze_base, steps
# before the save). PaLM with --freeze_base runs inside MultiSteps (3
# micro-steps: mini_step 1 and a live accumulator of the trainable params)
VISION_OPT = dict(lr=1e-2, lr_warmup_steps=10000, weight_decay=1e-2)
VISION_CASES = {
    "adamw": (OPT, False, 2),
    "adamw_freeze_base": (OPT, True, 2),
    "palm_bf16_momentum": (dict(type="palm", palm_optimizer=dict(
        VISION_OPT, bf16_momentum=True)), False, 2),
    "palm_freeze_base_accumulate2": (dict(type="palm", accumulate_gradient_steps=2,
                                          palm_optimizer=VISION_OPT), True, 3),
}


def _vision_batch(seed):
    batch = _batch(seed)
    vision = np.zeros((B, S + 1), bool)
    vision[0, 3:19] = True
    codes = np.random.default_rng(seed).integers(0, 8194, (B, S + 1))
    toks = np.concatenate([batch["input_tokens"], batch["target_tokens"][:, -1:]], 1)
    toks = np.where(vision, codes, toks).astype(np.int32)
    return dict(batch, input_tokens=toks[:, :-1], target_tokens=toks[:, 1:],
                input_vision_masks=vision[:, :-1], target_vision_masks=vision[:, 1:])


@functools.cache
def _jax_vision_run(case):
    """(jitted JAX vision train step, the TrainState after the case's
    steps): `lwm_tpu/train.py`'s dual loss and optimizer with its masks."""
    config, freeze_base, steps = VISION_CASES[case]
    cfg = JaxVideoConfig(**BASE, scan_layers=True, mesh_dim=None, attn_impl="xla",
                         sample_mode="all")
    module = FlaxVideoLLaMAForCausalLMModule(cfg, dtype=jnp.float32)
    rngs = {"dropout": jax.random.PRNGKey(0), "params": jax.random.PRNGKey(1)}
    frozen = (get_frozen_base_mask(JaxVideoConfig.get_frozen_param_exclusions(True))
              if freeze_base else None)
    tx, info = JaxOptimizerFactory.get_optimizer(config, get_weight_decay_mask(()),
                                                 frozen_param_mask=frozen)

    def loss_fn(params, batch):
        vision_logits, text_logits = module.apply(
            params, batch["input_tokens"], batch["input_vision_masks"], deterministic=False,
            rngs=rngs).logits
        tvm, masks, tgt = batch["target_vision_masks"], batch["loss_masks"], batch[
            "target_tokens"]
        vision_loss, _ = jax_cross_entropy(vision_logits, jnp.where(tvm, tgt, 0), masks * tvm)
        text_loss, _ = jax_cross_entropy(text_logits, jnp.where(tvm, 0, tgt),
                                         masks * (1.0 - tvm))
        return 0.5 * (vision_loss + text_loss)

    @jax.jit
    def step(state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(state.params, batch)
        state = state.apply_gradients(grads=grads)
        return state, dict(loss=loss, gradient_norm=optax.global_norm(grads),
                           param_norm=optax.global_norm(state.params),
                           learning_rate=info["learning_rate_schedule"](state.step))

    params = jax.device_get(FlaxVideoLLaMAForCausalLM(cfg, input_shape=(1, 8), seed=0).params)
    state = JaxTrainState.create(params={"params": params}, tx=tx, apply_fn=None)
    for i in range(steps):
        state, _ = step(state, _vision_batch(i))
    return step, state


@pytest.mark.parametrize("case", sorted(VISION_CASES))
def test_vision_train_state_round_trips_with_jax(tmp_path, case):
    """A VideoLLaMA under AdamW or PaLM, with and without --freeze_base
    (the multi_transform state: moments of vte and vision_head alone)."""
    config, freeze_base, steps = VISION_CASES[case]
    step, jstate = _jax_vision_run(case)
    cfg = VideoLLaMAConfig.from_dict(dict(BASE, scan_layers=True))
    model = VideoLLaMAForCausalLM(cfg, dtype=torch.float32, param_dtype=torch.float32,
                                  device="cpu")
    state = train.create_train_state(model, config, freeze_base)
    _round_trip(tmp_path, step, jstate, state, steps, None, _vision_batch(steps))
    trainable = {"vte.weight", "vision_head.weight"}
    named = state.optimizer.named_state()
    moments = set().union(*(named[k] for k in state.optimizer.MOMENTS))
    assert moments == (trainable if freeze_base else set(dict(model.named_parameters())))
