"""The port's train step (lwm_tpu_torch.train, .optim, .utils.losses, the
model's training forward) against the JAX step on the CPU: the same
converted params and the same numpy batch go through `jax.value_and_grad`
of the JAX model + `cross_entropy_loss_and_accuracy` and the JAX
`OptimizerFactory` (built as `bench.py:145-176` builds its step), and
through `lwm_tpu_torch.train.train_step`.

The tiny config has `scan_*_chunk_size` below the sequence, so the JAX model
takes its training branch (`_ring_train` → `flash_attention`, the XLA path
on the CPU) and its chunked, rematerialized MLP, as the port does.

Tolerances, and why they hold:
- fp32 loss and accuracy: 1e-6 relative. Both frameworks compute the same
  fp32 ops; only summation orders differ (measured ~1e-7).
- fp32 grads: max |Δ| ≤ 1e-5 · max |grad| per parameter (measured ≤ 7e-6
  after two steps of drift, ≤ 1e-6 at the first step).
- bf16 compute (fp32 params): the two frameworks round to bf16 at
  different points (silu, the embedding gradient's scatter), so the loss
  holds 2e-2 and each grad holds cosine ≥ 0.99 to the JAX grad.
- AdamW: params after the steps 1e-5 absolute (lr ≤ 1e-2 times a
  normalized Adam step, from grads that agree to ~1e-6), moments 1e-4 of
  their largest element (they carry the grads' drift: measured ~1.5e-5);
  looser with a bf16 first moment (`BF16_MU_TOL`, reason beside it);
  the metrics 1e-5 relative, the learning rate 1e-6 relative (both compute
  the schedule in fp32, in the same order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training.train_state import TrainState as JaxTrainState

from lwm_tpu.models import FlaxLLaMAForCausalLM
from lwm_tpu.models import LLaMAConfig as JaxConfig
from lwm_tpu.optim import OptimizerFactory as JaxOptimizerFactory
from lwm_tpu.parallel.partition import get_weight_decay_mask
from lwm_tpu.utils import cross_entropy_loss_and_accuracy as jax_cross_entropy
from lwm_tpu_torch import optim, train
from lwm_tpu_torch.models.llama import LLaMAConfig, LLaMAForCausalLM
from lwm_tpu_torch.ops import flash
from lwm_tpu_torch.utils import losses
from lwm_tpu_torch.utils.convert import convert_flax_params, convert_optax_state

BASE = dict(
    vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
    num_attention_heads=4, max_sequence_length=64, scan_attention=True,
    scan_query_chunk_size=16, scan_key_chunk_size=16, scan_mlp=True, scan_mlp_chunk_size=16,
    scan_layers=False, remat_block="save_flash",
)
B, S = 2, 32
MODEL_CASES = {"mha": dict(), "gqa": dict(num_key_value_heads=2)}


def _batch(seed=0, vocab=128):
    rng = np.random.default_rng(seed)
    masks = (rng.random((B, S)) > 0.2).astype(np.float32)
    masks[1, :4] = 0.0
    return dict(
        input_tokens=rng.integers(0, vocab, (B, S)).astype(np.int32),
        target_tokens=rng.integers(0, vocab, (B, S)).astype(np.int32),
        loss_masks=masks,
    )


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.cache
def _jax_side(case, dtype="fp32"):
    """(params as numpy, jitted value_and_grad of the JAX loss)."""
    cfg = JaxConfig(**BASE, **MODEL_CASES[case], mesh_dim=None, attn_impl="xla")
    jm = FlaxLLaMAForCausalLM(cfg, input_shape=(1, 8), seed=0)
    module = type(jm.module)(cfg, dtype={"fp32": jnp.float32, "bf16": jnp.bfloat16}[dtype])
    rngs = {"dropout": jax.random.PRNGKey(0), "params": jax.random.PRNGKey(1)}

    def loss_fn(params, batch):
        logits = module.apply(params, batch["input_tokens"], deterministic=False, rngs=rngs).logits
        loss, acc = jax_cross_entropy(logits, batch["target_tokens"], batch["loss_masks"])
        return loss, dict(acc=acc)

    params = {"params": jax.device_get(jm.params)}
    return params, jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _port_model(case, params, dtype=torch.float32, **kw):
    cfg = LLaMAConfig.from_dict(dict(BASE, **MODEL_CASES[case], **kw))
    model = LLaMAForCausalLM(cfg, dtype=dtype, param_dtype=torch.float32, device="cpu")
    model.load_state_dict(convert_flax_params(params, cfg))
    return model


def _cosine(a, b):
    a, b = a.reshape(-1).double(), b.reshape(-1).double()
    return float(a @ b / (a.norm() * b.norm()))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_loss_and_grads_match_jax(case, dtype):
    params, grad_fn = _jax_side(case, dtype)
    batch = _batch()
    (want_loss, want_aux), want_grads = grad_fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = _port_model(case, params, {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype])
    loss, aux = train.compute_loss(model, _torch_batch(batch))
    loss.backward()
    want = convert_flax_params(jax.device_get(want_grads), model.config)
    assert want.keys() == dict(model.named_parameters()).keys()
    if dtype == "fp32":
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
        np.testing.assert_allclose(aux["acc"].item(), float(want_aux["acc"]), rtol=1e-6)
        for name, p in model.named_parameters():
            err = (p.grad - want[name]).abs().max().item()
            assert err <= 1e-5 * want[name].abs().max().item(), (name, err)
    else:
        np.testing.assert_allclose(loss.item(), float(want_loss), atol=2e-2)
        for name, p in model.named_parameters():
            assert p.grad.dtype == torch.float32
            assert _cosine(p.grad, want[name]) >= 0.99, name


SCHEDULES = {
    "defaults": dict(),
    "run_train_text": dict(lr=8e-5, end_lr=8e-5, lr_warmup_steps=5, lr_decay_steps=200),
    "no_warmup": dict(init_lr=1e-3, lr=1e-2, lr_warmup_steps=0, lr_decay_steps=10),
    "short": dict(init_lr=1e-4, lr=1e-2, end_lr=1e-3, lr_warmup_steps=3, lr_decay_steps=8),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule_matches_optax(name):
    c = optim.OptimizerFactory.get_default_config({"adamw_optimizer": SCHEDULES[name]})
    c = c["adamw_optimizer"]
    ours = optim.warmup_cosine_decay_schedule(
        c["init_lr"], c["lr"], c["lr_warmup_steps"], c["lr_decay_steps"], c["end_lr"]
    )
    theirs = optax.warmup_cosine_decay_schedule(
        c["init_lr"], c["lr"], c["lr_warmup_steps"], c["lr_decay_steps"], c["end_lr"]
    )
    for step in [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 50, 199, 200, 1000, 2000, 600000]:
        np.testing.assert_allclose(ours(step), float(theirs(step)), rtol=1e-6, atol=1e-12)


FP32_STATE_TOL = (1e-5, 1e-4)   # params atol, moments relative to their max
# a bf16 mu rounds the grads' ~1e-6 drift to a whole bf16 step (2^-8 of the
# element) in a few elements; the next update then differs by up to
# lr·2^-8 per step there (measured: 4 of 8192 embedding entries, 7e-5)
BF16_MU_TOL = (2e-4, 1e-2)
ADAMW_CASES = {
    # name: (model case, optimizer config, train steps, tolerances)
    "clip_active": ("mha", dict(adamw_optimizer=dict(
        init_lr=1e-3, lr=1e-2, end_lr=1e-3, lr_warmup_steps=2, lr_decay_steps=10,
        weight_decay=0.1, clip_gradient=0.5)), 3, FP32_STATE_TOL),
    "bf16_momentum_gqa": ("gqa", dict(adamw_optimizer=dict(
        init_lr=1e-3, lr=1e-2, lr_warmup_steps=1, lr_decay_steps=10, weight_decay=0.1,
        clip_gradient=100.0, bf16_momentum=True)), 3, BF16_MU_TOL),
    "accumulate_2": ("mha", dict(accumulate_gradient_steps=2, adamw_optimizer=dict(
        init_lr=1e-3, lr=1e-2, lr_warmup_steps=2, lr_decay_steps=10, weight_decay=0.1)), 4,
        FP32_STATE_TOL),
}


@pytest.mark.parametrize("name", sorted(ADAMW_CASES))
def test_adamw_steps_match_optax(name):
    """Whole train steps on one batch per step: losses and metrics every
    step, then params and optimizer state, against the JAX step."""
    case, opt_cfg, steps, (param_tol, moment_tol) = ADAMW_CASES[name]
    params, grad_fn = _jax_side(case)
    tx, info = JaxOptimizerFactory.get_optimizer(opt_cfg, get_weight_decay_mask(()))
    apply = jax.jit(lambda st, g: st.apply_gradients(grads=g))
    jstate = JaxTrainState.create(params=params, tx=tx, apply_fn=None)
    model = _port_model(case, params)
    state = train.create_train_state(model, opt_cfg)
    for i in range(steps):
        batch = _batch(seed=i)
        (loss, aux), grads = grad_fn(jstate.params, {k: jnp.asarray(v) for k, v in batch.items()})
        jstate = apply(jstate, grads)
        want = dict(loss=loss, acc=aux["acc"], gradient_norm=optax.global_norm(grads),
                    param_norm=optax.global_norm(jstate.params),
                    learning_rate=info["learning_rate_schedule"](jstate.step))
        got = train.train_step(state, _torch_batch(batch))
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=1e-5,
                                       err_msg=f"step {i} {key}")
    assert state.step == int(jstate.step) == steps
    want_params = convert_flax_params(jax.device_get(jstate.params), model.config)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_params[n].numpy(), atol=param_tol,
                                   err_msg=n)
    ours, theirs = state.optimizer.named_state(), convert_optax_state(
        jax.device_get(jstate.opt_state), model.config
    )
    for key in ("count", "mini_step", "gradient_step"):
        assert ours[key] == theirs[key], key
    for key in ("mu", "nu", "acc"):
        assert ours[key].keys() == theirs[key].keys(), key
        for n, t in theirs[key].items():
            assert ours[key][n].dtype == t.dtype, (key, n)
            scale = max(t.abs().max().item(), 1e-30)
            err = (ours[key][n].float() - t.float()).abs().max().item()
            assert err <= moment_tol * scale, (key, n)


def test_first_step_with_default_schedule_moves_nothing():
    """init_lr = 0 and the schedule read before the update: step 1 leaves
    every param as it was, weight decay included (optax's semantics)."""
    params, _ = _jax_side("mha")
    model = _port_model("mha", params)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = train.create_train_state(model, {"adamw_optimizer": dict(weight_decay=0.1)})
    metrics = train.train_step(state, _torch_batch(_batch()))
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), before[n]), n
    assert metrics["learning_rate"].item() == pytest.approx(0.01 / 2000, rel=1e-4)
    train.train_step(state, _torch_batch(_batch()))
    assert not torch.equal(model.wte.weight.detach(), before["wte.weight"])


@pytest.mark.parametrize("remat", ["none", "nothing_saveable", "save_flash"])
def test_remat_blocks_give_identical_grads(remat, monkeypatch):
    """Every remat_block gives the same grads bit for bit; K1 runs once per
    layer per step, twice under nothing_saveable (the backward replays the
    block), and save_flash keeps its (out, lse) like `save_only_these_names`."""
    params, _ = _jax_side("gqa")
    calls = []
    fwd = flash.flash_attention_fwd
    monkeypatch.setattr(flash, "flash_attention_fwd", lambda *a, **kw: calls.append(1) or fwd(*a, **kw))
    batch = _torch_batch(_batch())

    def grads(remat_block):
        model = _port_model("gqa", params, remat_block=remat_block)
        calls.clear()
        loss, _ = train.compute_loss(model, batch)
        loss.backward()
        return {n: p.grad for n, p in model.named_parameters()}, len(calls)

    want, _ = grads("none")
    got, n_fwd = grads(remat)
    layers = BASE["num_hidden_layers"]
    assert n_fwd == (2 * layers if remat == "nothing_saveable" else layers)
    for n in want:
        assert torch.equal(got[n], want[n]), n


def test_chunked_loss_matches_whole():
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.standard_normal((2, 32, 50)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, 50, (2, 32)))
    valid = torch.from_numpy((rng.random((2, 32)) > 0.3).astype(np.float32))
    want = jax_cross_entropy(jnp.asarray(logits.numpy()), jnp.asarray(tokens.numpy()),
                             jnp.asarray(valid.numpy()))
    grads = []
    for chunk in (None, 8):
        x = logits.clone().requires_grad_()
        loss, acc = losses.cross_entropy_loss_and_accuracy(x, tokens, valid, chunk_size=chunk)
        loss.backward()
        grads.append(x.grad)
        np.testing.assert_allclose(loss.item(), float(want[0]), rtol=1e-6)
        np.testing.assert_allclose(acc.item(), float(want[1]), rtol=1e-6)
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), atol=1e-7)
    metrics = losses.average_metrics([dict(a=torch.tensor(1.0)), dict(a=torch.tensor(3.0))])
    assert metrics["a"].item() == 2.0


def test_training_refuses_what_is_not_ported():
    params, _ = _jax_side("mha")
    ids = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="dropout"):
        _port_model("mha", params, attn_pdrop=0.1)(ids)
    with pytest.raises(NotImplementedError, match="segment ids"):
        _port_model("mha", params)(ids, segment_ids=ids)
    with pytest.raises(NotImplementedError, match="remat_block"):
        LLaMAConfig(remat_block="offload_flash")
    with pytest.raises(NotImplementedError, match="palm"):
        optim.OptimizerFactory.get_optimizer({"type": "palm"}, [])
    with pytest.raises(KeyError):
        optim.OptimizerFactory.get_default_config({"adamw_optimizer": {"learning_rate": 1}})
    with torch.no_grad():   # not training: dropout is inactive, the forward runs
        _port_model("mha", params, resid_pdrop=0.1)(ids)


def test_build_model_config():
    cfg = train.build_model_config(
        "7b", llama=dict(scan_mlp_chunk_size=512, hidden_size=8),
        update_llama_config=dict(num_hidden_layers=2, theta=5e6),
    )
    assert (cfg.hidden_size, cfg.num_hidden_layers, cfg.theta) == (4096, 2, 5e6)
    assert cfg.scan_mlp_chunk_size == 512
    assert train.build_model_config(llama=dict(hidden_size=8)).hidden_size == 8
