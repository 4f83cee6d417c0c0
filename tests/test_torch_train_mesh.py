"""The port's train step on a dp × sp mesh against the JAX train step.

The port's ranks (gloo, the CPU, spawned once for the module's runs at
world 4) train one step of a tiny model at dp 2 × sp 2 (`2,1,1,2`) and at sp
4 (`1,1,1,4`), each in the contiguous and the striped layout: every rank
reads the same global batch and keeps its part (`data.text.shard_batch`),
attention runs over the ring, the loss is the whole batch's, the weights
are sharded over sp and their gradients reduce-scattered over it
(`parallel.fsdp`), gathered whole for the comparison. JAX trains the same step on the forced
CPU mesh `2,1,1,4` (its ring under `shard_map`, the batch permuted as its
loader permutes it for the striped layout). The step's math does not depend
on the mesh: loss, accuracy, the step's metrics, every gradient and every
parameter after one AdamW step hold at fp32 1e-5 (gradients max |Δ| ≤
1e-5 · max |grad|, parameters 1e-5 absolute, as `tests/test_torch_train.py`
holds the one-device step), and every rank ends with the same whole
parameters.
A VideoLLaMA (the vision trainer's model: only its embedding and heads
differ) trains on the same ring: its dual loss, metrics and gradients on
the mesh hold to the one-device port's (itself held to JAX by
`tests/test_torch_train_vision.py`) at 1e-5. A CLI run at world 2 (sp 2,
striped; 2 of the spawn's ranks, regrouped) saves a checkpoint that the
one-device port loads, and only rank 0 writes its metrics and checkpoints.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training.train_state import TrainState as JaxTrainState

from lwm_tpu.models import FlaxLLaMAForCausalLM
from lwm_tpu.models import LLaMAConfig as JaxConfig
from lwm_tpu.ops.striped import stripe_permute as jax_stripe_permute
from lwm_tpu.optim import OptimizerFactory as JaxOptimizerFactory
from lwm_tpu.parallel.partition import get_weight_decay_mask
from lwm_tpu.utils import cross_entropy_loss_and_accuracy as jax_cross_entropy
from lwm_tpu_torch import checkpoint, train
from lwm_tpu_torch.models.llama import LLaMAConfig, LLaMAForCausalLM
from lwm_tpu_torch.models.vision_llama import VideoLLaMAConfig, VideoLLaMAForCausalLM
from lwm_tpu_torch.utils.convert import convert_flax_params

import torch_dist_workers as workers

MODEL = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_sequence_length=64,
             scan_attention=True, scan_query_chunk_size=16, scan_key_chunk_size=16,
             scan_mlp=True, scan_mlp_chunk_size=8, scan_layers=False, remat_block="save_flash")
B, S = 2, 32
# step 1 at lr 1e-4: Adam's first update is about ±lr an element, ten times
# PARAM_TOL, so a wrong update shows; at 1e-3 an element whose gradient is
# near 0 moved 1.5e-5 apart (its sign's noise, not the step's math)
OPTIMIZER = dict(adamw_optimizer=dict(init_lr=1e-4, lr=1e-4, end_lr=1e-5, lr_warmup_steps=1,
                                      lr_decay_steps=10, weight_decay=0.1))
RUNS = [("2,1,1,2", "contiguous"), ("2,1,1,2", "striped"), ("1,1,1,4", "contiguous"),
        ("1,1,1,4", "striped")]
VISION_MODEL = dict(MODEL, vocab_size=457, num_key_value_heads=None, scan_layers=True)
VISION_RUNS = [("1,1,1,4", "striped"), ("2,1,1,2", "contiguous")]
CLI_MODEL = dict(MODEL, vocab_size=256, num_key_value_heads=None)
REL = 1e-5
# parameters after the AdamW step, absolute (`tests/test_torch_train.py`
# FP32_STATE_TOL): Adam's update m/√v is about lr in size whatever the
# gradient's, so where a gradient element is near 0 its summation-order
# noise moves the update by a part of lr
PARAM_TOL = 1e-5


def _batch():
    rng = np.random.default_rng(3)
    masks = (rng.random((B, S)) > 0.2).astype(np.float32)
    masks[1, :4] = 0.0
    toks = rng.integers(0, 128, (B, S + 1)).astype(np.int32)
    return dict(input_tokens=toks[:, :-1], target_tokens=toks[:, 1:], loss_masks=masks,
                input_vision_masks=np.zeros((B, S), bool),
                target_vision_masks=np.zeros((B, S), bool))


def _vision_batch():
    """Row 0: text around a span of VQ codes; row 1: text alone."""
    rng = np.random.default_rng(4)
    vision = np.zeros((B, S + 1), bool)
    vision[0, 5:22] = True
    toks = rng.integers(0, 457, (B, S + 1))
    toks[vision] = rng.integers(0, 8194, int(vision.sum()))
    return dict(input_tokens=toks[:, :-1].astype(np.int32),
                target_tokens=toks[:, 1:].astype(np.int32),
                loss_masks=(rng.random((B, S)) > 0.2).astype(np.float32),
                input_vision_masks=vision[:, :-1], target_vision_masks=vision[:, 1:])


def _jax_params():
    cfg = JaxConfig(**MODEL, mesh_dim=None, attn_impl="xla")
    return {"params": jax.device_get(FlaxLLaMAForCausalLM(cfg, input_shape=(1, 8),
                                                          seed=0).params)}


def _cli_argv(work):
    """The CLI run's flags at world 2 (sp 2, striped) over a JSONL it writes."""
    data = work / "train.jsonl"
    rng = np.random.default_rng(0)
    words = ["the", "magic", "number", "needle", "haystack", "model", "is", "blue"]
    with open(data, "w") as f:
        for _ in range(60):
            f.write(json.dumps({"text": " ".join(rng.choice(words, rng.integers(4, 30)))}) + "\n")
    return ["--device=cpu", "--mesh_dim=1,1,1,2", "--sp_layout=striped", "--total_steps=2",
            "--log_freq=1", "--save_model_freq=2", "--dtype=fp32",
            f"--update_llama_config=dict({', '.join(f'{k}={v!r}' for k, v in CLI_MODEL.items())})",
            "--tokenizer=tests/fixtures/tokenizer", "--train_dataset.type=json",
            "--train_dataset.text_processor.fields=text",
            f"--train_dataset.json_dataset.path={data}",
            f"--train_dataset.json_dataset.seq_length={S}",
            f"--train_dataset.json_dataset.batch_size={B}",
            f"--logger.output_dir={work / 'out'}", "--logger.experiment_id=mesh",
            "--optimizer.adamw_optimizer.init_lr=1e-3"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX init, the port's four runs, its vision runs and the CLI run
    (one spawn of 4 ranks, the CLI on 2 of them) and the JAX step on
    `2,1,1,4` in each layout."""
    work = tmp_path_factory.mktemp("train_mesh")
    params = _jax_params()
    cfg = LLaMAConfig.from_dict(MODEL)
    torch.save(convert_flax_params(params, cfg), work / "init.pt")
    batch = _batch()
    np.savez(work / "batch.npz", **batch)
    vision = VideoLLaMAForCausalLM(VideoLLaMAConfig.from_dict(VISION_MODEL), device="cpu")
    vision.init_weights(torch.Generator().manual_seed(5))
    torch.save(vision.state_dict(), work / "vision_init.pt")
    np.savez(work / "vision_batch.npz", **_vision_batch())

    workers.spawn(workers.train_mesh_all_ranks, 4, work, dict(
        config=MODEL, runs=RUNS, optimizer=OPTIMIZER,
        vision=dict(config=VISION_MODEL, runs=VISION_RUNS),
        port2=workers._free_port(), cli=_cli_argv(work)))
    return params, batch, work


def _jax_step(params, batch, layout):
    cfg = JaxConfig(**MODEL, mesh_dim="2,1,1,4", sp_layout=layout, attn_impl="xla")
    module = FlaxLLaMAForCausalLM(cfg, input_shape=(1, 8), seed=0, _do_init=False).module
    mesh = JaxConfig.get_jax_mesh("2,1,1,4")
    if layout == "striped":
        batch = {k: jax_stripe_permute(v, 4, axis=1) for k, v in batch.items()}
    rngs = {"dropout": jax.random.PRNGKey(0)}

    def loss_fn(p):
        logits = module.apply(p, jnp.asarray(batch["input_tokens"]), deterministic=False,
                              rngs=rngs).logits
        loss, acc = jax_cross_entropy(logits, jnp.asarray(batch["target_tokens"]),
                                      jnp.asarray(batch["loss_masks"]))
        return loss, acc

    tx, info = JaxOptimizerFactory.get_optimizer(OPTIMIZER, get_weight_decay_mask(()))
    with mesh:
        (loss, acc), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        state = JaxTrainState.create(params=params, tx=tx, apply_fn=None)
        state = jax.jit(lambda s, g: s.apply_gradients(grads=g))(state, grads)
    metrics = dict(loss=loss, acc=acc, gradient_norm=optax.global_norm(grads),
                   param_norm=optax.global_norm(state.params),
                   learning_rate=info["learning_rate_schedule"](state.step))
    return jax.device_get(grads), jax.device_get(state.params), jax.device_get(metrics)


_JAX_STEPS = {}   # layout → JAX's (grads, params, metrics) on 2,1,1,4


@pytest.mark.parametrize("i", range(len(RUNS)), ids=[f"{m}_{lay}" for m, lay in RUNS])
def test_mesh_train_step_matches_jax(runs, i):
    params, batch, work = runs
    mesh_dim, layout = RUNS[i]
    if layout not in _JAX_STEPS:   # JAX's step depends on the layout alone (its mesh is fixed)
        _JAX_STEPS[layout] = _jax_step(params, batch, layout)
    grads, new_params, metrics = _JAX_STEPS[layout]
    cfg = LLaMAConfig.from_dict(MODEL)
    got = np.load(work / f"run{i}.npz")
    np.testing.assert_allclose(float(got["loss"]), float(metrics["loss"]), rtol=REL)
    np.testing.assert_allclose(float(got["acc"]), float(metrics["acc"]), rtol=REL)
    for key, want in metrics.items():
        np.testing.assert_allclose(float(got[f"metric/{key}"]), float(want), rtol=REL,
                                   err_msg=key)
    for name, w in convert_flax_params(grads, cfg).items():
        a, w = got[f"grad/{name}"], w.numpy()
        assert np.abs(a - w).max() <= REL * np.abs(w).max(), name
    for name, w in convert_flax_params(new_params, cfg).items():
        np.testing.assert_allclose(got[f"param/{name}"], w.numpy(), atol=PARAM_TOL, err_msg=name)
    sums = [np.load(work / f"run{i}_rank{r}_sum.npy") for r in range(4)]
    assert all(np.array_equal(s, sums[0]) for s in sums), "ranks hold different parameters"


@pytest.mark.parametrize("i", range(len(VISION_RUNS)),
                         ids=[f"{m}_{lay}" for m, lay in VISION_RUNS])
def test_mesh_vision_step_matches_one_device(runs, i):
    _, _, work = runs
    model = VideoLLaMAForCausalLM(VideoLLaMAConfig.from_dict(VISION_MODEL), device="cpu")
    model.load_state_dict(torch.load(work / "vision_init.pt"))
    batch = {k: torch.from_numpy(v) for k, v in _vision_batch().items()}
    loss, aux = train.compute_loss(model, batch)
    loss.backward()
    got = np.load(work / f"vision{i}.npz")
    np.testing.assert_allclose(float(got["loss"]), loss.item(), rtol=REL)
    for key, want in aux.items():
        np.testing.assert_allclose(float(got[f"metric/{key}"]), want.item(), rtol=REL,
                                   err_msg=key)
    for name, p in model.named_parameters():
        a, w = got[f"grad/{name}"], p.grad.numpy()
        assert np.abs(a - w).max() <= REL * max(np.abs(w).max(), 1e-30), name


def test_cli_on_two_ranks_saves_a_checkpoint_the_one_device_port_loads(runs):
    _, _, work = runs
    dirs = {(work / f"cli_rank{r}.txt").read_text() for r in range(2)}
    assert len(dirs) == 1, "the ranks disagree on the output directory"
    out = dirs.pop()
    records = [json.loads(line) for line in open(f"{out}/metrics.jsonl")]
    assert [r["step"] for r in records] == [1, 2]        # one rank wrote them
    assert all(np.isfinite(r["loss"]) for r in records)
    cfg = train.build_model_config(update_llama_config=dict(CLI_MODEL, vocab_size=457))
    model = LLaMAForCausalLM(cfg, device="cpu")
    state = train.create_train_state(model)
    assert checkpoint.StreamingCheckpointer.load_into(f"params::{out}/streaming_params",
                                                      state) == "params"
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 457, (1, S)))
    with torch.no_grad():
        assert torch.isfinite(model(ids)).all()
