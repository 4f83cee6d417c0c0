"""Vision-text training in the port (`lwm_tpu_torch.train` with a VideoLLaMA,
`utils.losses.dual_cross_entropy`, `optim.Palm`, `--freeze_base`) against
the JAX trainer's pieces run in-process on the CPU: the JAX VideoLLaMA
under `jax.value_and_grad` of `lwm_tpu/train.py`'s vision loss (`:273-296`,
written out here as the JAX trainer writes it), the JAX `OptimizerFactory`
(PaLM, and AdamW inside `optax.multi_transform` under a frozen-base mask)
and the JAX `JsonVisionDataset`. The tiny config has `scan_*_chunk_size`
below the sequence, so the JAX model takes its training branch.

Tolerances (as `tests/test_torch_train.py` and `test_torch_train_cli.py`
state them):
- fp32 loss and its metrics 1e-6 relative; each grad max |Δ| ≤ 1e-5 ·
  max |grad| (summation orders differ);
- bf16 compute: loss 2e-2, each grad cosine ≥ 0.99 to JAX's;
- optimizer steps: the metrics 1e-5 relative, params 1e-5 absolute, the
  moments 1e-4 of their largest element, but PaLM's momentum 1e-3 (each
  element of its update is g / sqrt(v), one step's lr·rms in size however
  small g is, so the fp32 noise of a tiny gradient element, ~1e-7 of the
  largest, becomes a relative error of that element: 1.8e-4 measured) and
  1e-2 in bf16 (one bf16 step is 0.4-0.8%: measured 5e-3); frozen params
  bit-unchanged in both;
- the CLI's `metrics.jsonl` against the JAX loop: the float metrics 1e-5
  relative, the `dataset_*` counters exactly.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training.train_state import TrainState as JaxTrainState
from transformers import AutoTokenizer

from lwm_tpu.checkpoint import StreamingCheckpointer as JaxCheckpointer
from lwm_tpu.data.vision import JsonVisionDataset as JaxJsonVisionDataset
from lwm_tpu.data.vision import VisionTextProcessor as JaxVisionTextProcessor
from lwm_tpu.models import FlaxVideoLLaMAForCausalLM
from lwm_tpu.models import VideoLLaMAConfig as JaxConfig
from lwm_tpu.models.vision_llama import FlaxVideoLLaMAForCausalLMModule
from lwm_tpu.optim import OptimizerFactory as JaxOptimizerFactory
from lwm_tpu.parallel.partition import get_frozen_base_mask, get_weight_decay_mask
from lwm_tpu.utils import cross_entropy_loss_and_accuracy as jax_cross_entropy
from lwm_tpu_torch import optim, train
from lwm_tpu_torch.models.vision_llama import VideoLLaMAConfig, VideoLLaMAForCausalLM
from lwm_tpu_torch.utils.convert import convert_flax_params, convert_optax_state, flax_param_path

TOKENIZER = "tests/fixtures/tokenizer"   # 457 tokens
MODEL = dict(vocab_size=457, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, max_sequence_length=64, scan_attention=True,
             scan_query_chunk_size=16, scan_key_chunk_size=16, scan_mlp=True,
             scan_mlp_chunk_size=16, scan_layers=True, param_scan_axis=0)
B, S, STEPS, PER_FRAME = 2, 32, 4, 8
LOSS_METRICS = ("vision_loss", "vision_acc", "text_loss", "text_acc")
FLOAT_METRICS = ("loss", *LOSS_METRICS, "learning_rate", "param_norm", "gradient_norm")
EXACT_METRICS = ("step", "dataset_file_loc", "dataset_example_index", "dataset_total_tokens")
ADAMW = dict(init_lr=1e-3, lr=1e-2, end_lr=1e-3, lr_warmup_steps=2, lr_decay_steps=10,
             weight_decay=0.1)
# lr(step) = (lr / 0.01) / sqrt(max(step, warmup)): 0.01 a step here, and the
# scheduled decay -(weight_decay / 1e-4)·lr² = -0.01 of each param a step
PALM = dict(lr=1e-2, lr_warmup_steps=10000, weight_decay=1e-2)
# name: (optimizer config, weight-decay exclusions)
OPTIMIZERS = {
    "adamw": (dict(adamw_optimizer=ADAMW), ()),
    "palm": (dict(type="palm", palm_optimizer=PALM), ()),
    "palm_masked_bf16_accumulate2": (dict(
        type="palm", accumulate_gradient_steps=2,
        palm_optimizer=dict(PALM, bf16_momentum=True)), ("norm",)),
}
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _jax_config():
    return JaxConfig(**MODEL, mesh_dim=None, attn_impl="xla", sample_mode="all")


@functools.cache
def _jax_params():
    return {"params": jax.device_get(FlaxVideoLLaMAForCausalLM(
        _jax_config(), input_shape=(1, 8), seed=0).params)}


def _jax_loss_fn(dtype="fp32", chunk=None):
    """`lwm_tpu/train.py`'s vision `compute_loss` on a tiny VideoLLaMA."""
    module = FlaxVideoLLaMAForCausalLMModule(_jax_config(), dtype=DTYPES[dtype][0])
    rngs = {"dropout": jax.random.PRNGKey(0), "params": jax.random.PRNGKey(1)}

    def loss_fn(params, batch):
        vision_logits, text_logits = module.apply(
            params, batch["input_tokens"], batch["input_vision_masks"], deterministic=False,
            rngs=rngs).logits
        tvm = batch["target_vision_masks"]
        vision_loss, vision_acc = jax_cross_entropy(
            vision_logits, jnp.where(tvm, batch["target_tokens"], 0),
            batch["loss_masks"] * tvm, chunk_size=chunk)
        text_loss, text_acc = jax_cross_entropy(
            text_logits, jnp.where(tvm, 0, batch["target_tokens"]),
            batch["loss_masks"] * (1.0 - tvm), chunk_size=chunk)
        return 0.5 * (vision_loss + text_loss), dict(
            vision_loss=vision_loss, vision_acc=vision_acc, text_loss=text_loss,
            text_acc=text_acc)

    return loss_fn


@functools.cache
def _jax_grad_fn(dtype, chunk):
    return jax.jit(jax.value_and_grad(_jax_loss_fn(dtype, chunk), has_aux=True))


@functools.cache
def _jax_step(name, freeze_base):
    """(tx, the jitted JAX train step: grads, update and the trainer's
    metrics) of optimizer `name`, frozen-base masked with `freeze_base`."""
    config, exclusions = OPTIMIZERS[name]
    frozen = get_frozen_base_mask(JaxConfig.get_frozen_param_exclusions(True)) if (
        freeze_base) else None
    tx, info = JaxOptimizerFactory.get_optimizer(config, get_weight_decay_mask(exclusions),
                                                 frozen_param_mask=frozen)
    loss_fn = _jax_loss_fn()

    @jax.jit
    def step(state, batch):
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params, batch)
        state = state.apply_gradients(grads=grads)
        return state, dict(loss=loss, **aux, gradient_norm=optax.global_norm(grads),
                           param_norm=optax.global_norm(state.params),
                           learning_rate=info["learning_rate_schedule"](state.step))

    return tx, step


def _port_model(dtype=torch.float32, **kw):
    cfg = VideoLLaMAConfig.from_dict(dict(MODEL, **kw))
    model = VideoLLaMAForCausalLM(cfg, dtype=dtype, param_dtype=torch.float32, device="cpu")
    model.load_state_dict(convert_flax_params(_jax_params(), cfg))
    return model


def _batch(seed):
    """Row 0: text around a span of VQ codes (vision inputs and targets);
    row 1: text alone (no vision targets). Loss masks drop ~20%."""
    rng = np.random.default_rng(seed)
    vision = np.zeros((B, S + 1), bool)
    vision[0, 5:22] = True
    toks = rng.integers(0, 457, (B, S + 1))
    toks[vision] = rng.integers(0, 8194, int(vision.sum()))
    masks = (rng.random((B, S)) > 0.2).astype(np.float32)
    return dict(input_tokens=toks[:, :-1].astype(np.int32),
                target_tokens=toks[:, 1:].astype(np.int32), loss_masks=masks,
                input_vision_masks=vision[:, :-1], target_vision_masks=vision[:, 1:])


def _cosine(a, b):
    a, b = a.reshape(-1).double(), b.reshape(-1).double()
    return float(a @ b / (a.norm() * b.norm()))


@pytest.mark.parametrize("dtype,chunk", [("fp32", None), ("fp32", 8), ("bf16", None)])
def test_dual_loss_and_grads_match_jax(dtype, chunk):
    batch = _batch(0)
    (want_loss, want_aux), want_grads = _jax_grad_fn(dtype, chunk)(
        _jax_params(), {k: jnp.asarray(v) for k, v in batch.items()})
    model = _port_model(DTYPES[dtype][1])
    loss, aux = train.compute_loss(model, {k: torch.from_numpy(v) for k, v in batch.items()},
                                   loss_chunk_size=chunk or 0)
    loss.backward()
    assert aux.keys() == set(LOSS_METRICS)
    want = convert_flax_params(jax.device_get(want_grads), model.config)
    assert want.keys() == dict(model.named_parameters()).keys()
    if dtype == "bf16":
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=2e-2)
        for name, p in model.named_parameters():
            assert _cosine(p.grad, want[name]) >= 0.99, name
        return
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    for key in LOSS_METRICS:
        np.testing.assert_allclose(aux[key].item(), float(want_aux[key]), rtol=1e-6, err_msg=key)
    assert aux["vision_loss"].item() > 0 and aux["text_loss"].item() > 0
    for name, p in model.named_parameters():
        err = (p.grad - want[name]).abs().max().item()
        assert err <= 1e-5 * want[name].abs().max().item(), (name, err)


STEP_CASES = {   # name: (optimizer, freeze_base, steps)
    "palm_masked_bf16_accumulate2": ("palm_masked_bf16_accumulate2", False, 4),
    "adamw_freeze_base": ("adamw", True, 3),
    "palm_freeze_base": ("palm", True, 3),
}


def _port_state(name, freeze_base):
    config, exclusions = OPTIMIZERS[name]
    model = _port_model()
    if not exclusions:
        return train.create_train_state(model, config, freeze_base)
    decay = optim.none_match(exclusions)
    return train.TrainState(model, optim.OptimizerFactory.get_optimizer(
        config, model.named_parameters(),
        lambda n: decay(flax_param_path(n, model.config)),
        train.param_masks(model.config, freeze_base)[1],
        param_block=lambda n: flax_param_path(n, model.config)))


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_optimizer_steps_match_jax(case):
    """Whole train steps, one batch a step: the metrics every step, then
    the params and the optimizer's state, against the JAX step."""
    name, freeze_base, steps = STEP_CASES[case]
    tx, step = _jax_step(name, freeze_base)
    jstate = JaxTrainState.create(params=_jax_params(), tx=tx, apply_fn=None)
    state = _port_state(name, freeze_base)
    model = state.model
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for i in range(steps):
        batch = _batch(i + 1)
        jstate, want = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        got = train.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=1e-5,
                                       err_msg=f"step {i} {key}")
    want_params = convert_flax_params(jax.device_get(jstate.params), model.config)
    trainable = {n for n in before if "vte" in n or "vision_head" in n}
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_params[n].numpy(), atol=1e-5,
                                   err_msg=n)
        if freeze_base:
            assert torch.equal(p.detach(), before[n]) == (n not in trainable), n
            assert (n in trainable) or np.array_equal(want_params[n].numpy(), before[n].numpy())
    ours = state.optimizer.named_state()
    theirs = convert_optax_state(jax.device_get(jstate.opt_state), model.config)
    assert ours.keys() == theirs.keys()
    for key in ("count", "mini_step", "gradient_step"):
        assert ours[key] == theirs[key], key
    bf16 = state.optimizer.mu_dtype == torch.bfloat16
    for key in (*state.optimizer.MOMENTS, "acc"):
        assert ours[key].keys() == theirs[key].keys(), key
        if freeze_base:
            assert set(theirs[key]) <= trainable
        tol = (1e-2 if bf16 else 1e-3) if key == "ema" else 1e-4
        for n, t in theirs[key].items():
            assert ours[key][n].dtype == t.dtype, (key, n)
            err = (ours[key][n].float() - t.float()).abs().max().item()
            assert err <= tol * max(t.abs().max().item(), 1e-30), (key, n, err)


def test_palm_schedule_and_state_layout():
    """The PaLM schedule in fp32 (lr / 0.01 / sqrt(max(step, warmup))), and a
    bf16 momentum of the port's optimizer loads back as bf16."""
    config = dict(PALM, lr=3e-3, lr_warmup_steps=5)
    _, info = JaxOptimizerFactory.get_optimizer(dict(type="palm", palm_optimizer=config))
    port = optim.palm_schedule(config["lr"], config["lr_warmup_steps"])
    for count in (0, 1, 5, 6, 17, 10000):
        assert port(count) == float(info["learning_rate_schedule"](jnp.int32(count)))
    state = _port_state("palm_masked_bf16_accumulate2", False)
    named = dict(state.optimizer.named_state(), ema={"wte.weight": torch.ones(457, 64)})
    state.optimizer.load_named_state(named)
    assert state.optimizer.state[state.model.wte.weight]["ema"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="cannot load"):
        train.create_train_state(_port_model(), OPTIMIZERS["adamw"][0]).optimizer.\
            load_named_state(named)


# ---------------------------------------------------------------- the CLI


def _line(rng, i):
    words = "the magic number is in haystack needle model world sky blue green".split()
    frames = int(rng.integers(1, 4))
    return {"vision": rng.integers(0, 8192, frames * PER_FRAME).tolist(),
            "caption": " ".join(rng.choice(words, rng.integers(2, 12))) + f" {i}",
            "spec": ["[caption],vision", "vision,caption"][i % 2]}


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The vision JSONL from a seed and the JAX init as a params stream."""
    d = tmp_path_factory.mktemp("cli_vision")
    rng = np.random.default_rng(0)
    with open(d / "train.jsonl", "w") as f:
        for i in range(60):
            f.write(json.dumps(_line(rng, i)) + "\n")
    JaxCheckpointer.save_train_state_to_file(_jax_params()["params"], str(d / "init"))
    return d


def _argv(workdir, name, optimizer, *extra, total_steps=STEPS, mode="no_pad"):
    config, _ = OPTIMIZERS[optimizer]
    opt = [f"--optimizer.type={config.get('type', 'adamw')}"]
    for group in ("adamw_optimizer", "palm_optimizer"):
        opt += [f"--optimizer.{group}.{k}={v}" for k, v in config.get(group, {}).items()]
    data = {"type": "json_vision", "vision_text_processor.fields_from_example": "spec",
            "vision_text_processor.n_tokens_per_frame": PER_FRAME,
            "json_vision_dataset.path": workdir / "train.jsonl",
            "json_vision_dataset.seq_length": S, "json_vision_dataset.batch_size": B,
            "json_vision_dataset.mode": mode}
    return [
        "--device=cpu", "--dtype=fp32", "--modality=vision,text", f"--tokenizer={TOKENIZER}",
        f"--update_llama_config=dict({','.join(f'{k}={v!r}' for k, v in MODEL.items())})",
        f"--load_checkpoint=params::{workdir / 'init'}", f"--total_steps={total_steps}",
        "--log_freq=1", f"--logger.output_dir={workdir}", f"--logger.experiment_id={name}",
        "--logger.append_uuid=False", *opt,
        *[f"--train_dataset.{k}={v}" for k, v in data.items()], *extra,
    ]


def _records(workdir, name):
    with open(workdir / name / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


@functools.cache
def _jax_loop(path, optimizer, freeze_base, eval_steps):
    """The JAX trainer's step on the JAX vision dataset's batches: per-step
    metrics as `lwm_tpu.train.main` logs them at log_freq 1."""
    tx, step = _jax_step(optimizer, freeze_base)
    tok = AutoTokenizer.from_pretrained(TOKENIZER)
    eval_fn = jax.jit(_jax_loss_fn())

    def dataset():
        proc = JaxVisionTextProcessor(JaxVisionTextProcessor.get_default_config(dict(
            fields_from_example="spec", n_tokens_per_frame=PER_FRAME)), tok)
        config = JaxJsonVisionDataset.get_default_config(dict(
            path=path, seq_length=S, batch_size=B, mode="no_pad", return_local_batch=True))
        return iter(JaxJsonVisionDataset(config, tok, proc, node_info=dict(dp_node_size=1,
                                                                           dp_node_rank=0)))

    state = JaxTrainState.create(params=_jax_params(), tx=tx, apply_fn=None)
    train_batches, eval_batches = dataset(), dataset()
    out = []
    for i in range(STEPS):
        batch, dataset_metrics = next(train_batches)
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        record = {"step": i + 1, **{k: float(v) for k, v in metrics.items()}, **dataset_metrics}
        if eval_steps:
            evals = [eval_fn(state.params, {k: jnp.asarray(v) for k, v in
                                            next(eval_batches)[0].items()})
                     for _ in range(eval_steps)]
            record["eval_loss"] = float(np.mean([float(e[0]) for e in evals]))
            for key in LOSS_METRICS:
                record[f"eval_{key}"] = float(np.mean([float(e[1][key]) for e in evals]))
        out.append(record)
    return out


def assert_records_match(got, want, float_keys=FLOAT_METRICS):
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        for key in EXACT_METRICS:
            assert g[key] == w[key], (g["step"], key)
        for key in float_keys:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5,
                                       err_msg=f"step {g['step']} {key}")
        assert g["dataset_average_tps"] > 0 and "_time" in g


def test_dual_loss_chunks_2048_rows_by_default(monkeypatch):
    """`train.compute_loss` of a VideoLLaMA at loss_chunk_size 0 takes
    the dual loss's log-softmax in 2048-row chunks (each recomputed in the
    backward: 2 heads × 2 chunks at 4096 rows), with the whole sequence's
    loss, metrics and gradients (fp32, 1e-6 relative)."""
    from lwm_tpu_torch.utils import losses

    rng = np.random.default_rng(3)
    b, s = 1, 4096
    vision_logits = torch.tensor(rng.standard_normal((b, s, 24)), dtype=torch.float32,
                                 requires_grad=True)
    text_logits = torch.tensor(rng.standard_normal((b, s, 40)), dtype=torch.float32,
                               requires_grad=True)
    vision = rng.random((b, s)) < 0.5
    batch = dict(input_tokens=torch.zeros((b, s), dtype=torch.int32),
                 input_vision_masks=torch.from_numpy(vision),
                 target_vision_masks=torch.from_numpy(vision),
                 target_tokens=torch.from_numpy(np.where(vision, rng.integers(0, 24, (b, s)),
                                                         rng.integers(0, 40, (b, s)))),
                 loss_masks=torch.from_numpy((rng.random((b, s)) < 0.9).astype(np.float32)))

    class Dual(torch.nn.Module):
        takes_vision_masks = True

        def forward(self, tokens, vision_masks):
            return type("Out", (), dict(vision_logits=vision_logits, lm_logits=text_logits))

    chunks = []
    real = losses.checkpoint
    monkeypatch.setattr(losses, "checkpoint", lambda fn, *a, **kw: (
        chunks.append(a[0].shape[1]), real(fn, *a, **kw))[1])
    loss, metrics = train.compute_loss(Dual(), batch)
    grads = torch.autograd.grad(loss, (vision_logits, text_logits))
    assert chunks == [2048, 2048, 2048, 2048]
    want, want_metrics = losses.dual_cross_entropy(
        vision_logits, text_logits, batch["target_tokens"], batch["loss_masks"],
        batch["target_vision_masks"], chunk_size=s)
    want_grads = torch.autograd.grad(want, (vision_logits, text_logits))
    np.testing.assert_allclose(loss.item(), want.item(), rtol=1e-6)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(metrics[k].item(), v.item(), rtol=1e-6, err_msg=k)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("seq", [4096, 5000])
def test_dual_loss_chunk_of_the_whole_sequence_goes_in_2048_row_pieces(seq, monkeypatch):
    """A `loss_chunk_size` that covers the whole sequence (ROADMAP C5)
    takes the dual loss's log-softmax in 2048-row pieces (the last one
    ragged when 2048 does not divide the sequence), each recomputed in the
    backward: loss, metrics and gradients equal those of 2048-row chunks
    (fp32 rounding) and JAX's whole-sequence loss (1e-5)."""
    from lwm_tpu_torch.utils import losses

    rng = np.random.default_rng(seq)
    vision_logits = rng.standard_normal((1, seq, 24)).astype(np.float32)
    text_logits = rng.standard_normal((1, seq, 40)).astype(np.float32)
    vision = rng.random((1, seq)) < 0.5
    tokens = np.where(vision, rng.integers(0, 24, (1, seq)), rng.integers(0, 40, (1, seq)))
    valid = (rng.random((1, seq)) < 0.9).astype(np.float32)

    def port(chunk):
        vl, tl = (torch.tensor(x, requires_grad=True) for x in (vision_logits, text_logits))
        loss, metrics = losses.dual_cross_entropy(
            vl, tl, torch.from_numpy(tokens), torch.from_numpy(valid),
            torch.from_numpy(vision), chunk_size=chunk)
        return loss, metrics, torch.autograd.grad(loss, (vl, tl))

    pieces = []
    real = losses.checkpoint
    monkeypatch.setattr(losses, "checkpoint", lambda fn, *a, **kw: (
        pieces.append(a[0].shape[1]), real(fn, *a, **kw))[1])
    whole = port(seq)
    tail = seq % 2048
    assert pieces == 2 * ([2048] * (seq // 2048) + ([tail] if tail else []))

    def jax_loss(vl, tl):
        tvm = jnp.asarray(vision)
        v_loss, _ = jax_cross_entropy(vl, jnp.where(tvm, tokens, 0), valid * tvm)
        t_loss, _ = jax_cross_entropy(tl, jnp.where(tvm, 0, tokens), valid * (1.0 - tvm))
        return 0.5 * (v_loss + t_loss)

    want, want_grads = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(vision_logits), jnp.asarray(text_logits))
    np.testing.assert_allclose(whole[0].item(), float(want), rtol=1e-5)
    for g, w in zip(whole[2], want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-12)
    if seq % 2048 == 0:
        chunked = port(2048)
        np.testing.assert_allclose(whole[0].item(), chunked[0].item(), rtol=1e-6)
        for k, v in chunked[1].items():
            np.testing.assert_allclose(whole[1][k].item(), v.item(), rtol=1e-6, err_msg=k)
        for g, w in zip(whole[2], chunked[2]):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("freeze_base", [False, True])
@pytest.mark.parametrize("optimizer", ["adamw", "palm"])
def test_cli_metrics_match_jax_loop(workdir, optimizer, freeze_base):
    """4 steps of the CLI against the JAX loop. The AdamW run without
    --freeze_base also averages one eval batch in and passes
    --fused_lm_loss, which the vision loss does not read (as in JAX)."""
    name = f"{optimizer}_{freeze_base}"
    extra = [f"--freeze_base={freeze_base}"]
    evals = optimizer == "adamw" and not freeze_base
    if evals:
        extra += ["--eval_steps=1", "--fused_lm_loss=True", "--eval_dataset.type=json_vision",
                  "--eval_dataset.vision_text_processor.fields_from_example=spec",
                  f"--eval_dataset.vision_text_processor.n_tokens_per_frame={PER_FRAME}",
                  f"--eval_dataset.json_vision_dataset.path={workdir / 'train.jsonl'}",
                  f"--eval_dataset.json_vision_dataset.seq_length={S}",
                  f"--eval_dataset.json_vision_dataset.batch_size={B}",
                  "--eval_dataset.json_vision_dataset.mode=no_pad"]
    summary = train.main(_argv(workdir, name, optimizer, *extra))
    assert (summary["loaded"], summary["start_step"], summary["end_step"]) == ("params", 0, 4)
    want = _jax_loop(str(workdir / "train.jsonl"), optimizer, freeze_base, int(evals))
    keys = FLOAT_METRICS + (("eval_loss", *(f"eval_{k}" for k in LOSS_METRICS)) if evals
                            else ())
    assert_records_match(_records(workdir, name), want, keys)


def test_autoresume_continues_the_uninterrupted_run(workdir):
    """PaLM under --freeze_base, `pad` rows (a resume reads the
    uninterrupted run's batches): 2 steps and saves, the autoresume to 4,
    against 4 uninterrupted steps."""
    resume = ["--save_model_freq=2", "--autoresume=True", "--freeze_base=True",
              "--checkpointer.save_optimizer_state=True", "--checkpointer.float_dtype=fp32"]
    first = train.main(_argv(workdir, "resumed", "palm", *resume, total_steps=2, mode="pad"))
    assert first["loaded"] == "params"
    second = train.main(_argv(workdir, "resumed", "palm", *resume, mode="pad"))
    assert (second["loaded"], second["start_step"], second["end_step"]) == ("trainstate", 2, 4)
    train.main(_argv(workdir, "whole", "palm", "--freeze_base=True", mode="pad"))
    got, want = _records(workdir, "resumed"), _records(workdir, "whole")
    assert [r["step"] for r in got] == [1, 2, 3, 4]
    assert_records_match(got, want)


def test_cli_refuses_a_sampling_mode(workdir):
    argv = _argv(workdir, "refused", "adamw", total_steps=1)
    argv = [a.replace("param_scan_axis=0", "param_scan_axis=0,sample_mode='text'") for a in argv]
    with pytest.raises(ValueError, match="sample_mode='all'"):
        train.main(argv)
