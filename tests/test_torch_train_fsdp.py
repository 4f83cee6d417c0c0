"""The port's fsdp × tp training against the one-device port and JAX's
sharded step.

The port's ranks (gloo, the CPU; `tests/torch_dist_workers.py`) are spawned
once for the module: 4 ranks train a tiny model (hidden 64, 4 heads, 2 kv
heads, 2 layers: every split dim divides by 4) for 2 steps at `1,2,2,1`,
`1,1,2,2` in both sp layouts, `2,2,1,1` and, with PaLM over scanned
blocks, `1,4,1,1`, and a VideoLLaMA one step at `1,2,2,1`: the weights and
the optimizer's moments sharded over fsdp × sp and split over tp by the
rule table (`parallel.fsdp`, `parallel.partition`), the blocks
tensor-parallel. Every step's metrics, params after the step and moments
hold at fp32 1e-5 to the one-device port's (itself held to JAX by
`tests/test_torch_train.py`), whose updates take the mesh's gradients and
whose steps after the first start from the mesh's params and moments
(`_one_device`'s `resync`): metrics relative, moments max |Δ| ≤ 1e-5 ·
max |want|, params 1e-5 absolute. Each whole (gathered) gradient is held
to the same step in float64 (`_f64_grads`, from the same params): its max
|Δ| within 1e-5 of max |float64|, or within 1.25× the one-device fp32
port's own distance where that is larger. fp32 sums whose order depends on
the host's threads leave ~1e-5 of a gradient's max between two fp32 runs,
and Adam's first update turns float noise in a near-zero gradient into a
difference of up to lr: so neither run is held to the other's noise.
Each rank holds 1/(fsdp·sp) of a split leaf's tp-local elements, params and
moments alike; a leaf held whole over tp has one device's gradient (summed
over tp it would be twice that). A seeded init on a mesh gives the
one-device init. JAX's sharded train step (the train state partitioned by
`get_partition_rules` as `lwm_tpu/train.py:322-359` partitions it, the
batch as `PS(("dp", "fsdp"), "sp")`) at `!1,-1,2,2` on the forced 8-device
CPU mesh is held to the port's `1,1,2,2` step at 1e-5.

2 of them then regroup and run the training CLI at `1,2,1,1` for 4 steps, saving its
train state at step 2, which the one-device CLI loads and trains to the
same steps 3-4 and the same final state; and a one-device train state
loads into a `1,1,2,1` run that trains 2 steps with `--fused_lm_loss`, held
to the one-device port's. The loader places leaf i before it reads leaf
i + 1. A dim that does not split raises, naming the leaf; dropout still
raises.
"""

import json
import types

import torch.nn.functional as F

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training.train_state import TrainState as JaxTrainState
from jax.sharding import PartitionSpec as PS

from lwm_tpu.models import FlaxLLaMAForCausalLM
from lwm_tpu.models import LLaMAConfig as JaxConfig
from lwm_tpu.optim import OptimizerFactory as JaxOptimizerFactory
from lwm_tpu.parallel.partition import (
    get_weight_decay_mask, match_partition_rules, specs_to_shardings, with_sharding_constraint,
)
from lwm_tpu.utils import cross_entropy_loss_and_accuracy as jax_cross_entropy
from lwm_tpu_torch import checkpoint, train
from lwm_tpu_torch.models import llama as llama_module
from lwm_tpu_torch.models.llama import LLaMAConfig, LLaMAForCausalLM
from lwm_tpu_torch.models.vision_llama import VideoLLaMAConfig, VideoLLaMAForCausalLM
from lwm_tpu_torch.parallel import fsdp, partition
from lwm_tpu_torch.utils.convert import convert_flax_params, leaf_params

import torch_dist_workers as workers

MODEL = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_sequence_length=64,
             scan_attention=True, scan_query_chunk_size=16, scan_key_chunk_size=16,
             scan_mlp=True, scan_mlp_chunk_size=8, scan_layers=False, remat_block="save_flash")
VISION_MODEL = dict(MODEL, scan_layers=True)
B, S = 4, 32
# lr 1e-4: Adam's first update is about ±lr an element, ten times PARAM_TOL
# (`tests/test_torch_train_mesh.py`)
ADAMW = dict(adamw_optimizer=dict(init_lr=1e-4, lr=1e-4, end_lr=1e-5, lr_warmup_steps=1,
                                  lr_decay_steps=10, weight_decay=0.1))
# lr(count) = 0.1 / √100 = 0.01: an update of about 0.01 · rms(p) ≈ 2e-4
PALM = dict(type="palm", palm_optimizer=dict(lr=1e-3, lr_warmup_steps=100, weight_decay=0.1))
RUNS = [
    dict(name="fsdp_tp", mesh="1,2,2,1", layout="contiguous", kind="text", config=MODEL,
         optimizer=ADAMW, steps=2),
    dict(name="tp_sp", mesh="1,1,2,2", layout="contiguous", kind="text", config=MODEL,
         optimizer=ADAMW, steps=2),
    dict(name="tp_sp_striped", mesh="1,1,2,2", layout="striped", kind="text", config=MODEL,
         optimizer=ADAMW, steps=2),
    dict(name="dp_fsdp", mesh="2,2,1,1", layout="contiguous", kind="text", config=MODEL,
         optimizer=ADAMW, steps=2),
    dict(name="fsdp4_palm", mesh="1,4,1,1", layout="contiguous", kind="text",
         config=dict(MODEL, scan_layers=True), optimizer=PALM, steps=2),
    dict(name="vision_fsdp_tp", mesh="1,2,2,1", layout="contiguous", kind="vision",
         config=VISION_MODEL, optimizer=ADAMW, steps=1),
]
INITS = {"init_text": dict(mesh="1,2,2,1", kind="text", config=MODEL, seed=7),
         "init_vision": dict(mesh="1,4,1,1", kind="vision", config=VISION_MODEL, seed=8)}
REL = 1e-5
PARAM_TOL = 1e-5
FLOOR_RATIO = 1.25   # a gradient's distance to float64 against the one-device fp32 port's
FUSED_STEPS = 2


def _text_batch():
    rng = np.random.default_rng(3)
    masks = (rng.random((B, S)) > 0.2).astype(np.float32)
    masks[1, :4] = 0.0
    toks = rng.integers(0, 128, (B, S + 1)).astype(np.int32)
    return dict(input_tokens=toks[:, :-1], target_tokens=toks[:, 1:], loss_masks=masks,
                input_vision_masks=np.zeros((B, S), bool),
                target_vision_masks=np.zeros((B, S), bool))


def _vision_batch():
    """Rows 0 and 2: text around a span of VQ codes; rows 1 and 3: text."""
    rng = np.random.default_rng(4)
    vision = np.zeros((B, S + 1), bool)
    vision[0, 5:22] = vision[2, 9:30] = True
    toks = rng.integers(0, 128, (B, S + 1))
    toks[vision] = rng.integers(0, 8194, int(vision.sum()))
    return dict(input_tokens=toks[:, :-1].astype(np.int32),
                target_tokens=toks[:, 1:].astype(np.int32),
                loss_masks=(rng.random((B, S)) > 0.2).astype(np.float32),
                input_vision_masks=vision[:, :-1], target_vision_masks=vision[:, 1:])


def _jax_params():
    cfg = JaxConfig(**MODEL, mesh_dim=None, attn_impl="xla")
    return {"params": jax.device_get(FlaxLLaMAForCausalLM(cfg, input_shape=(1, 8),
                                                          seed=0).params)}


def _model(kind, config, **kw):
    if kind == "vision":
        return VideoLLaMAForCausalLM(VideoLLaMAConfig.from_dict(config), device="cpu", **kw)
    return LLaMAForCausalLM(LLaMAConfig.from_dict(config), device="cpu", **kw)


def _one_device(work, run, trainstate=None, fused=False, resync=None):
    """The one-device port's `train_steps_record` of a run (from the saved
    init, or from `trainstate`). With `resync` (a mesh run's record) each
    update takes the mesh run's gradients (each held to float64 apart) and
    each step after the first starts from the mesh run's params and
    moments: Adam's first update g/√v · lr is ±lr for any gradient, PaLM's
    ±lr·rms, and both divide an element's gradient by its own history
    after, so an element whose gradient is within float noise of 0 takes
    its sign or size from the summation order; given the same gradients,
    the sharded optimizer (its block rms and clip norm summed over the
    ranks) must give one device's update."""
    model = _model(run["kind"], run["config"])
    state = train.create_train_state(model, run["optimizer"])
    if trainstate is None:
        model.load_state_dict(torch.load(work / f"{run['kind']}_init.pt"))
    else:
        checkpoint.StreamingCheckpointer.load_into(trainstate, state)
    batch = {k: torch.from_numpy(v) for k, v in dict(np.load(
        work / f"{run['kind']}_batch.npz")).items()}

    def between(i):
        opt = state.optimizer
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(torch.from_numpy(resync[f"s{i}/param/{n}"]))
            for p, st in opt.state.items():
                for k in st:
                    st[k] = torch.from_numpy(resync[f"s{i}/moment/{k}/{opt.names[p]}"]).to(
                        st[k].dtype)

    def same_grads(i):
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.grad.copy_(torch.from_numpy(resync[f"s{i}/grad/{n}"]))

    return workers.train_steps_record(state, batch, run["steps"], fused,
                                      *((None, None) if resync is None else (between, same_grads)))


def _cli_argv(out, mesh_dim, steps, *extra):
    model_cfg = dict(MODEL, vocab_size=256, num_key_value_heads=None)
    return ["--device=cpu", f"--mesh_dim={mesh_dim}", f"--total_steps={steps}", "--log_freq=1",
            "--save_milestone_freq=2", "--dtype=fp32",
            "--checkpointer.save_optimizer_state=True", "--checkpointer.float_dtype=fp32",
            f"--update_llama_config=dict({', '.join(f'{k}={v!r}' for k, v in model_cfg.items())})",
            "--tokenizer=tests/fixtures/tokenizer", "--train_dataset.type=json",
            "--train_dataset.text_processor.fields=text",
            f"--train_dataset.json_dataset.path={out.parent / 'train.jsonl'}",
            f"--train_dataset.json_dataset.seq_length={S}",
            f"--train_dataset.json_dataset.batch_size={B}",
            f"--logger.output_dir={out}", "--logger.experiment_id=run",
            "--optimizer.adamw_optimizer.init_lr=1e-3",
            # an example a row: a resumed loader gives the uninterrupted run's batches
            "--train_dataset.json_dataset.pad=True", *extra]


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The inits and batches, the one-device train state and the CLI's
    JSONL, then the spawn (4 ranks: the runs and the seeded inits; 2 of
    them: the CLI and the `1,1,2,1` load)."""
    work = tmp_path_factory.mktemp("train_fsdp")
    params = _jax_params()
    torch.save(convert_flax_params(params, LLaMAConfig.from_dict(MODEL)), work / "text_init.pt")
    np.savez(work / "text_batch.npz", **_text_batch())
    vision = _model("vision", VISION_MODEL)
    vision.init_weights(torch.Generator().manual_seed(5))
    torch.save(vision.state_dict(), work / "vision_init.pt")
    np.savez(work / "vision_batch.npz", **_vision_batch())
    # a one-device train state after one step, in fp32
    model = _model("text", MODEL)
    state = train.create_train_state(model, ADAMW)
    model.load_state_dict(torch.load(work / "text_init.pt"))
    train.train_step(state, {k: torch.from_numpy(v) for k, v in _text_batch().items()})
    (work / "ts").mkdir()
    checkpoint.StreamingCheckpointer(dict(save_optimizer_state=True, float_dtype="fp32"),
                                     str(work / "ts")).save_all(state)
    rng = np.random.default_rng(0)
    words = ["the", "magic", "number", "needle", "haystack", "model", "is", "blue"]
    with open(work / "train.jsonl", "w") as f:
        for _ in range(80):
            f.write(json.dumps({"text": " ".join(rng.choice(words, rng.integers(4, 30)))}) + "\n")
    workers.spawn(workers.fsdp_all_ranks, 4, work, dict(
        runs=RUNS, init=INITS, port2=workers._free_port(), checkpoint=dict(
            argv=_cli_argv(work / "mesh", "1,2,1,1", 4), config=MODEL, optimizer=ADAMW,
            trainstate=f"trainstate::{work / 'ts' / 'streaming_train_state'}",
            steps=FUSED_STEPS)))
    return work, params


def _attend_f64(q, k, v):
    """Causal softmax attention in float64; q [b, s, h, d], k, v [b, s,
    h_kv, d] (kv head i serves query heads i·g .. i·g + g − 1)."""
    s, h, d = q.shape[1:]
    k, v = (x.repeat_interleave(h // x.shape[2], 2) for x in (k, v))
    x = torch.einsum("bqhd,bkhd->bhqk", q, k) * d ** -0.5
    x = x.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1), float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(x, -1), v)


def _ce_f64(logits, tokens, valid):
    """`cross_entropy_loss_and_accuracy`'s loss in float64."""
    lp = torch.log_softmax(logits, -1).gather(-1, tokens.long()[..., None])[..., 0]
    lp = torch.where(valid > 0, lp, 0.0)
    return -(lp.sum(-1) / valid.double().sum(-1).clamp_min(1e-10)).mean()


def _f64_grads(run, params, batch):
    """The gradients {name: float64} of one train step of the run's model
    at `params` ({name: fp32 array}, the whole model) on the global
    `batch`: the model's arithmetic in plain torch, every operation in
    float64 (LLaMA, or VideoLLaMA with its dual loss); RoPE from the
    model's own fp32 table."""
    model = _model(run["kind"], run["config"])
    cfg, f64 = model.config, torch.float64
    w = {n: torch.from_numpy(np.asarray(params[n])).to(f64).requires_grad_()
         for n, _ in model.named_parameters()}
    ids = torch.from_numpy(batch["input_tokens"]).long()
    b, s = ids.shape
    h, d = cfg.num_attention_heads, cfg.head_dim
    cos, sin = (t.to(f64)[:, :, None, :] for t in llama_module.take_freqs(
        model._rope_table(ids.device), torch.arange(s).expand(b, s)))

    def norm(x, name):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + cfg.rms_norm_eps) * w[name]

    def rope(x):
        x0, x1 = x.reshape(*x.shape[:-1], -1, 2).unbind(-1)
        return torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], -1).reshape(x.shape)

    def dense(x, name):
        return x @ w[name].T

    if model.takes_vision_masks:
        vm = torch.from_numpy(batch["input_vision_masks"]).bool()
        x = torch.where(vm[..., None], w["vte.weight"][torch.where(vm, ids, 0)],
                        w["wte.weight"][torch.where(vm, 0, ids)])
    else:
        x = w["wte.weight"][ids]
    for i in range(cfg.num_hidden_layers):
        p = f"h.{i}."
        y = norm(x, p + "attention_norm.weight")
        q = rope(dense(y, p + "attention.wq.weight").view(b, s, h, d))
        k = rope(dense(y, p + "attention.wk.weight").view(b, s, -1, d))
        v = dense(y, p + "attention.wv.weight").view(b, s, -1, d)
        x = x + dense(_attend_f64(q, k, v).reshape(b, s, h * d), p + "attention.wo.weight")
        y = norm(x, p + "ffn_norm.weight")
        x = x + dense(F.silu(dense(y, p + "feed_forward.w1.weight"))
                      * dense(y, p + "feed_forward.w3.weight"), p + "feed_forward.w2.weight")
    x = norm(x, "ln_f.weight")
    logits = x @ w["lm_head.weight" if "lm_head.weight" in w else "wte.weight"].T
    tokens = torch.from_numpy(batch["target_tokens"])
    valid = torch.from_numpy(batch["loss_masks"]).double()
    if model.takes_vision_masks:
        tv = torch.from_numpy(batch["target_vision_masks"]).bool()
        vlogits = x @ w["vision_head.weight" if "vision_head.weight" in w else "vte.weight"].T
        loss = 0.5 * (_ce_f64(vlogits, torch.where(tv, tokens, 0), valid * tv)
                      + _ce_f64(logits, torch.where(tv, 0, tokens), valid * ~tv))
    else:
        loss = _ce_f64(logits, tokens, valid)
    loss.backward()
    return {n: t.grad.numpy() for n, t in w.items()}


def _f64_steps(work, run, got):
    """{step: float64 gradients} of a mesh run's record `got`, each from
    the params that step started from: the saved init at step 0, the mesh
    run's params after the step before (as the resynced one-device run)."""
    batch = dict(np.load(work / f"{run['kind']}_batch.npz"))
    init = {n: t.numpy() for n, t in torch.load(work / f"{run['kind']}_init.pt").items()}
    out = {}
    for i in range(run["steps"]):
        params = init if i == 0 else {k.split("/", 2)[2]: got[k] for k in got.files
                                      if k.startswith(f"s{i - 1}/param/")}
        out[i] = _f64_grads(run, params, batch)
    return out


def _hold(got, want, what, f64=None):
    """Metrics relative, moments by max, params absolute; grads to the
    float64 step `f64` ({step: {name: grad}}) within REL of its max, or
    within FLOOR_RATIO × the one-device port's own distance to it (without
    `f64`, to the one-device port's by max)."""
    keys = {k for k in want if not k.startswith("numel")}
    assert keys == {k for k in got.files if not k.startswith("numel")}, what
    for key in sorted(keys):
        a, w = np.asarray(got[key]), np.asarray(want[key])
        if "/metric/" in key:
            np.testing.assert_allclose(float(a), float(w), rtol=REL, err_msg=f"{what} {key}")
        elif "/param/" in key:
            np.testing.assert_allclose(a, w, atol=PARAM_TOL, err_msg=f"{what} {key}")
        elif "/grad/" in key and f64 is not None:
            step, _, name = key.split("/", 2)
            g64 = f64[int(step[1:])][name]
            top = max(np.abs(g64).max(), 1e-300)
            mesh, one = (np.abs(x.astype(np.float64) - g64).max() / top for x in (a, w))
            assert mesh <= max(REL, FLOOR_RATIO * one), (
                f"{what} {key}: max|Δ| from float64 {mesh:.3e} of its max, the one-device "
                f"port's {one:.3e}")
        else:
            assert np.abs(a - w).max() <= REL * max(np.abs(w).max(), 1e-30), f"{what} {key}"


_ONE_DEVICE = {}   # run name → the one-device port's record


def _one_device_of(work, run):
    """The one-device reference of a run, from the mesh's gradients and
    states (`_one_device`'s `resync`), made once."""
    if run["name"] not in _ONE_DEVICE:
        got = np.load(work / f"{run['name']}.npz")
        _ONE_DEVICE[run["name"]] = _one_device(work, run, resync=got)
    return _ONE_DEVICE[run["name"]]


@pytest.mark.parametrize("run", RUNS, ids=[r["name"] for r in RUNS])
def test_mesh_steps_match_one_device(work, run):
    work, _ = work
    got = np.load(work / f"{run['name']}.npz")
    _hold(got, _one_device_of(work, run), run["name"], _f64_steps(work, run, got))


@pytest.mark.parametrize("run", RUNS, ids=[r["name"] for r in RUNS])
def test_each_rank_holds_its_shard(work, run):
    """A split leaf's param and moments hold 1/(fsdp·sp) of its tp-local
    elements on every rank; a leaf held whole over tp (wte, vte, the
    norms) all of them."""
    work, _ = work
    dims = dict(zip(("dp", "fsdp", "tp", "sp"), map(int, run["mesh"].split(","))))
    model = _model(run["kind"], run["config"])
    whole = {n: p.numel() for n, p in model.named_parameters()}
    for r in range(int(np.prod(list(dims.values())))):
        got = np.load(work / f"{run['name']}_rank{r}.npz")
        for name, n in whole.items():
            tp = dims["tp"] if partition.tp_dim(name) is not None else 1
            shard = (dims["fsdp"] * dims["sp"] if partition.shard_dim(name) is not None else 1)
            assert int(got[f"numel/{name}"]) == n // (tp * shard), (r, name)
            for key in ("mu", "nu", "v", "ema"):
                if f"numel_moment/{key}/{name}" in got.files:
                    assert int(got[f"numel_moment/{key}/{name}"]) == n // (tp * shard), (r, name)
        assert any(k.startswith("numel_moment/") for k in got.files)


def test_tp_replicated_leaves_are_not_summed_over_tp(work):
    """The norms and the embedding are whole over tp: their gradients are
    one device's on the tp mesh, and twice that would fail."""
    work, _ = work
    run = RUNS[0]
    got, want = np.load(work / f"{run['name']}.npz"), _one_device_of(work, run)
    for name in ("wte.weight", "ln_f.weight", "h.0.attention_norm.weight", "h.1.ffn_norm.weight"):
        a, w = got[f"s0/grad/{name}"], want[f"s0/grad/{name}"]
        assert np.abs(a - w).max() <= REL * np.abs(w).max(), name
        assert np.abs(2 * a - w).max() > 0.5 * np.abs(w).max(), name


@pytest.mark.parametrize("name", sorted(INITS))
def test_seeded_init_on_a_mesh_is_the_one_device_init(work, name):
    work, _ = work
    init = INITS[name]
    model = _model(init["kind"], init["config"])
    model.init_weights(torch.Generator().manual_seed(init["seed"]))
    got = np.load(work / f"{name}.npz")
    for n, p in model.named_parameters():
        np.testing.assert_array_equal(got[n], p.detach().numpy(), err_msg=n)


def _jax_sharded_step(params, batch):
    """JAX's train step at `!1,-1,2,2`, the train state and the batch
    sharded as `lwm_tpu/train.py:322-359` shards them."""
    mesh_dim = "!1,-1,2,2"
    cfg = JaxConfig(**MODEL, mesh_dim=mesh_dim, attn_impl="xla")
    module = FlaxLLaMAForCausalLM(cfg, input_shape=(1, 8), seed=0, _do_init=False).module
    mesh = JaxConfig.get_jax_mesh(mesh_dim)
    tx, info = JaxOptimizerFactory.get_optimizer(ADAMW, get_weight_decay_mask(()))
    rngs = {"dropout": jax.random.PRNGKey(0)}

    def init(p):
        return JaxTrainState.create(params=p, tx=tx, apply_fn=None)

    shardings = specs_to_shardings(match_partition_rules(
        JaxConfig.get_partition_rules(False), jax.eval_shape(init, params)), mesh)
    batch_sharding = specs_to_shardings(PS(("dp", "fsdp"), "sp"), mesh)

    def step(state, batch):
        batch = with_sharding_constraint(batch, PS(("dp", "fsdp"), "sp"))

        def loss_fn(p):
            logits = module.apply(p, batch["input_tokens"], deterministic=False,
                                  rngs=rngs).logits
            return jax_cross_entropy(logits, batch["target_tokens"], batch["loss_masks"])

        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        state = state.apply_gradients(grads=grads)
        return state, grads, dict(loss=loss, acc=acc, gradient_norm=optax.global_norm(grads),
                                  param_norm=optax.global_norm(state.params),
                                  learning_rate=info["learning_rate_schedule"](state.step))

    batch = {k: jnp.asarray(batch[k]) for k in ("input_tokens", "target_tokens", "loss_masks")}
    with mesh:
        state = jax.jit(init, out_shardings=shardings)(params)
        state, grads, metrics = jax.jit(
            step, in_shardings=(shardings, batch_sharding),
            out_shardings=(shardings, shardings.params, None))(state, batch)
    return jax.device_get(grads), jax.device_get(state.params), jax.device_get(metrics)


def test_tp_sp_step_matches_jax_sharded_step(work):
    work, params = work
    grads, new_params, metrics = _jax_sharded_step(params, _text_batch())
    got = np.load(work / "tp_sp.npz")
    cfg = LLaMAConfig.from_dict(MODEL)
    for key, want in metrics.items():
        np.testing.assert_allclose(float(got[f"s0/metric/{key}"]), float(want), rtol=REL,
                                   err_msg=key)
    for name, w in convert_flax_params(grads, cfg).items():
        a, w = got[f"s0/grad/{name}"], w.numpy()
        assert np.abs(a - w).max() <= REL * np.abs(w).max(), name
    for name, w in convert_flax_params(new_params, cfg).items():
        np.testing.assert_allclose(got[f"s0/param/{name}"], w.numpy(), atol=PARAM_TOL,
                                   err_msg=name)


def test_cli_state_from_a_mesh_trains_on_one_device(work):
    """The `1,2,1,1` CLI run's step-2 train state, loaded by the one-device
    CLI with its dataset state, trains to the mesh run's steps 3-4 and its
    final state."""
    work, _ = work
    dirs = {(work / f"cli_rank{r}.txt").read_text() for r in range(2)}
    assert len(dirs) == 1, "the ranks disagree on the output directory"
    mesh_out = dirs.pop()
    one = train.main(_cli_argv(
        work / "one", "1,-1,1,1", 4,
        f"--load_checkpoint=trainstate::{mesh_out}/streaming_train_state_2",
        f"--load_dataset_state={mesh_out}/dataset_2.pkl"))
    assert one["start_step"] == 2 and one["end_step"] == 4
    records = {r["step"]: r for r in map(json.loads, open(f"{mesh_out}/metrics.jsonl"))}
    assert sorted(records) == [1, 2, 3, 4]   # rank 0 alone wrote them
    for r in map(json.loads, open(f"{one['output_dir']}/metrics.jsonl")):
        want = records[r["step"]]
        for key in ("loss", "acc", "gradient_norm", "param_norm", "learning_rate"):
            np.testing.assert_allclose(r[key], want[key], rtol=REL, err_msg=key)
        for key in ("dataset_file_loc", "dataset_example_index", "dataset_total_tokens"):
            assert r[key] == want[key], key
    a = checkpoint.load_stream(f"{mesh_out}/streaming_train_state_4")
    b = checkpoint.load_stream(f"{one['output_dir']}/streaming_train_state_4")
    assert a.keys() == b.keys()
    for key in a:
        x, y = np.asarray(a[key], np.float64), np.asarray(b[key], np.float64)
        assert x.shape == y.shape, key
        assert np.abs(x - y).max() <= 2 * PARAM_TOL + REL * np.abs(y).max(), key


def test_one_device_state_loads_into_tp_and_trains_fused(work):
    work, _ = work
    run = dict(RUNS[0], steps=FUSED_STEPS)
    want = _one_device(work, run, f"trainstate::{work / 'ts' / 'streaming_train_state'}",
                       fused=True)
    got = np.load(work / "loaded.npz")
    assert int(got["step"]) == 1 + FUSED_STEPS
    _hold(_Files(got), want, "fused 1,1,2,1")


class _Files(dict):
    """`np.load`'s `.files` over a dict of arrays."""

    def __init__(self, npz):
        super().__init__({k: npz[k] for k in npz.files if k != "step"})
        self.files = list(self)


def test_loader_places_each_leaf_before_reading_the_next(work, monkeypatch):
    work, _ = work
    model = _model("text", MODEL)
    state = train.create_train_state(model, ADAMW)
    named = dict(model.named_parameters())
    real, seen = checkpoint.iter_stream, []

    def placed(key, leaf):
        if key[:2] == ("params", "params"):
            pairs = [(named[n], v) for n, v in leaf_params(key[2:], leaf, model.config)]
        else:
            what, sub = checkpoint._opt_record(key[1:]) or (None, None)
            if sub is None:
                return
            pairs = [(state.optimizer.state[named[n]][what], v)
                     for n, v in leaf_params(sub, leaf, model.config)]
        for tensor, value in pairs:
            assert torch.equal(tensor, value), key
        seen.append(key)

    def watched(path):
        last = None
        for key, leaf in real(path):
            if last is not None:   # leaf i is in place before leaf i + 1 is read
                placed(*last)
            last = (key, leaf)
            yield key, leaf
        placed(*last)

    monkeypatch.setattr(checkpoint, "iter_stream", watched)
    checkpoint.StreamingCheckpointer.load_into(
        f"trainstate::{work / 'ts' / 'streaming_train_state'}", state)
    assert sum(k[0] == "params" for k in seen) == len(named)
    assert sum(k[0] == "opt_state" for k in seen) == 2 * len(named)


def test_refusals():
    stand_in = types.SimpleNamespace(dims=(1, 3, 1, 1), tp=1, shard=3, shard_rank=0, size=3,
                                     tp_rank=0, sp=1)
    model = _model("text", MODEL)
    model.mesh = stand_in
    with pytest.raises(ValueError, match=r"wte\.weight.*fsdp x sp=3"):
        fsdp.shard_model(model)
    with pytest.raises(ValueError, match=r"h\.0\.attention\.wq\.weight.*fsdp x sp=3"):
        partition.local_shard("h.0.attention.wq.weight", torch.zeros(64, 64), stand_in)
    dropout = _model("text", dict(MODEL, attn_pdrop=0.1))
    with pytest.raises(NotImplementedError, match="dropout.*ROADMAP A3"):
        dropout(torch.zeros((1, 8), dtype=torch.long))
