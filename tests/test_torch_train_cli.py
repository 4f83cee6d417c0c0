"""The port's training CLI (`lwm_tpu_torch.train.main`) on the CPU against
the JAX trainer's pieces run in-process: a JAX-initialized model saved by
the JAX checkpointer (`--load_checkpoint=params::`), the JAX `JsonDataset`
(`return_local_batch`), model, `OptimizerFactory` and `jax.value_and_grad`
on the same batches. Every `metrics.jsonl` record of 4 steps matches, with
the default loss and with `--fused_lm_loss`, eval averaged in; an
autoresumed run continues the uninterrupted one; the flag tree refuses
unknown keys and the CLI what the port does not train. The flag shapes of
scripts/run_spec_natural.sh (`[question],answer,[postpad]` fields joined by
an empty separator, the BPE fixture tokenizer, a scanned remat model and a
`params::` warm start from the port's own saved stream, at fp32) match the
JAX trainer's loop too, the second run read from that stream by the JAX
checkpointer.

Tolerances: `loss`, `acc`, `learning_rate`, `param_norm`, `gradient_norm`,
`eval_loss` and `eval_acc` 1e-5 relative (fp32 on both sides; summation
orders differ, as in `tests/test_torch_train.py`); the `dataset_*` metrics
that do not read the clock exactly. The resume runs use `pad` (one example
a row): the packer drops its partial buffer on resume, by the reference's
design, so packed batches after a resume are not the uninterrupted run's.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from flax.training.train_state import TrainState as JaxTrainState
from transformers import AutoTokenizer

from lwm_tpu.checkpoint import StreamingCheckpointer as JaxCheckpointer
from lwm_tpu.data import JsonDataset as JaxJsonDataset
from lwm_tpu.data import TextProcessor as JaxTextProcessor
from lwm_tpu.models import FlaxLLaMAForCausalLM
from lwm_tpu.models import LLaMAConfig as JaxConfig
from lwm_tpu.models.llama import FlaxLLaMAForCausalLMModule
from lwm_tpu.optim import OptimizerFactory as JaxOptimizerFactory
from lwm_tpu.parallel.partition import get_weight_decay_mask
from lwm_tpu.utils import cross_entropy_loss_and_accuracy as jax_cross_entropy
from lwm_tpu.utils.losses import fused_lm_cross_entropy as jax_fused
from lwm_tpu_torch import train

TOKENIZER = "tests/fixtures/tokenizer"   # 457 tokens: the config's vocab 256 widens to it
MODEL = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, max_sequence_length=64, scan_attention=True,
             scan_query_chunk_size=16, scan_key_chunk_size=16, scan_mlp=True,
             scan_mlp_chunk_size=16, scan_layers=True, param_scan_axis=0)
SEQ, BATCH, STEPS = 32, 2, 4
ADAMW = dict(init_lr=1e-3, lr=1e-2, end_lr=1e-3, lr_warmup_steps=2, lr_decay_steps=10,
             weight_decay=0.1)
FLOAT_METRICS = ("loss", "acc", "learning_rate", "param_norm", "gradient_norm")
EXACT_METRICS = ("step", "dataset_file_loc", "dataset_example_index", "dataset_total_tokens")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The JSONL from a seed and the JAX init as a params stream."""
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    words = ["the", "magic", "number", "needle", "haystack", "model", "is", "blue"]
    with open(d / "train.jsonl", "w") as f:
        for _ in range(200):
            f.write(json.dumps({"text": " ".join(rng.choice(words, rng.integers(4, 30)))}) + "\n")
    JaxCheckpointer.save_train_state_to_file(_jax_params()["params"], str(d / "init"))
    return d


@functools.cache
def _jax_params():
    cfg = JaxConfig(**dict(MODEL, vocab_size=457), mesh_dim=None, attn_impl="xla")
    return {"params": jax.device_get(FlaxLLaMAForCausalLM(cfg, input_shape=(1, 8),
                                                          seed=0).params)}


def _dataset_flags(prefix, path, **extra):
    flags = {"type": "json", "text_processor.fields": "text", "json_dataset.path": path,
             "json_dataset.seq_length": SEQ, "json_dataset.batch_size": BATCH}
    flags.update(extra)
    return [f"--{prefix}.{k}={v}" for k, v in flags.items()]


def _argv(workdir, name, *extra, total_steps=STEPS, **dataset):
    return [
        "--device=cpu", "--dtype=fp32", f"--tokenizer={TOKENIZER}",
        f"--update_llama_config=dict({','.join(f'{k}={v!r}' for k, v in MODEL.items())})",
        f"--load_checkpoint=params::{workdir / 'init'}", f"--total_steps={total_steps}",
        "--log_freq=1", f"--logger.output_dir={workdir}", f"--logger.experiment_id={name}",
        "--logger.append_uuid=False",
        *[f"--optimizer.adamw_optimizer.{k}={v}" for k, v in ADAMW.items()],
        *_dataset_flags("train_dataset", workdir / "train.jsonl", **dataset), *extra,
    ]


def _records(workdir, name):
    with open(workdir / name / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


@functools.cache
def _jax_loop(path, fused, eval_steps):
    """The JAX trainer's step on the JAX dataset's batches: per-step
    metrics as `lwm_tpu.train.main` logs them at log_freq 1."""
    return _jax_records(tuple(dict(MODEL, vocab_size=457).items()), TOKENIZER,
                        (("fields", "text"),), path, _jax_params(), fused, eval_steps)


def _jax_records(model, tokenizer, processor, path, params, fused=False, eval_steps=0):
    """`_jax_loop` for a model config, tokenizer, text-processor flags and
    initial params."""
    cfg = JaxConfig(**dict(model), mesh_dim=None, attn_impl="xla")
    module = FlaxLLaMAForCausalLMModule(cfg, dtype=jnp.float32)
    rngs = {"dropout": jax.random.PRNGKey(0), "params": jax.random.PRNGKey(1)}
    tx, info = JaxOptimizerFactory.get_optimizer(dict(adamw_optimizer=ADAMW),
                                                 get_weight_decay_mask(()))

    def loss_fn(params, batch):
        if fused:
            hidden = module.apply(params, batch["input_tokens"], deterministic=False, rngs=rngs,
                                  method="forward_hidden")
            return jax_fused(hidden, params["params"]["lm_head"]["kernel"],
                             batch["target_tokens"], batch["loss_masks"], chunk_size=16)
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

    eval_fn = jax.jit(loss_fn)
    tok = AutoTokenizer.from_pretrained(tokenizer)

    def dataset():
        proc = JaxTextProcessor(JaxTextProcessor.get_default_config(dict(processor)), tok)
        config = JaxJsonDataset.get_default_config(dict(
            path=path, seq_length=SEQ, batch_size=BATCH, return_local_batch=True))
        return iter(JaxJsonDataset(config, tok, proc, node_info=dict(dp_node_size=1,
                                                                     dp_node_rank=0)))

    def on_device(batch):
        return {k: jnp.asarray(batch[k]) for k in ("input_tokens", "target_tokens",
                                                   "loss_masks")}

    state = JaxTrainState.create(params=params, tx=tx, apply_fn=None)
    train_batches, eval_batches = dataset(), dataset()
    out = []
    for i in range(STEPS):
        batch, dataset_metrics = next(train_batches)
        state, metrics = step(state, on_device(batch))
        record = {"step": i + 1, **{k: float(v) for k, v in metrics.items()}, **dataset_metrics}
        if eval_steps:
            evals = [eval_fn(state.params, on_device(next(eval_batches)[0]))
                     for _ in range(eval_steps)]
            record["eval_loss"] = float(np.mean([float(e[0]) for e in evals]))
            record["eval_acc"] = float(np.mean([float(e[1]) for e in evals]))
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


@pytest.mark.parametrize("fused", [False, True])
def test_cli_metrics_match_jax_loop(workdir, fused):
    name = f"fused_{fused}"
    extra = ["--fused_lm_loss=True", "--loss_chunk_size=16"] if fused else [
        "--eval_steps=1", *_dataset_flags("eval_dataset", workdir / "train.jsonl")]
    summary = train.main(_argv(workdir, name, *extra))
    assert (summary["loaded"], summary["start_step"], summary["end_step"]) == ("params", 0, 4)
    want = _jax_loop(str(workdir / "train.jsonl"), fused, 0 if fused else 1)
    keys = FLOAT_METRICS if fused else FLOAT_METRICS + ("eval_loss", "eval_acc")
    assert_records_match(_records(workdir, name), want, keys)
    variant = json.loads((workdir / name / "variant.json").read_text())
    assert variant["fused_lm_loss"] is fused and variant["optimizer.adamw_optimizer.lr"] == 1e-2


def test_autoresume_continues_the_uninterrupted_run(workdir):
    resume = ["--save_model_freq=2", "--autoresume=True",
              "--checkpointer.save_optimizer_state=True", "--checkpointer.float_dtype=fp32"]
    pad = {"json_dataset.pad": True}
    first = train.main(_argv(workdir, "resumed", *resume, total_steps=2, **pad))
    assert first["loaded"] == "params" and len(first["save_seconds"]) == 3   # steps 0, 2, 2
    second = train.main(_argv(workdir, "resumed", *resume, **pad))
    assert (second["loaded"], second["start_step"], second["end_step"]) == ("trainstate", 2, 4)
    whole = train.main(_argv(workdir, "whole", **pad))
    assert whole["start_step"] == 0
    got, want = _records(workdir, "resumed"), _records(workdir, "whole")
    assert [r["step"] for r in got] == [1, 2, 3, 4]
    assert_records_match(got, want)
    names = {p.name for p in (workdir / "resumed").iterdir()}
    assert {"streaming_train_state", "streaming_train_state_2", "streaming_train_state_4",
            "dataset.pkl", "dataset_2.pkl", "metadata_4.pkl", "metrics.jsonl"} <= names


def test_cli_refusals(workdir):
    base = _argv(workdir, "refused", total_steps=1)
    for flag, match in [("--mesh_dim=1,2,1,1", None),
                        ("--train_dataset.type=huggingface", "datasets"),
                        ("--mesh_dim=1,1,1,2", None)]:
        # a mesh of more ranks than the job has (fsdp trains, on as many
        # ranks as its mesh covers): the grammar's error
        with pytest.raises(NotImplementedError if match else ValueError,
                           match=match or "does not cover 1 devices"):
            train.main(base + [flag])
    with pytest.raises(ValueError, match="sp_layout"):
        train.main(base + ["--sp_layout=diagonal"])
    for flag, match in [("--train_dataset.json_dataset.bogus=1", "unknown flag"),
                        ("--bogus", "unknown flag"),
                        ("--optimizer.adamw_optimizer.lr=fast", "lr=fast"),
                        ("--train_dataset=json", "group")]:
        with pytest.raises(SystemExit, match=match):
            train.main(base + [flag])
    with pytest.raises(RuntimeError, match="--device=cpu"):
        train.main([a for a in base if a != "--device=cpu"])


# scripts/run_spec_natural.sh's target at a tiny width (TARGET_CFG's
# shape: scanned layers on axis 0, scanned attention, remat
# nothing_saveable, theta 10000, vocab 2048 over the BPE fixture's 938
# tokens) and its data flags
SPEC_TOKENIZER = "tests/fixtures/tokenizer_bpe"
SPEC_MODEL = dict(vocab_size=2048, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=2, max_sequence_length=64, scan_attention=True,
                  scan_query_chunk_size=16, scan_key_chunk_size=16, scan_mlp=False,
                  scan_layers=True, param_scan_axis=0, remat_block="nothing_saveable",
                  theta=10000)
SPEC_FIELDS = (("fields", "[question],answer,[postpad]"), ("subfield_separator", ""))


def test_spec_natural_flags_with_a_params_warm_start_match_jax(workdir):
    """run_spec_natural.sh's two trainer runs at fp32: A from a JAX init,
    then B warm-started with `params::` from A's last saved params (bf16,
    the checkpointer's default); both match the JAX loop, B's from the same
    stream as the JAX checkpointer reads it."""
    rng = np.random.default_rng(1)
    words = ["the", "magic", "number", "is", "blue", "seven", "haystack", "needle"]
    path = workdir / "copy.jsonl"
    with open(path, "w") as f:
        for _ in range(64):
            span = " ".join(rng.choice(words, rng.integers(2, 8)))
            pad = " ".join(rng.choice(words, rng.integers(1, 6)))
            f.write(json.dumps({"question": span + " REPEAT: ", "answer": span,
                                "postpad": pad}) + "\n")
    cfg = JaxConfig(**SPEC_MODEL, mesh_dim=None, attn_impl="xla")
    init = {"params": jax.device_get(FlaxLLaMAForCausalLM(cfg, input_shape=(1, 8),
                                                          seed=3).params)}
    JaxCheckpointer.save_train_state_to_file(init["params"], str(workdir / "spec_init"))

    def argv(name, load):
        return [
            "--device=cpu", "--dtype=fp32", f"--tokenizer={SPEC_TOKENIZER}",
            f"--update_llama_config=dict({','.join(f'{k}={v!r}' for k, v in SPEC_MODEL.items())})",
            f"--load_checkpoint=params::{load}", f"--total_steps={STEPS}",
            f"--save_model_freq={STEPS}", "--log_freq=1", f"--logger.output_dir={workdir}",
            f"--logger.experiment_id={name}", "--logger.append_uuid=False",
            *[f"--optimizer.adamw_optimizer.{k}={v}" for k, v in ADAMW.items()],
            *_dataset_flags("train_dataset", path, **{
                "text_processor.fields": "[question],answer,[postpad]",
                "text_processor.subfield_separator": ""}),
        ]

    model = tuple(SPEC_MODEL.items())
    train.main(argv("spec_a", workdir / "spec_init"))
    assert_records_match(_records(workdir, "spec_a"),
                         _jax_records(model, SPEC_TOKENIZER, SPEC_FIELDS, str(path), init))
    saved = workdir / "spec_a" / f"streaming_params_{STEPS}"   # the milestone at the end
    assert saved.exists()
    summary = train.main(argv("spec_b", saved))
    assert summary["loaded"] == "params" and summary["start_step"] == 0
    warm = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  JaxCheckpointer.load_checkpoint(str(saved)))
    assert_records_match(_records(workdir, "spec_b"),
                         _jax_records(model, SPEC_TOKENIZER, SPEC_FIELDS, str(path),
                                      {"params": warm}))
