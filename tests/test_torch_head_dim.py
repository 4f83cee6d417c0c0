"""The port at head dim 100, the `3b` preset's (hidden 3200 over 32 heads),
against the JAX package at fp32 on the CPU: a tiny model of the same head
dim (hidden 200, 2 heads, 2 layers) on the same converted weights.

The kernels' wrappers run their plain twins on CPU tensors (the twins at d
100 are held to the Pallas kernels in `tests/test_torch_ops.py`), so these
hold the path around them: the forward's logits at 1e-5, an admission and
its decode rounds through `InflightServer` (bf16-free fp32 pool, greedy:
the JAX server's tokens exactly, over a fp32 and an int8 cache), and one
train step's loss (1e-6 relative) and gradients (max |Δ| ≤ 1e-5 · max).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lwm_tpu.models import FlaxLLaMAForCausalLM
from lwm_tpu.models import LLaMAConfig as JaxConfig
from lwm_tpu.serve import InflightServer as JaxServer
from lwm_tpu.utils import cross_entropy_loss_and_accuracy as jax_cross_entropy
from lwm_tpu_torch import train
from lwm_tpu_torch.models import llama as port
from lwm_tpu_torch.serve import InflightServer
from lwm_tpu_torch.utils.convert import convert_flax_params

FP32_TOL = dict(atol=1e-5, rtol=1e-5)
TINY = dict(vocab_size=128, hidden_size=200, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=2, max_sequence_length=256, scan_attention=False,
            scan_mlp=False, scan_layers=False)
# the training branch of the JAX model: scan chunks below the sequence
TRAIN = dict(TINY, max_sequence_length=64, scan_attention=True, scan_query_chunk_size=16,
             scan_key_chunk_size=16, scan_mlp=True, scan_mlp_chunk_size=16,
             remat_block="save_flash")
B, S = 2, 32


@functools.cache
def models(config_items, kv_cache_dtype="auto"):
    """(JAX model, port model) of a config (its items) with the same weights."""
    kw = dict(config_items, kv_cache_dtype=kv_cache_dtype, decode_index="per_row")
    jm = FlaxLLaMAForCausalLM(JaxConfig(**kw, mesh_dim=None, attn_impl="xla"),
                              input_shape=(1, 8), seed=0)
    cfg = port.LLaMAConfig.from_dict(dict(kw, attn_impl="auto"))
    assert cfg.head_dim == 100
    pm = port.LLaMAForCausalLM(cfg, device="cpu")
    pm.load_state_dict(convert_flax_params(jax.device_get(jm.params), cfg))
    return jm, pm


def test_3b_preset_is_the_jax_preset():
    got, want = port.LLaMAConfig.load_config("3b"), JaxConfig.load_config("3b")
    for key in port.LLAMA_STANDARD_CONFIGS["3b"]:
        assert getattr(got, key) == getattr(want, key), key
    assert got.head_dim == 100 and got.num_hidden_layers == 26


def test_logits_match_jax():
    jm, pm = models(tuple(TINY.items()))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (2, 24)).astype(np.int32)
    mask = np.ones((2, 24), np.int32)
    mask[1, :5] = 0                                   # left padding
    want = np.asarray(jax.jit(lambda i, m: jm(i, attention_mask=m).logits)(
        jnp.asarray(ids), jnp.asarray(mask)))
    got = pm(torch.from_numpy(ids).long(), torch.from_numpy(mask)).detach().numpy()
    real = mask.astype(bool)
    np.testing.assert_allclose(got[real], want[real], **FP32_TOL)


SCRIPT = [("submit", [3, 14, 15, 92, 65, 35, 8, 9, 79], 12), ("step", 4),
          ("submit", [27, 18, 28], 9)]


def _drive(srv):
    for item in SCRIPT:
        if item[0] == "submit":
            srv.submit(item[1], max_new_tokens=item[2])
        else:
            for _ in range(item[1]):
                srv.step()
    return {f.req_id: f.tokens.tolist() for f in srv.run()}


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_server_tokens_match_jax(kv):
    """Admissions at the 16-token bucket and decode rounds over a head-major
    cache of d 100 (int8 with its scales, or fp32)."""
    jm, pm = models(tuple(TINY.items()), kv)
    want = _drive(JaxServer(jm, jm.params, slots=2, cache_len=64, prompt_buckets=(16,)))
    got = _drive(InflightServer(pm, slots=2, cache_len=64, prompt_buckets=(16,)))
    assert got == want and len(got[0]) == 12 and len(got[1]) == 9


def test_train_step_matches_jax():
    jm, pm = models(tuple(TRAIN.items()))
    cfg = JaxConfig(**dict(TRAIN, decode_index="per_row"), mesh_dim=None, attn_impl="xla")
    module = type(jm.module)(cfg, dtype=jnp.float32)
    rng = np.random.default_rng(1)
    masks = (rng.random((B, S)) > 0.2).astype(np.float32)
    masks[1, :4] = 0.0
    batch = dict(input_tokens=rng.integers(0, 128, (B, S)).astype(np.int32),
                 target_tokens=rng.integers(0, 128, (B, S)).astype(np.int32), loss_masks=masks)
    rngs = {"dropout": jax.random.PRNGKey(0)}

    def loss_fn(params):
        logits = module.apply(params, jnp.asarray(batch["input_tokens"]), deterministic=False,
                              rngs=rngs).logits
        return jax_cross_entropy(logits, jnp.asarray(batch["target_tokens"]),
                                 jnp.asarray(batch["loss_masks"]))[0]

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(
        {"params": jax.device_get(jm.params)})
    loss, _ = train.compute_loss(pm, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    want = convert_flax_params(jax.device_get(want_grads), pm.config)
    for name, p in pm.named_parameters():
        err = (p.grad - want[name]).abs().max().item()
        assert err <= 1e-5 * want[name].abs().max().item(), (name, err)
