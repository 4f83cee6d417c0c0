"""`fused_lm_cross_entropy` (lwm_tpu_torch.utils.losses) against the JAX
package's (`lwm_tpu/utils/losses.py:83-144`): loss, accuracy and the
gradients with respect to the hidden states and the lm weight, at chunk
sizes that divide the sequence, that do not (one whole chunk) and above
it; and the train step's `compute_loss(fused_lm_loss=True)` through
`forward_hidden` against the JAX trainer's fused loss
(`lwm_tpu/train.py:241-266`) with the lm_head untied and tied to the
embedding, gradients with respect to every parameter.

Tolerances: 1e-5 at fp32 (both compute the same fp32 ops, only summation
orders differ), relative to each gradient's largest element; 2e-2 at bf16
hidden states (the cast to fp32 is exact, so the bf16 case differs from
fp32 only by where the inputs were rounded).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lwm_tpu.models import FlaxLLaMAForCausalLM
from lwm_tpu.models import LLaMAConfig as JaxConfig
from lwm_tpu.models.llama import FlaxLLaMAForCausalLMModule
from lwm_tpu.utils.losses import fused_lm_cross_entropy as jax_fused
from lwm_tpu_torch import train
from lwm_tpu_torch.models.llama import LLaMAConfig, LLaMAForCausalLM
from lwm_tpu_torch.utils.convert import convert_flax_params
from lwm_tpu_torch.utils.losses import fused_lm_cross_entropy

B, S, H, V = 2, 24, 16, 50


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((B, S, H)).astype(np.float32)
    kernel = (rng.standard_normal((H, V)) * 0.5).astype(np.float32)
    tokens = rng.integers(0, V, (B, S)).astype(np.int32)
    valid = (rng.random((B, S)) > 0.25).astype(np.float32)
    valid[1, :5] = 0.0
    return hidden, kernel, tokens, valid


def _assert_close(got, want, tol, what):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("chunk", [8, 7, 24, 4096])
def test_fused_loss_and_grads_match_jax(chunk, dtype):
    hidden, kernel, tokens, valid = _inputs()
    tol = 1e-5 if dtype == "fp32" else 2e-2
    jdtype, tdtype = {"fp32": (jnp.float32, torch.float32),
                      "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]

    def jax_loss(h, k):
        return jax_fused(h, k, jnp.asarray(tokens), jnp.asarray(valid), chunk_size=chunk)

    jh = jnp.asarray(hidden, jdtype)
    (loss, acc), (gh, gk) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jh, jnp.asarray(kernel))
    h = torch.from_numpy(hidden).to(tdtype).requires_grad_()
    w = torch.from_numpy(kernel.T.copy()).requires_grad_()   # the port's [vocab, H] layout
    ours, our_acc = fused_lm_cross_entropy(h, w, torch.from_numpy(tokens),
                                           torch.from_numpy(valid), chunk_size=chunk)
    ours.backward()
    np.testing.assert_allclose(ours.item(), float(loss), rtol=tol)
    np.testing.assert_allclose(our_acc.item(), float(acc), rtol=tol)
    _assert_close(h.grad.float().numpy(), np.asarray(gh, np.float32), tol, "d hidden")
    _assert_close(w.grad.numpy().T, gk, tol, "d kernel")


TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, max_sequence_length=64, scan_attention=True,
            scan_query_chunk_size=16, scan_key_chunk_size=16, scan_mlp=True,
            scan_mlp_chunk_size=16, scan_layers=False, remat_block="save_flash")


@functools.cache
def _untied_params():
    cfg = JaxConfig(**TINY, mesh_dim=None, attn_impl="xla")
    return jax.device_get(FlaxLLaMAForCausalLM(cfg, input_shape=(1, 8), seed=0).params)


def _jax_grads(tied, batch_seed):
    cfg = JaxConfig(**TINY, tie_word_embeddings=tied, mesh_dim=None, attn_impl="xla")
    params = dict(_untied_params())
    if tied:   # a tied model's tree is the untied one without lm_head
        del params["lm_head"]
    params = {"params": params}
    module = FlaxLLaMAForCausalLMModule(cfg, dtype=jnp.float32)
    rngs = {"dropout": jax.random.PRNGKey(0), "params": jax.random.PRNGKey(1)}
    batch = _batch(batch_seed)

    def loss_fn(p):   # the JAX trainer's compute_loss with fused_lm_loss
        hidden = module.apply(p, batch["input_tokens"], deterministic=False, rngs=rngs,
                              method="forward_hidden")
        if tied:
            lm_kernel = p["params"]["transformer"]["wte"]["embedding"].T
        else:
            lm_kernel = p["params"]["lm_head"]["kernel"]
        return jax_fused(hidden, lm_kernel, batch["target_tokens"], batch["loss_masks"],
                         chunk_size=16)

    (loss, acc), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return params, float(loss), float(acc), jax.device_get(grads)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return dict(input_tokens=rng.integers(0, 128, (B, 32)).astype(np.int32),
                target_tokens=rng.integers(0, 128, (B, 32)).astype(np.int32),
                loss_masks=(rng.random((B, 32)) > 0.2).astype(np.float32))


@pytest.mark.parametrize("tied", [False, True])
def test_compute_loss_fused_matches_jax_trainer(tied):
    params, loss, acc, grads = _jax_grads(tied, 3)
    cfg = LLaMAConfig.from_dict(dict(TINY, tie_word_embeddings=tied))
    model = LLaMAForCausalLM(cfg, dtype=torch.float32, param_dtype=torch.float32, device="cpu")
    model.load_state_dict(convert_flax_params(params, cfg))
    batch = {k: torch.from_numpy(v) for k, v in _batch(3).items()}
    ours, aux = train.compute_loss(model, batch, loss_chunk_size=16, fused_lm_loss=True)
    ours.backward()
    np.testing.assert_allclose(ours.item(), loss, rtol=1e-5)
    np.testing.assert_allclose(aux["acc"].item(), acc, rtol=1e-5)
    want = convert_flax_params(grads, cfg)
    assert want.keys() == dict(model.named_parameters()).keys()
    assert ("lm_head.weight" in want) is not tied
    for name, p in model.named_parameters():
        _assert_close(p.grad.numpy(), want[name].numpy(), 1e-5, name)
    # the fused loss is the default loss computed another way
    model.zero_grad()
    plain, plain_aux = train.compute_loss(model, batch)
    np.testing.assert_allclose(plain.item(), ours.item(), rtol=1e-6)
    np.testing.assert_allclose(plain_aux["acc"].item(), aux["acc"].item(), rtol=1e-6)
