"""The port's shared-prefix ops (lwm_tpu_torch.ops.prefix) against the JAX
ones (`lwm_tpu/ops/prefix.py`), whose decode kernel runs in interpret mode
as `tests/test_prefix.py` runs it: the same numpy inputs through both, at
fp32 (tolerance 2e-5, the JAX prefix tests' own) and bf16 (2e-2). Folded
groups b·g of 1, 6, 12 and 16; int8 in both ranges; a range with no valid
key.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lwm_tpu.ops import prefix as jax_prefix
from lwm_tpu_torch.ops import prefix
from lwm_tpu_torch.ops.reference import BIG_NEG

FP32_TOL = dict(atol=2e-5, rtol=2e-5)


def _quantize(x):
    scale = np.maximum(np.abs(x).max(-1) / 127.0, 1e-8).astype(np.float32)
    return np.clip(np.round(x / scale[..., None]), -127, 127).astype(np.int8), scale


def _inputs(b, h, h_kv, seed, d=32, P=256, T=128, p_true=200):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, d), np.float32)
    k, v = (rng.standard_normal((b, h_kv, T, d), np.float32) for _ in range(2))
    pk, pv = (rng.standard_normal((1, h_kv, P, d), np.float32) for _ in range(2))
    lengths = np.asarray(([5, 77, 127, 40] * b)[:b])
    key_mask = np.arange(T)[None] < lengths[:, None]
    return q, k, v, key_mask, int(lengths.max()), pk, pv, p_true


# (b, h, h_kv): the prefix call's group is b * h / h_kv
CASES = [(1, 4, 4), (3, 4, 2), (3, 8, 2), (4, 8, 2), (2, 24, 4)]


def _both(q, k, v, key_mask, kv_len, pk, pv, p_true, *, quant=False, dtype="fp32"):
    """(port output, JAX output) of decode_with_prefix as float numpy."""
    P = pk.shape[2]
    sc = {}
    if quant:
        (k, sc["k_scale"]), (v, sc["v_scale"]) = _quantize(k), _quantize(v)
        (pk, sc["pk_scale"]), (pv, sc["pv_scale"]) = _quantize(pk), _quantize(pv)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    cast_j = (lambda x: jnp.asarray(x)) if quant else (lambda x: jnp.asarray(x).astype(jdt))
    cast_t = (lambda x: torch.from_numpy(x)) if quant else (lambda x: torch.from_numpy(x).to(tdt))
    prefix_mask = np.arange(P) < p_true
    want = jax_prefix.decode_with_prefix(
        jnp.asarray(q).astype(jdt), cast_j(k), cast_j(v), jnp.asarray(key_mask), kv_len,
        cast_j(pk), cast_j(pv), jnp.asarray(prefix_mask),
        **{n: jnp.asarray(x) for n, x in sc.items()}, interpret=True,
    )
    got = prefix.decode_with_prefix(
        torch.from_numpy(q).to(tdt), cast_t(k), cast_t(v), torch.from_numpy(key_mask), kv_len,
        cast_t(pk), cast_t(pv), torch.from_numpy(prefix_mask), p_true,
        **{n: torch.from_numpy(x) for n, x in sc.items()},
    )
    assert got.dtype == tdt and got.shape == q.shape
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("b,h,h_kv", CASES)
def test_decode_with_prefix_matches_jax(b, h, h_kv):
    got, want = _both(*_inputs(b, h, h_kv, seed=b * 100 + h))
    np.testing.assert_allclose(got, want, **FP32_TOL)


@pytest.mark.parametrize("b,h,h_kv", [(3, 8, 2), (4, 8, 2)])
def test_decode_with_prefix_bf16_matches_jax(b, h, h_kv):
    got, want = _both(*_inputs(b, h, h_kv, seed=7), dtype="bf16")
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("b,h,h_kv", [(2, 4, 2), (4, 8, 2)])
def test_decode_with_prefix_int8_both_ranges_matches_jax(b, h, h_kv):
    got, want = _both(*_inputs(b, h, h_kv, seed=3), quant=True)
    np.testing.assert_allclose(got, want, **FP32_TOL)


def test_empty_ranges():
    """A slot whose suffix has no valid key attends to the prefix alone, and
    a prefix with no valid token leaves every slot its own suffix."""
    q, k, v, key_mask, kv_len, pk, pv, p_true = _inputs(3, 8, 2, seed=5)
    key_mask[1] = False
    got, want = _both(q, k, v, key_mask, kv_len, pk, pv, p_true)
    np.testing.assert_allclose(got, want, **FP32_TOL)
    key_mask[1, :3] = True
    got, want = _both(q, k, v, key_mask, kv_len, pk, pv, 0)
    np.testing.assert_allclose(got, want, **FP32_TOL)


def test_fold_round_trips():
    q = torch.randn(3, 1, 8, 4)
    o = prefix._fold(q, 2)
    assert o.shape == (1, 1, 24, 4)
    assert torch.equal(o[0, 0, 4], q[1, 0, 0])          # kv head 0, row 1, head 0
    assert torch.equal(prefix._unfold_o(o, 3, 2, 4, 4), q)
    ml = torch.randn(1, 24, 1)
    want = np.asarray(jax_prefix._unfold_ml(jnp.asarray(ml.numpy()), 3, 2, 4))
    np.testing.assert_array_equal(prefix._unfold_ml(ml, 3, 2, 4).numpy(), want)


def test_combine_lse_matches_jax():
    rng = np.random.default_rng(2)
    b, sq, h, d = 2, 5, 4, 8
    o1, o2 = (rng.standard_normal((b, sq, h, d), np.float32) for _ in range(2))
    l1, l2 = (rng.standard_normal((b, h, sq), np.float32) * 3 for _ in range(2))
    l1[0, 1, 2] = BIG_NEG     # a row without keys in the first range
    l2[1, 3, 4] = BIG_NEG     # and one in the second
    want = jax_prefix.combine_lse(*(jnp.asarray(x) for x in (o1, l1, o2, l2)))
    got = prefix.combine_lse(*(torch.from_numpy(x) for x in (o1, l1, o2, l2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)
    np.testing.assert_allclose(got[0, 2, 1].numpy(), o2[0, 2, 1], **FP32_TOL)
