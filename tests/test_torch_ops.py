"""The port's attention kernels' plain twins (lwm_tpu_torch.ops) against the
JAX kernels they replace, run in interpret mode on the CPU, and against the
JAX oracle `lwm_tpu.ops.reference_attention`; the training attention
(`lwm_tpu_torch.ops.ring.flash_attention`, K1 forward + the fused backward under
autograd) against autograd through the plain attention and against
`jax.vjp` of `lwm_tpu.ops.ring.flash_attention`.

Inputs are made with numpy from a seed and fed to both packages. fp32
comparisons hold 1e-5 (the JAX suite's own kernel tolerance); bf16 ones 2e-2.
Every compared row has at least one valid key: the TPU kernels leave a
fully masked row as a mean of v, where the module contract (and the port)
gives 0 — that case is checked against the contract separately.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lwm_tpu.ops import reference_attention as jax_reference_attention
from lwm_tpu.ops.pallas_decode import flash_decode_pallas
from lwm_tpu.ops.pallas_flash import flash_attention_bwd_pallas, flash_attention_fwd_pallas
from lwm_tpu.ops.ring import flash_attention as jax_flash_attention
from lwm_tpu_torch.ops import decode, flash, ring
from lwm_tpu_torch.ops.reference import BIG_NEG, reference_attention

FP32_TOL = dict(atol=1e-5, rtol=1e-5)


def _t(x, dtype=None):
    x = torch.from_numpy(np.ascontiguousarray(x))
    return x if dtype is None else x.to(dtype)


# ------------------------------------------------------------------ K1

K1_CASES = {
    # name: (h, h_kv, sq, skv, causal, q_offset, kv_offset, bias kind, head-major)
    "causal_at_q_offset": (4, 4, 32, 256, True, 224, 0, None, False),
    "left_pad_holes": (4, 4, 32, 256, True, 64, 0, "holes", False),
    "full_tile_bias": (4, 4, 32, 256, True, 100, 0, "full", False),
    "non_causal": (4, 4, 32, 256, False, 0, 0, "holes", False),
    "kv_offset": (4, 4, 32, 256, True, 120, 50, "holes", False),
    "gqa": (8, 2, 32, 256, True, 224, 0, "holes", False),
    "head_major_gqa": (8, 4, 32, 256, True, 64, 0, "holes", True),
    # a ragged query tile (136 rows) over ragged keys (300), offsets off
    # the 128 grid: the port masks both; the Pallas kernel is handed the
    # keys padded to whole blocks (_pad_keys_for_pallas)
    "ragged_tiles_offsets": (4, 2, 136, 300, True, 171, 7, "holes", False),
}


def _k1_inputs(h, h_kv, sq, skv, causal, q_offset, kv_offset, bias_kind, seed=0, b=2, d=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d), np.float32)
    k = rng.standard_normal((b, skv, h_kv, d), np.float32)
    v = rng.standard_normal((b, skv, h_kv, d), np.float32)
    bias = None
    if bias_kind == "holes":
        # per-key bias: left-pad holes at the front of row 0, a random
        # additive term elsewhere; every query still sees key 30
        valid = np.ones((b, skv), bool)
        valid[0, :24] = False
        valid[1, rng.integers(0, skv, 40)] = False
        valid[:, 30] = True
        bias = np.where(valid, rng.standard_normal((b, skv)).astype(np.float32), BIG_NEG)
        bias = bias[:, None, None, :].astype(np.float32)
    elif bias_kind == "full":
        valid = rng.random((b, sq, skv)) > 0.3
        valid[:, :, 0] = True
        bias = np.where(valid, rng.standard_normal((b, sq, skv)), BIG_NEG)
        bias = bias[:, None].astype(np.float32)
    return q, k, v, bias


def _pad_keys_for_pallas(k, v, bias, head_major):
    """The Pallas kernel takes whole 128-key blocks: zero keys appended to
    k and v, masked by BIG_NEG in the (per-key or full-tile) bias, as the
    JAX model pads."""
    axis = 2 if head_major else 1
    skv, pad = k.shape[axis], -k.shape[axis] % 128
    if not pad:
        return k, v, bias
    widths = [(0, 0)] * 4
    widths[axis] = (0, pad)
    if bias is None:
        bias = np.zeros((k.shape[0], 1, 1, skv), np.float32)
    bias = np.pad(bias, [(0, 0)] * 3 + [(0, pad)], constant_values=BIG_NEG)
    return np.pad(k, widths), np.pad(v, widths), bias


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_twin_matches_pallas_kernel(case):
    h, h_kv, sq, skv, causal, q_off, kv_off, bias_kind, head_major = K1_CASES[case]
    q, k, v, bias = _k1_inputs(h, h_kv, sq, skv, causal, q_off, kv_off, bias_kind)
    if head_major:
        k, v = k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)
    kp, vp, bias_p = _pad_keys_for_pallas(k, v, bias, head_major)
    want_out, want_lse = flash_attention_fwd_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        None if bias_p is None else jnp.asarray(bias_p),
        causal=causal, q_offset=q_off, kv_offset=kv_off, block_k=128,
        interpret=True, kv_head_major=head_major,
    )
    out, lse = flash.flash_attention_fwd_plain(
        _t(q), _t(k), _t(v), None if bias is None else _t(bias),
        causal=causal, q_offset=q_off, kv_offset=kv_off, kv_head_major=head_major,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **FP32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **FP32_TOL)


@pytest.mark.parametrize("case", ["causal_at_q_offset", "kv_offset", "gqa", "full_tile_bias"])
def test_k1_twin_and_reference_match_jax_reference(case):
    h, h_kv, sq, skv, causal, q_off, kv_off, bias_kind, _ = K1_CASES[case]
    q, k, v, bias = _k1_inputs(h, h_kv, sq, skv, causal, q_off, kv_off, bias_kind, seed=1)
    g = h // h_kv
    want = jax_reference_attention(
        jnp.asarray(q), jnp.asarray(np.repeat(k, g, axis=2)),
        jnp.asarray(np.repeat(v, g, axis=2)),
        None if bias is None else jnp.asarray(bias),
        causal=causal, q_offset=q_off, kv_offset=kv_off,
    )
    tb = None if bias is None else _t(bias)
    kw = dict(causal=causal, q_offset=q_off, kv_offset=kv_off)
    twin, _ = flash.flash_attention_fwd_plain(_t(q), _t(k), _t(v), tb, **kw)
    ref, _ = reference_attention(_t(q), _t(k), _t(v), tb, **kw)
    np.testing.assert_allclose(twin.numpy(), np.asarray(want), **FP32_TOL)
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), **FP32_TOL)


def test_fully_masked_rows_give_zero():
    """The module contract (pallas_flash.py:35-37, reference.py:46-50):
    a row with no valid key gives 0 and lse BIG_NEG."""
    q, k, v, _ = _k1_inputs(4, 4, 8, 64, False, 0, 0, None, b=1)
    bias = np.zeros((1, 1, 8, 64), np.float32)
    bias[0, 0, 3] = BIG_NEG
    out, lse = flash.flash_attention_fwd_plain(_t(q), _t(k), _t(v), _t(bias), causal=False)
    assert torch.all(out[0, 3] == 0) and torch.all(lse[0, :, 3] == BIG_NEG)
    assert torch.all(out[0, 2] != 0)
    out, lse = reference_attention(_t(q), _t(k), _t(v), causal=True, q_offset=-1)
    assert torch.all(out[0, 0] == 0) and torch.all(out[0, 1] != 0)


def test_k1_twin_bf16_matches_pallas_kernel():
    q, k, v, bias = _k1_inputs(8, 2, 32, 256, True, 224, 0, "holes", seed=2)
    bf = [x.astype(jnp.bfloat16) for x in map(jnp.asarray, (q, k, v))]
    want, want_lse = flash_attention_fwd_pallas(
        *bf, jnp.asarray(bias), causal=True, q_offset=224, block_k=128, interpret=True,
    )
    out, lse = flash.flash_attention_fwd_plain(
        *(_t(x, torch.bfloat16) for x in (q, k, v)), _t(bias), causal=True, q_offset=224,
    )
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(want, np.float32), atol=2e-2, rtol=2e-2
    )
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-4, rtol=1e-5)


# ------------------------------------------------------------- K2 / K3

BWD_CASES = {
    # name: (h, h_kv, sq, skv, causal, q_offset, kv_offset, bias kind)
    "mha_causal_q_offset": (4, 4, 32, 256, True, 224, 0, "holes"),
    "gqa_h4_hkv2_full_tile_bias": (4, 2, 32, 256, True, 100, 0, "full"),
    "mqa_hkv1": (4, 1, 32, 256, True, 224, 0, "holes"),
    "gqa_non_causal": (4, 2, 32, 256, False, 0, 0, "holes"),
    "kv_offset_no_bias": (4, 4, 32, 256, True, 120, 50, None),
}


def _bwd_inputs(case, seed):
    """(q, k, v, g, lse, delta, bias) in numpy fp32, lse and delta from the
    fp32 forward twin (held to the JAX kernel above), fed to both packages."""
    h, h_kv, sq, skv, causal, q_off, kv_off, bias_kind = BWD_CASES[case]
    q, k, v, bias = _k1_inputs(h, h_kv, sq, skv, causal, q_off, kv_off, bias_kind, seed=seed)
    g = np.random.default_rng(seed + 100).standard_normal(q.shape, np.float32)
    out, lse = flash.flash_attention_fwd_plain(
        _t(q), _t(k), _t(v), None if bias is None else _t(bias),
        causal=causal, q_offset=q_off, kv_offset=kv_off,
    )
    delta = np.einsum("bqhd,bqhd->bhq", g, out.numpy())
    return q, k, v, g, lse.numpy(), delta, bias


# bf16 inputs: one bf16 rounding of p and ds (the TPU kernels' order) in
# both, summed in another order over 256 keys: held to 2e-2 like the fwd
BWD_TOL = {"fp32": FP32_TOL, "bf16": dict(atol=2e-2, rtol=2e-2)}


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_k2_k3_twin_matches_pallas_kernels(case, dt):
    h, h_kv, sq, skv, causal, q_off, kv_off, _ = BWD_CASES[case]
    q, k, v, g, lse, delta, bias = _bwd_inputs(case, seed=len(case))
    jdt, tdt = (jnp.float32, torch.float32) if dt == "fp32" else (jnp.bfloat16, torch.bfloat16)
    kw = dict(causal=causal, q_offset=q_off, kv_offset=kv_off)
    want = flash_attention_bwd_pallas(
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v, g)), jnp.asarray(lse),
        jnp.asarray(delta), None if bias is None else jnp.asarray(bias),
        block_q=128, block_k=128, interpret=True, **kw,
    )
    got = flash.flash_attention_bwd_plain(
        *(_t(x, tdt) for x in (q, k, v, g)), _t(lse), _t(delta),
        None if bias is None else _t(bias), **kw,
    )
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == tdt and a.shape == b.shape, name
        np.testing.assert_allclose(
            a.float().numpy(), np.asarray(b, np.float32), err_msg=name, **BWD_TOL[dt]
        )


def _train_attention_inputs(h_kv, seed=0, b=2, s=48, h=4, d=16):
    """fp32 q/k/v/cotangent and the model's per-key bias: finfo.min on
    padded keys at the front of row 1 (`lwm_tpu/models/llama.py:1114-1119`)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d), np.float32)
    k = rng.standard_normal((b, s, h_kv, d), np.float32)
    v = rng.standard_normal((b, s, h_kv, d), np.float32)
    w = rng.standard_normal((b, s, h, d), np.float32)
    mask = np.ones((b, s), bool)
    mask[1, :5] = False
    bias = np.where(mask, 0.0, np.finfo(np.float32).min).astype(np.float32)[:, None, None, :]
    return q, k, v, w, bias, mask


def _port_grads(attend, q, k, v, w, bias):
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    out = attend(qt, kt, vt, _t(bias))
    (out * _t(w)).sum().backward()
    return out.detach(), [x.grad for x in (qt, kt, vt)]


@pytest.mark.parametrize("h_kv", [4, 2])
def test_flash_attention_autograd_matches_plain_autograd(h_kv):
    """Grads of the autograd Function (K1 fwd, backward twins) equal
    autograd through the plain attention, fp32, 1e-5. Padded query rows
    (row 1, positions < 5) see no valid key; both give them 0."""
    q, k, v, w, bias, _ = _train_attention_inputs(h_kv)
    out, grads = _port_grads(lambda *a: ring.flash_attention(*a, causal=True), q, k, v, w, bias)
    ref, ref_grads = _port_grads(
        lambda *a: reference_attention(*a, causal=True)[0], q, k, v, w, bias
    )
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **FP32_TOL)
    for name, a, b in zip(("dq", "dk", "dv"), grads, ref_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **FP32_TOL)


@pytest.mark.parametrize("h_kv", [4, 2, 1])
def test_flash_attention_matches_jax_vjp(h_kv):
    """Against `jax.vjp` of the JAX custom-VJP flash attention (XLA path on
    the CPU), fp32, 1e-5, at the rows that see a valid key (JAX leaves a
    fully masked row as a mean of v, the port 0: see the K1 tests)."""
    q, k, v, w, bias, mask = _train_attention_inputs(h_kv, seed=3)
    real = mask.copy()          # causal: a query at p sees keys ≤ p, so a
    real[1, :5] = False         # left-padded row's first real query is 5
    w_real = w * real[:, :, None, None]
    out, grads = _port_grads(lambda *a: ring.flash_attention(*a, causal=True), q, k, v, w_real,
                             bias)

    def f(q, k, v):
        return jax_flash_attention(
            q, k, v, jnp.asarray(bias), causal=True, query_chunk_size=16,
            key_chunk_size=16, dtype=jnp.float32,
        )

    want, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want_grads = vjp(jnp.asarray(w_real))
    np.testing.assert_allclose(out.numpy()[real], np.asarray(want)[real], **FP32_TOL)
    for name, a, b in zip(("dq", "dk", "dv"), grads, want_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **FP32_TOL)


# ------------------------------------------------------------------ K4


def _quantize(x):
    """Per-(head, token) int8 as lwm_tpu/models/llama.py:464-472 (numpy)."""
    scale = np.maximum(np.abs(x).max(-1) / 127.0, 1e-8).astype(np.float32)
    return np.clip(np.round(x / scale[..., None]), -127, 127).astype(np.int8), scale


K4_CASES = {
    # name: (h, h_kv, quantized, dtype, kv_len = max(lengths) + 1?)
    "fp32_mha": (4, 4, False, "fp32", False),
    "fp32_gqa_kv_len_skip": (8, 2, False, "fp32", True),
    "int8_mha": (4, 4, True, "fp32", True),
    "int8_gqa": (8, 4, True, "fp32", False),
    "bf16_gqa": (8, 2, False, "bf16", True),
    "bf16_int8_mha": (4, 4, True, "bf16", True),
    # groups beyond 1/2/4/8 (the shared-prefix fold gives slots x g)
    "fp32_group3": (6, 2, False, "fp32", True),
    "fp32_group6": (12, 2, False, "fp32", False),
    "int8_group12": (12, 1, True, "fp32", True),
    "bf16_group16": (32, 2, False, "bf16", True),
}


def _k4_inputs(h, h_kv, seed=0, b=3, T=512, d=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, d), np.float32)
    k = rng.standard_normal((b, h_kv, T, d), np.float32)
    v = rng.standard_normal((b, h_kv, T, d), np.float32)
    lengths = np.asarray([100, 300, 45])[:b]
    mask = np.arange(T)[None] <= lengths[:, None]     # per-row frontiers
    mask[1, :40] = False                              # left-pad holes
    return q, k, v, mask, lengths


@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_k4_twin_matches_pallas_kernel(case):
    h, h_kv, quant, dt, skip = K4_CASES[case]
    q, k, v, mask, lengths = _k4_inputs(h, h_kv, seed=len(case))
    T = k.shape[2]
    kv_len = int(lengths.max()) + 1 if skip else T
    ks = vs = None
    if quant:
        k, ks = _quantize(k)
        v, vs = _quantize(v)
    jdt, tdt = (jnp.float32, torch.float32) if dt == "fp32" else (jnp.bfloat16, torch.bfloat16)
    kv_j = (lambda x: jnp.asarray(x)) if quant else (lambda x: jnp.asarray(x).astype(jdt))
    want = flash_decode_pallas(
        jnp.asarray(q).astype(jdt), kv_j(k), kv_j(v), jnp.asarray(mask), kv_len,
        None if ks is None else jnp.asarray(ks), None if vs is None else jnp.asarray(vs),
        block_k=128, interpret=True,
    )
    kv_t = (lambda x: _t(x)) if quant else (lambda x: _t(x, tdt))
    got = decode.flash_decode_plain(
        _t(q, tdt), kv_t(k), kv_t(v), _t(mask), kv_len,
        None if ks is None else _t(ks), None if vs is None else _t(vs),
    )
    assert got.dtype == tdt
    tol = FP32_TOL if dt == "fp32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("h,h_kv", [(4, 4), (8, 2)])
def test_k4_twin_matches_jax_reference(h, h_kv):
    q, k, v, mask, lengths = _k4_inputs(h, h_kv, seed=11)
    g = h // h_kv
    k_sm = np.repeat(k.transpose(0, 2, 1, 3), g, axis=2)   # seq-major, expanded
    v_sm = np.repeat(v.transpose(0, 2, 1, 3), g, axis=2)
    bias = np.where(mask, 0.0, BIG_NEG).astype(np.float32)[:, None, None, :]
    want = jax_reference_attention(
        jnp.asarray(q), jnp.asarray(k_sm), jnp.asarray(v_sm), jnp.asarray(bias), causal=False
    )
    got = decode.flash_decode_plain(_t(q), _t(k), _t(v), _t(mask), int(lengths.max()) + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_k4_twin_partials_match_pallas_kernel(case):
    """return_partials: o (l-normalized), m and l against the JAX kernel's,
    on rows that all hold a valid key."""
    h, h_kv, quant, dt, skip = K4_CASES[case]
    q, k, v, mask, lengths = _k4_inputs(h, h_kv, seed=len(case) + 1)
    T = k.shape[2]
    kv_len = int(lengths.max()) + 1 if skip else T
    ks = vs = None
    if quant:
        k, ks = _quantize(k)
        v, vs = _quantize(v)
    jdt, tdt = (jnp.float32, torch.float32) if dt == "fp32" else (jnp.bfloat16, torch.bfloat16)
    kv_j = (lambda x: jnp.asarray(x)) if quant else (lambda x: jnp.asarray(x).astype(jdt))
    want = flash_decode_pallas(
        jnp.asarray(q).astype(jdt), kv_j(k), kv_j(v), jnp.asarray(mask), kv_len,
        None if ks is None else jnp.asarray(ks), None if vs is None else jnp.asarray(vs),
        block_k=128, interpret=True, return_partials=True,
    )
    kv_t = (lambda x: _t(x)) if quant else (lambda x: _t(x, tdt))
    got = decode.flash_decode_plain(
        _t(q, tdt), kv_t(k), kv_t(v), _t(mask), kv_len,
        None if ks is None else _t(ks), None if vs is None else _t(vs), return_partials=True,
    )
    assert got[0].dtype == tdt and got[1].shape == got[2].shape == (q.shape[0], h, 1)
    o_tol = FP32_TOL if dt == "fp32" else dict(atol=2e-2, rtol=2e-2)
    ml_tol = FP32_TOL if dt == "fp32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(got[0].float().numpy(), np.asarray(want[0], np.float32), **o_tol)
    for name, a, b in zip(("m", "l"), got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **ml_tol)


def test_k4_partials_of_a_row_without_keys():
    """A row with no valid key: o 0, m BIG_NEG, l 0 from the twin, the
    split-and-merge twin and the wrapper (the port's answer; the TPU kernel
    leaves l = the key count there, ROADMAP C1)."""
    q, k, v, mask, _ = _k4_inputs(8, 2, seed=5)
    mask[2] = False
    args = (_t(q), _t(k), _t(v), _t(mask), 301)
    for fn in (decode.flash_decode_plain, decode.flash_decode,
               functools.partial(decode.flash_decode_split_plain, split=64)):
        o, m, l = fn(*args, return_partials=True)
        assert torch.all(o[2] == 0) and torch.all(m[2] == BIG_NEG) and torch.all(l[2] == 0)
        assert torch.all(m[:2] > -1e3) and torch.all(l[:2] > 0)
        assert torch.equal(fn(*args), o)


@pytest.mark.parametrize("split", [32, 64, 256])
@pytest.mark.parametrize("h,h_kv,quant", [(4, 4, False), (8, 2, True), (24, 2, False)])
def test_k4_split_and_merge_matches_twin(split, h, h_kv, quant):
    """The kernel's algorithm (partials per split, merged by exp(m_i − max m))
    equals the unsplit twin at fp32, with kv_len = 301 off every split
    boundary; at splits of 32 and 64, row 1's left-pad hole (keys 0-39) is
    a wholly masked split inside a row, and row 2 (46 keys) ends in empty
    splits before kv_len."""
    q, k, v, mask, _ = _k4_inputs(h, h_kv, seed=9)
    ks = vs = None
    if quant:
        k, ks = _quantize(k)
        v, vs = _quantize(v)
    args = [_t(q), _t(k), _t(v), _t(mask), 301] + [None if x is None else _t(x) for x in (ks, vs)]
    parts = decode.split_partials_plain(*args, split=split)
    assert parts.shape == (3, h, -(-512 // split), 64 + 2)
    if split < 40:
        assert torch.all(parts[1, :, 0, -2] == BIG_NEG) and torch.all(parts[1, :, 0, -1] == 0)
    assert torch.all(parts[2, :, -1, -2] == BIG_NEG)
    want = decode.flash_decode_plain(*args, return_partials=True)
    got = decode.merge_partials_plain(parts, torch.float32, return_partials=True)
    for name, a, b in zip(("o", "m", "l"), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **FP32_TOL)
    split_out = decode.flash_decode_split_plain(*args, split=split)
    assert torch.equal(split_out, got[0])


# ------------------------------------------------------------- wrappers


def test_wrappers_run_twins_on_cpu_without_launching():
    q, k, v, bias = _k1_inputs(4, 2, 16, 128, True, 112, 0, "holes")
    n1, n4 = flash.flash_attention_fwd.launches, decode.flash_decode.launches
    out, lse = flash.flash_attention_fwd(_t(q), _t(k), _t(v), _t(bias), q_offset=112)
    ref, ref_lse = flash.flash_attention_fwd_plain(_t(q), _t(k), _t(v), _t(bias), q_offset=112)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    q4, k4, v4, mask, _ = _k4_inputs(4, 2)
    got = decode.flash_decode(_t(q4), _t(k4), _t(v4), _t(mask), 512)
    assert torch.equal(got, decode.flash_decode_plain(_t(q4), _t(k4), _t(v4), _t(mask), 512))
    args = (_t(q4), _t(k4), _t(v4), _t(mask), 301)
    got = decode.flash_decode(*args, return_partials=True)
    want = decode.flash_decode_plain(*args, return_partials=True)
    assert len(got) == 3 and all(torch.equal(a, b) for a, b in zip(got, want))
    assert (flash.flash_attention_fwd.launches, decode.flash_decode.launches) == (n1, n4)


def test_bwd_wrappers_run_twin_on_cpu_without_launching():
    q, k, v, g, lse, delta, bias = (
        None if x is None else _t(x) for x in _bwd_inputs("gqa_h4_hkv2_full_tile_bias", 1)
    )
    n = flash.flash_attention_bwd.launches
    kw = dict(causal=True, q_offset=100)
    want = flash.flash_attention_bwd_plain(q, k, v, g, lse, delta, bias, **kw)
    got = flash.flash_attention_bwd(q, k, v, g, lse, delta, bias, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[1].shape == k.shape and got[2].shape == v.shape
    assert flash.flash_attention_bwd.launches == n


def test_flash_attention_backward_calls_the_kernel_wrapper_once(monkeypatch):
    """One backward of the autograd Function is one `flash_attention_bwd`
    call (one kernel launch on the card): dq, dk and dv come from it."""
    q, k, v, w, bias, _ = _train_attention_inputs(2)
    calls = []
    real = flash.flash_attention_bwd

    def counted(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(flash, "flash_attention_bwd", counted)
    _, grads = _port_grads(lambda *a: ring.flash_attention(*a, causal=True), q, k, v, w, bias)
    assert len(calls) == 1 and calls[0]["causal"] is True
    assert all(x is not None and torch.isfinite(x).all() for x in grads)


def test_wrappers_refuse_devices_without_a_kernel():
    q = torch.empty((1, 4, 2, 64), device="meta")
    with pytest.raises(ValueError, match="no flash_attention_fwd kernel"):
        flash.flash_attention_fwd(q, q, q)
    lse = torch.empty((1, 2, 4), device="meta")
    with pytest.raises(ValueError, match="no flash_attention_bwd kernel"):
        flash.flash_attention_bwd(q, q, q, q, lse, lse)
    with pytest.raises(ValueError, match="no flash_decode kernel"):
        decode.flash_decode(q[:, :1], q, q, torch.ones(1, 2, dtype=torch.bool), 2)


def test_kernel_argument_checks():
    bf = torch.bfloat16
    q = torch.zeros((1, 8, 4, 64), dtype=bf)
    k = torch.zeros((1, 2, 32, 64), dtype=bf)
    assert flash.check_fwd_args(q, k, k, kv_head_major=True) == (32, 2)
    with pytest.raises(TypeError):
        flash.check_fwd_args(q.float(), k.float(), k.float(), True)
    with pytest.raises(ValueError, match="head_dim"):
        flash.check_fwd_args(q[..., :48], k[..., :48], k[..., :48], True)
    with pytest.raises(ValueError, match="multiple"):
        flash.check_fwd_args(torch.zeros((1, 8, 3, 64), dtype=bf), k, k, True)
    with pytest.raises(ValueError, match="contiguous"):
        flash.check_fwd_args(torch.zeros((1, 8, 4, 128), dtype=bf)[..., ::2], k, k, True)
    with pytest.raises(ValueError, match="per-head"):
        flash._normalize_bias(torch.zeros(1, 4, 1, 32), 1, 8, 32)

    # the backward kernel (lwm_flash_bwd) refuses before anything is built
    # or launched
    ks = torch.zeros((1, 32, 2, 64), dtype=bf)               # seq-major kv
    lse = torch.zeros((1, 4, 8))
    bwd = functools.partial(flash._bwd_launch, (q.float(), ks, ks), q, ks, ks,
                            causal=True, q_offset=0, kv_offset=0, scale=None, bias=None)
    with pytest.raises(ValueError, match="g .* must match"):
        bwd(g=q.float(), lse=lse, delta=lse)
    with pytest.raises(ValueError, match="lse must be contiguous fp32"):
        bwd(g=q, lse=lse[:, :2], delta=lse)
    with pytest.raises(ValueError, match="delta must be contiguous fp32"):
        bwd(g=q, lse=lse, delta=lse.double())
    with pytest.raises(ValueError, match="lse must be .* on cpu, got .* on meta"):
        bwd(g=q, lse=lse.to("meta"), delta=lse)
    with pytest.raises(ValueError, match="g: head dim"):
        bwd(g=torch.zeros((1, 8, 4, 128), dtype=bf)[..., ::2], lse=lse, delta=lse)

    mask = torch.ones((1, 32), dtype=torch.bool)
    decode.check_decode_args(q[:, :1], k, k, mask, None, None)
    k8 = k.to(torch.int8)
    sc = torch.ones((1, 2, 32))
    decode.check_decode_args(q[:, :1], k8, k8, mask, sc, sc)
    with pytest.raises(ValueError, match="exactly when"):
        decode.check_decode_args(q[:, :1], k8, k8, mask, None, None)
    # any group g = h / h_kv is taken (16 here: a shared-prefix fold); h must divide
    decode.check_decode_args(torch.zeros((1, 1, 32, 64), dtype=bf), k, k, mask, None, None)
    with pytest.raises(ValueError, match="group"):
        decode.check_decode_args(torch.zeros((1, 1, 3, 64), dtype=bf), k, k, mask, None, None)
    with pytest.raises(ValueError, match="mask"):
        decode.check_decode_args(q[:, :1], k, k, mask[:, :16], None, None)
    k8_rows8 = torch.zeros((1, 2, 32, 72), dtype=torch.int8)[..., :64]  # 72-byte rows
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        decode.check_decode_args(q[:, :1], k8_rows8, k8_rows8, mask, sc, sc)
    qm = torch.empty((65536, 1, 4, 64), dtype=bf, device="meta")
    km = torch.empty((65536, 2, 32, 64), dtype=bf, device="meta")
    with pytest.raises(ValueError, match="65535"):
        decode.check_decode_args(qm, km, km, torch.empty((65536, 32), dtype=torch.bool,
                                                        device="meta"), None, None)
