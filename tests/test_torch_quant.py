"""The port's int8-weight serving (`lwm_tpu_torch.ops.quant`, `Int8Dense`,
`quant_dense`) against the JAX package (`lwm_tpu/ops/quant.py`) on the CPU,
where each kernel wrapper runs its plain twin.

Inputs are made with numpy from a seed and fed to both packages. The
quantizers are bit-identical to JAX's. The K5 twin holds the Pallas kernel
(interpret mode) to the JAX suite's own bound (atol 1e-4, rtol 1e-5 at
fp32, `tests/test_quant.py:56-58`); the K6 twin equals the Pallas kernel
exactly (int32 sums are exact, the epilogue is the same fp32 products in the
same order). Models: fp32 logits to JAX's plumbing bound (atol 2e-4, rtol
1e-4, `tests/test_quant.py:115-117`), bf16 ones to 2e-2.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lwm_tpu.models import FlaxLLaMAForCausalLM
from lwm_tpu.models import LLaMAConfig as JaxConfig
from lwm_tpu.ops import quant as jq
from lwm_tpu.serve import InflightServer as JaxServer
from lwm_tpu.utils.checkpoint_convert import scan_params
from lwm_tpu_torch.models import llama as port
from lwm_tpu_torch.ops import quant
from lwm_tpu_torch.serve import InflightServer
from lwm_tpu_torch.utils.convert import convert_flax_params

KERNEL_TOL = dict(atol=1e-4, rtol=1e-5)
LOGIT_TOL = dict(atol=2e-4, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
# int8_w8a8 at fp32: both sides quantize the same activations with the same
# arithmetic, but the layers before differ in the last fp32 bits (summation
# order), which can move an activation across a rounding boundary of its
# row's int8 grid; such a flip changes one product by one grid step (~1% of
# the row's largest activation) times a weight, far below 1e-3 here
W8A8_TOL = dict(atol=1e-3, rtol=1e-3)

BASE = dict(
    vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
    num_attention_heads=4, max_sequence_length=256, scan_attention=False,
    scan_mlp=False, scan_layers=False,
)


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable, contiguous copy


# -------------------------------------------------------------- quantizers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_matches_jax(dtype):
    """Per output channel, with a zero and a huge channel
    (`tests/test_quant.py:34-43`); the port's weight is the flax one
    transposed."""
    w = np.random.default_rng(0).standard_normal((96, 160)).astype(np.float32) * 0.05
    w[:, 0] = 0.0
    w[:, 1] = 1e4
    w[:, 2] = 0.0
    w[0, 2] = -7.0
    q, s = jq.quantize_weight(jnp.asarray(w, dtype))
    pq, ps = quant.quantize_weight(_t(w).to(getattr(torch, dtype)).T)
    np.testing.assert_array_equal(pq.T.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(s))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_activations_matches_jax(dtype):
    x = np.random.default_rng(1).standard_normal((6, 256)).astype(np.float32)
    x[1] = 0.0
    x[2] *= 1e4
    x[3, 5] = 300.0   # one outlier channel
    q, s = jq.quantize_activations(jnp.asarray(x, dtype))
    pq, ps = quant.quantize_activations(_t(x).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(s))


# ----------------------------------------------------------- kernel twins

MATMUL_SHAPES = {
    # name: (m, d, f, Pallas block overrides) — tests/test_quant.py:47-72;
    # m 65 and 129 take K5's admission GEMM on the card (m > 16) with a
    # ragged last 64-row tile; 17x256x384, 33x144x256 and 257x256x200 hold
    # the edges of K6's GEMM: its smallest m (17), a d that ends in a 16-byte
    # piece of its 128-byte k tile (144), an f that ends inside its 128
    # columns (200); the last four those of the decode GEMVs: one request (m
    # 1), both token tiles full (m 16) and the second one begun (m 9) or
    # part full (m 13), each at a d that ends inside a 128-wide k box (144,
    # 272, 400, 208) and an f inside a 32-row tile (200, 40)
    "8x256x384": (8, 256, 384, {}),
    "3x128x128": (3, 128, 128, {}),
    "130x512x640": (130, 512, 640, {}),
    "65x256x384": (65, 256, 384, {}),
    "129x512x256": (129, 512, 256, {}),
    "blocked_8x1536x1280": (8, 1536, 1280, dict(block_d=512, block_f=256)),
    "17x256x384": (17, 256, 384, {}),
    "33x144x256": (33, 144, 256, {}),
    "257x256x200": (257, 256, 200, {}),
    "1x144x200": (1, 144, 200, {}),
    "16x272x200": (16, 272, 200, {}),
    "9x400x200": (9, 400, 200, {}),
    "13x208x40": (13, 208, 40, {}),
}


def _matmul_inputs(m, d, f, seed):
    """x fp32 [m, d] ~ N(0, 1) (normed activations) and an int8 flax kernel
    [d, f] with its fp32 scales [f], quantized from N(0, 0.02) weights (the
    model's init), so the scales are the ones serving sees: the two fp32
    sums, taken in different orders, then differ by far less than 1e-4."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    w, s = jq.quantize_weight(jnp.asarray(rng.standard_normal((d, f)).astype(np.float32) * 0.02))
    return x, np.asarray(w), np.asarray(s)


@pytest.mark.parametrize("shape", sorted(MATMUL_SHAPES))
def test_int8_matmul_twin_matches_pallas(shape):
    m, d, f, blocks = MATMUL_SHAPES[shape]
    x, w, s = _matmul_inputs(m, d, f, 2)
    want = jq.int8_matmul_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                                 interpret=True, **blocks)
    got = quant.int8_matmul_plain(_t(x), _t(w.T), _t(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)
    # the wrapper takes the twin for CPU tensors and launches nothing, on
    # either route
    launches, gemm = quant.int8_matmul.launches, quant.int8_matmul.gemm_launches
    assert torch.equal(quant.int8_matmul(_t(x), _t(w.T), _t(s)), got)
    assert quant.int8_matmul.launches == launches
    assert quant.int8_matmul.gemm_launches == gemm


# fp32 output under the shape's name, and bf16 (the kernel's only output
# type) under "<shape>-bf16"
W8A8_CASES = [pytest.param(shape, "float32", id=shape) for shape in sorted(MATMUL_SHAPES)] + [
    pytest.param(shape, "bfloat16", id=f"{shape}-bf16") for shape in sorted(MATMUL_SHAPES)
]


@pytest.mark.parametrize("shape, dtype", W8A8_CASES)
def test_w8a8_matmul_twin_matches_pallas_exactly(shape, dtype):
    m, d, f, blocks = MATMUL_SHAPES[shape]
    x, w, s = _matmul_inputs(m, d, f, 3)
    x_q, x_s = jq.quantize_activations(jnp.asarray(x))
    want = jq.w8a8_matmul_pallas(x_q, x_s, jnp.asarray(w), jnp.asarray(s),
                                 out_dtype=getattr(jnp, dtype), interpret=True, **blocks)
    got = quant.w8a8_matmul_plain(_t(x_q), _t(x_s), _t(w.T), _t(s),
                                  out_dtype=getattr(torch, dtype))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    # activation quant + the wrapper: the JAX XLA oracle, bit for bit; the
    # CPU path launches nothing, on either route
    launches = quant.w8a8_matmul_quantized.launches
    gemm = quant.w8a8_matmul_quantized.gemm_launches
    x_in = _t(x).to(getattr(torch, dtype))
    np.testing.assert_array_equal(
        quant.w8a8_matmul(x_in, _t(w.T), _t(s)).float().numpy(),
        np.asarray(jq.w8a8_matmul_xla(jnp.asarray(x, dtype), jnp.asarray(w), jnp.asarray(s)),
                   np.float32),
    )
    assert quant.w8a8_matmul_quantized.launches == launches
    assert quant.w8a8_matmul_quantized.gemm_launches == gemm


def test_int8_matmul_dequant_matches_xla():
    x, w, s = _matmul_inputs(5, 256, 384, 4)
    want = jq.int8_matmul_xla(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s))
    got = quant.int8_matmul_dequant(_t(x), _t(w.T), _t(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


def test_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor the card has no kernel and no twin."""
    x = torch.zeros(8, 64, dtype=torch.bfloat16, device="meta")
    w = torch.zeros(32, 64, dtype=torch.int8, device="meta")
    s = torch.ones(32, device="meta")
    with pytest.raises(ValueError, match="device meta"):
        quant.int8_matmul(x, w, s)
    with pytest.raises(ValueError, match="device meta"):
        quant.w8a8_matmul(x, w, s)
    x_q = torch.zeros(8, 64, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="device meta"):
        quant.w8a8_matmul_quantized(x_q, torch.ones(8, 1, device="meta"), w, s,
                                    out_dtype=torch.bfloat16)


# --------------------------------------------------------------- converter


@functools.cache
def _fp_jax(**kw):
    """(fp JAX model, its params on the host, quantize_params_int8 of them)."""
    jm = FlaxLLaMAForCausalLM(
        JaxConfig(**dict(BASE, **kw), mesh_dim=None, attn_impl="xla"), input_shape=(1, 8), seed=0
    )
    params = jax.device_get(jm.params)
    return jm, params, jax.device_get(jq.quantize_params_int8(params))


def _port_config(**kw):
    return port.LLaMAConfig.from_dict(dict(BASE, attn_impl="auto", **kw))


@pytest.mark.parametrize("layout", ["scan_axis0", "scan_axis1"])
def test_convert_quantized_scanned_trees(layout):
    """A quantized tree converts the same scanned or not. On axis 0,
    `quantize_params_int8` quantizes the stacked [L, d, f] kernels per
    (layer, channel); it stacks on axis 0 only, so an axis-1 tree is the
    unscanned quantized tree stacked as the JAX model stacks its params
    (kernels [d, L, f], scales [f, L])."""
    _, params, qparams = _fp_jax()
    axis = int(layout[-1])
    want = convert_flax_params(qparams, _port_config(quant_dense="int8"))
    if axis == 0:
        tree = jq.quantize_params_int8(scan_params(params, 2, scan_axis=0))
    else:
        tree = scan_params(qparams, 2, scan_axis=1)
    cfg = _port_config(quant_dense="int8", scan_layers=True, param_scan_axis=axis)
    got = convert_flax_params(jax.device_get(tree), cfg)
    assert got.keys() == want.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name
    # loads into a quant_dense model: int8 [out, in] weights, fp32 scales
    m = port.LLaMAForCausalLM(cfg, device="cpu")
    m.load_state_dict(got)
    assert m.h[1].feed_forward.w2.weight.dtype == torch.int8
    assert m.h[1].feed_forward.w2.weight.shape == (64, 128)
    assert m.lm_head.scale.shape == (128,) and m.lm_head.scale.dtype == torch.float32


def test_convert_dtype_leaves_int8_alone():
    _, _, qparams = _fp_jax()
    sd = convert_flax_params(qparams, _port_config(quant_dense="int8"), dtype=torch.bfloat16)
    assert sd["h.0.attention.wq.weight"].dtype == torch.int8
    assert sd["h.0.attention.wq.scale"].dtype == torch.float32
    assert sd["lm_head.weight"].dtype == torch.int8
    assert sd["h.0.attention_norm.weight"].dtype == torch.bfloat16
    assert sd["wte.weight"].dtype == torch.bfloat16


def test_port_quantizer_matches_jax_tree():
    """quantize_params_int8 over the port's state dict gives the converted
    JAX quantized tree, tensor for tensor."""
    _, params, qparams = _fp_jax()
    fp = convert_flax_params(params, _port_config())
    got = quant.quantize_params_int8(fp)
    want = convert_flax_params(qparams, _port_config(quant_dense="int8"))
    assert got.keys() == want.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name


# ------------------------------------------------------------------ model

LOGIT_CASES = {
    # name: (quant_dense, compute dtype, tolerance)
    "int8_fp32": ("int8", "float32", LOGIT_TOL),
    "int8_xla_fp32": ("int8_xla", "float32", LOGIT_TOL),
    "int8_w8a8_fp32": ("int8_w8a8", "float32", W8A8_TOL),
    "int8_bf16": ("int8", "bfloat16", BF16_TOL),
    "int8_xla_bf16": ("int8_xla", "bfloat16", BF16_TOL),
}


def _port_quant_model(spelling, dtype=torch.float32, **kw):
    _, _, qparams = _fp_jax()
    cfg = _port_config(quant_dense=spelling, **kw)
    m = port.LLaMAForCausalLM(cfg, dtype=dtype, param_dtype=torch.float32, device="cpu")
    m.load_state_dict(convert_flax_params(qparams, cfg))
    return m


@pytest.mark.parametrize("case", sorted(LOGIT_CASES))
def test_quant_logits_match_jax(case):
    spelling, dtype, tol = LOGIT_CASES[case]
    _, _, qparams = _fp_jax()
    jm = FlaxLLaMAForCausalLM(
        JaxConfig(**BASE, mesh_dim=None, attn_impl="xla", quant_dense=spelling),
        input_shape=(1, 8), seed=0, dtype=getattr(jnp, dtype), _do_init=False,
    )
    ids = np.random.default_rng(5).integers(0, 128, (2, 12)).astype(np.int32)
    want = np.asarray(jm(jnp.asarray(ids), params=qparams).logits, np.float32)
    pm = _port_quant_model(spelling, getattr(torch, dtype))
    got = pm(_t(ids).long()).detach().float().numpy()
    np.testing.assert_allclose(got, want, **tol)


def test_quant_model_equals_fp_model_on_dequantized_weights():
    """The plumbing alone (`tests/test_quant.py:87-117`): the int8 model on
    (q, s) and the fp model on q·s give the same logits."""
    pm = _port_quant_model("int8")
    sd = pm.state_dict()
    deq = {k: v for k, v in sd.items() if not k.endswith(".scale")}
    for k in deq:
        if deq[k].dtype == torch.int8:
            deq[k] = deq[k].float() * sd[k[: -len("weight")] + "scale"][:, None]
    fp = port.LLaMAForCausalLM(_port_config(), device="cpu")
    fp.load_state_dict(deq)
    ids = torch.from_numpy(np.random.default_rng(6).integers(0, 128, (2, 12)))
    np.testing.assert_allclose(pm(ids).detach().numpy(), fp(ids).detach().numpy(), **LOGIT_TOL)


def test_lm_head_keeps_fp_activations_under_w8a8():
    """`tests/test_quant.py:260-296` on the port: an Int8Dense named lm_head
    takes the weight-only path under w8a8, an ordinary layer quantizes its
    activations, both as the JAX layer computes them; in a model every
    dense layer but the head runs K6."""

    class Pair(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            a = jq.Int8Dense(features=48, impl="w8a8", name="lm_head")(x)
            b = jq.Int8Dense(features=48, impl="w8a8", name="wq")(x)
            return a, b

    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 32)).astype(np.float32)
    q, s = jq.quantize_weight(jnp.asarray(rng.standard_normal((32, 48)).astype(np.float32) * 0.1))
    params = {"lm_head": {"kernel": q, "scale": s}, "wq": {"kernel": q, "scale": s}}
    want_head, want_body = Pair().apply({"params": params}, jnp.asarray(x))
    layers = {}
    for name in ("lm_head", "wq"):
        layer = port.Int8Dense(32, 48, impl="w8a8", name=name, dtype=torch.float32, device="cpu")
        layer.load_state_dict({"weight": _t(q).T.contiguous(), "scale": _t(s)})
        layers[name] = layer(_t(x))
    np.testing.assert_allclose(layers["lm_head"].numpy(), np.asarray(want_head), **KERNEL_TOL)
    np.testing.assert_array_equal(layers["wq"].numpy(), np.asarray(want_body))
    assert (layers["lm_head"] - layers["wq"]).abs().max() > 0

    m = port.LLaMAForCausalLM(_port_config(quant_dense="int8_w8a8"), device="cpu")
    impls = {n: mod.impl for n, mod in m.named_modules() if isinstance(mod, port.Int8Dense)}
    assert impls.pop("lm_head") == "auto"
    assert len(impls) == 7 * 2 and set(impls.values()) == {"w8a8"}
    tied = port.LLaMAForCausalLM(_port_config(quant_dense="int8", tie_word_embeddings=True),
                                 device="cpu")
    assert tied.lm_head is None   # a tied head is the embedding's product, never int8


# ---------------------------------------------------------------- serving

SERVE_KW = dict(decode_index="per_row", num_key_value_heads=2)
SCRIPTS = {   # two of tests/test_torch_serve.py's scripts
    "staggered_admission": (2, (8, 16), [
        ("submit", [3, 14, 15, 92, 65, 35], 12), ("step", 4),
        ("submit", [27, 18, 28], 9),
    ]),
    "more_requests_than_slots": (2, (8,), [
        ("submit", p, n) for p, n in zip(
            [[7, 3], [100, 90, 80, 70], [1, 2, 3], [42], [9, 9, 9, 9, 9]], [6, 4, 8, 3, 5]
        )
    ]),
}
SERVE_CASES = {"int8": ("int8", "auto"), "int8_w8a8_int8_cache": ("int8_w8a8", "int8")}


def _drive(srv, script):
    for item in script:
        if item[0] == "submit":
            srv.submit(item[1], max_new_tokens=item[2])
        else:
            for _ in range(item[1]):
                srv.step()
    return {f.req_id: (f.tokens.tolist(), f.stopped) for f in srv.run()}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_greedy_tokens_match_jax_server(case, script):
    spelling, kv = SERVE_CASES[case]
    kw = dict(SERVE_KW, kv_cache_dtype=kv)
    _, _, qparams = _fp_jax(**SERVE_KW)
    jm = FlaxLLaMAForCausalLM(
        JaxConfig(**BASE, **kw, mesh_dim=None, attn_impl="xla", quant_dense=spelling),
        input_shape=(1, 8), seed=0, _do_init=False,
    )
    cfg = _port_config(quant_dense=spelling, **kw)
    pm = port.LLaMAForCausalLM(cfg, device="cpu")
    pm.load_state_dict(convert_flax_params(qparams, cfg))
    slots, buckets, steps = SCRIPTS[script]
    want = _drive(JaxServer(jm, qparams, slots=slots, cache_len=64, prompt_buckets=buckets), steps)
    got = _drive(InflightServer(pm, slots=slots, cache_len=64, prompt_buckets=buckets), steps)
    assert got == want
