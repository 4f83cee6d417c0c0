"""The port's model (lwm_tpu_torch.models.llama) against the JAX model
(`FlaxLLaMAForCausalLM`) on the same converted weights, at fp32 on the CPU.

Logits hold atol/rtol 1e-4 (fp32; the two frameworks sum in different
orders through two layers). Left-padded rows are compared at their real
positions only: a padding query has no valid key, which the JAX XLA path
turns into a uniform average and the port (its kernels' contract) into 0 —
neither reaches a real position.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lwm_tpu.models import FlaxLLaMAForCausalLM
from lwm_tpu.models import LLaMAConfig as JaxConfig
from lwm_tpu.models.llama import apply_rotary_emb, precompute_freqs_cis, take_freqs_cis
from lwm_tpu.serve import _set_cache_index
from lwm_tpu.utils.checkpoint_convert import unscan_params
from lwm_tpu_torch.models import llama as port
from lwm_tpu_torch.utils.convert import convert_flax_params

TOL = dict(atol=1e-4, rtol=1e-4)
BASE = dict(
    vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
    num_attention_heads=4, max_sequence_length=256, scan_attention=False,
    scan_mlp=False, scan_layers=False, attn_impl="xla",
)


def jax_model(**kw):
    cfg = dict(BASE, mesh_dim=None, **kw)
    return FlaxLLaMAForCausalLM(JaxConfig(**cfg), input_shape=(1, 8), seed=0)


def port_model(jm, impl="auto", **kw):
    cfg = dict(BASE, **kw)
    cfg.pop("mesh_dim", None)
    cfg["attn_impl"] = impl
    config = port.LLaMAConfig.from_dict(cfg)
    m = port.LLaMAForCausalLM(config, device="cpu")
    m.load_state_dict(convert_flax_params(jax.device_get(jm.params), config))
    return m


LOGIT_CASES = {
    "mha": dict(),
    "gqa": dict(num_key_value_heads=2),
    "tied": dict(tie_word_embeddings=True),
}


@functools.cache
def _jax_padded_logits(case):
    """(JAX model, ids, mask, JAX logits) for a left-padded batch; shared by
    both port attention paths."""
    jm = jax_model(**LOGIT_CASES[case])
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, :5] = 0                                   # left padding
    want = np.asarray(jm(jnp.asarray(ids), attention_mask=jnp.asarray(mask)).logits)
    return jm, ids, mask, want


@pytest.mark.parametrize("impl", ["auto", "plain"])
@pytest.mark.parametrize("case", sorted(LOGIT_CASES))
def test_logits_match_jax_with_padding(case, impl):
    jm, ids, mask, want = _jax_padded_logits(case)
    got = port_model(jm, impl, **LOGIT_CASES[case])(
        torch.from_numpy(ids).long(), torch.from_numpy(mask)
    ).detach()
    real = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[real], want[real], **TOL)


@pytest.mark.parametrize("layout", ["scan_axis0", "scan_axis1"])
def test_convert_scanned_layouts(layout):
    """Scanned trees (stacked on axis 0 or 1) convert to the same state
    dict as their unscanned form, and serve the JAX model's logits."""
    axis = int(layout[-1])
    jm = jax_model(scan_layers=True, param_scan_axis=axis)
    params = jax.device_get(jm.params)
    cfg = port.LLaMAConfig.from_dict(dict(BASE, param_scan_axis=axis, attn_impl="auto"))
    scanned = convert_flax_params(params, cfg)
    unscanned = convert_flax_params({"params": unscan_params(params, 2, scan_axis=axis)}, cfg)
    assert scanned.keys() == unscanned.keys()
    for name in scanned:
        assert torch.equal(scanned[name], unscanned[name]), name
    ids = np.random.default_rng(1).integers(0, 128, (1, 12)).astype(np.int32)
    want = np.asarray(jm(jnp.asarray(ids)).logits)
    m = port.LLaMAForCausalLM(cfg, device="cpu")
    m.load_state_dict(scanned)
    np.testing.assert_allclose(m(torch.from_numpy(ids).long()).detach().numpy(), want, **TOL)


def test_convert_transposes_dense_kernels():
    jm = jax_model()
    params = jax.device_get(jm.params)["transformer"]["h"]["0"]
    m = port_model(jm)
    wq = np.asarray(params["attention"]["wq"]["kernel"])          # flax [in, out]
    np.testing.assert_array_equal(m.h[0].attention.wq.weight.detach().numpy(), wq.T)


def test_rope_theta_5e7_past_4096():
    """The factored table at theta=5e7 (run_serve.sh) for positions on both
    sides of the F=4096 coarse/fine split."""
    dim, end, theta = 128, 12288, 5e7
    pos = np.asarray([[0, 1, 4095, 4096, 4097, 8191, 9000, 12287]], np.int32)
    x = np.random.default_rng(2).standard_normal((1, 8, 2, dim)).astype(np.float32)
    freqs = precompute_freqs_cis(dim, end, theta=theta)
    want, _ = apply_rotary_emb(
        jnp.asarray(x), jnp.asarray(x), take_freqs_cis(freqs, jnp.asarray(pos))
    )
    table = port.precompute_freqs(dim, end, theta)
    got = port.apply_rotary(torch.from_numpy(x), *port.take_freqs(table, torch.from_numpy(pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_logits_at_positions_past_4096():
    kw = dict(theta=5e7, max_sequence_length=8192)
    jm = jax_model(**kw)
    ids = np.random.default_rng(3).integers(0, 128, (1, 8)).astype(np.int32)
    pos = (np.arange(8, dtype=np.int32) + 5000)[None]
    want = np.asarray(jm(jnp.asarray(ids), position_ids=jnp.asarray(pos)).logits)
    got = port_model(jm, **kw)(torch.from_numpy(ids).long(), position_ids=torch.from_numpy(pos))
    got = got.detach()
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ------------------------------------------------------------- KV cache


def _jax_cached(jm, cache, ids, mask, pos):
    out, vars_ = jm.module.apply(
        {"params": jm.params, "cache": cache}, jnp.asarray(ids), jnp.asarray(mask), None,
        jnp.asarray(pos), True, False, False, False, True, mutable=["cache"],
    )
    return np.asarray(out.logits), vars_["cache"]


# int8: one element landing on the other side of a rounding step in either
# framework moves it by a whole scale unit, so the int8 cache is held to 1e-3
CACHE_CASES = {
    "fp32_cache": ("auto", TOL),
    "int8_cache": ("int8", dict(atol=1e-3, rtol=1e-3)),
}


T_CACHE, BUCKET, ROUNDS = 32, 8, 3


@functools.cache
def _jax_cached_rollout(case):
    """Two rows prefill a bucket of 8 over a 32-slot cache (true lengths 5
    and 8), then decode three rounds at their own depths, as the server
    does. Returns the JAX model and, per forward, (ids, mask, positions,
    cache index, logits)."""
    kw = dict(decode_index="per_row", kv_cache_dtype=CACHE_CASES[case][0], num_key_value_heads=2)
    jm = jax_model(**kw)
    lengths = np.asarray([5, 8])
    ids = np.random.default_rng(4).integers(0, 128, (2, BUCKET)).astype(np.int32)
    mask = (np.arange(T_CACHE)[None] < lengths[:, None]).astype(np.int32)
    pos = np.broadcast_to(np.arange(BUCKET, dtype=np.int32), (2, BUCKET))
    cache = jm.init_cache(2, T_CACHE)
    want, cache = _jax_cached(jm, cache, ids, mask, pos)
    steps = [(ids, mask, pos, 0, want)]
    tok = want[np.arange(2), lengths - 1].argmax(-1).astype(np.int32)
    for _ in range(ROUNDS):
        mask = (np.arange(T_CACHE)[None] <= lengths[:, None]).astype(np.int32)
        pos = lengths[:, None].astype(np.int32)
        cache = _set_cache_index(cache, int(lengths.max()))
        want, cache = _jax_cached(jm, cache, tok[:, None], mask, pos)
        steps.append((tok[:, None], mask, pos, int(lengths.max()), want))
        tok = want[:, 0].argmax(-1).astype(np.int32)
        lengths = lengths + 1
    return jm, kw, steps


@pytest.mark.parametrize("impl", ["auto", "plain"])
@pytest.mark.parametrize("case", sorted(CACHE_CASES))
def test_prefill_over_cache_then_per_row_decode(case, impl):
    """Prefill over the cache, then per-row decode: logits match the JAX
    model with a cache (attn_impl='xla') at every forward."""
    jm, kw, steps = _jax_cached_rollout(case)
    pm = port_model(jm, impl, **kw)
    cache = pm.init_cache(2, T_CACHE)
    for ids, mask, pos, index, want in steps:
        cache.index = index
        got = pm(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                 torch.from_numpy(np.ascontiguousarray(pos)).long(), cache)
        np.testing.assert_allclose(got.numpy(), want, **CACHE_CASES[case][1])


def test_per_row_writes_land_at_their_positions():
    cfg = port.LLaMAConfig.from_dict(dict(BASE, decode_index="per_row", attn_impl="auto",
                                          kv_cache_dtype="int8"))
    torch.manual_seed(0)
    m = port.LLaMAForCausalLM(cfg, device="cpu")
    cache = m.init_cache(2, 16)
    lengths = torch.tensor([[4], [7]])
    cache.index = 7
    m(torch.tensor([[9], [11]]), torch.arange(16)[None] <= lengths, lengths, cache)
    for t in (cache.layers[0].k, cache.layers[0].k_scale):
        assert t[0, :, 4].abs().sum() > 0 and t[1, :, 7].abs().sum() > 0
        assert t[0, :, 5:].abs().sum() == 0 and t[1, :, :7].abs().sum() == 0
    assert cache.index == 8
    assert m.init_cache(3, 16).slot(1).layers[0].k.shape == (1, 4, 16, 16)


# --------------------------------------------------------------- config


def test_config_presets_and_json(tmp_path):
    cfg = port.LLaMAConfig.load_config("7b")
    assert (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads) == (4096, 32, 32)
    assert (cfg.head_dim, cfg.vocab_size, cfg.theta) == (128, 32000, 10000)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(dict(BASE, attn_impl="auto", mesh_dim="1,1,4,1", architectures=["x"])))
    loaded = port.LLaMAConfig.load_config(f"json::{path}")
    assert loaded == port.LLaMAConfig.from_dict(dict(BASE, attn_impl="auto"))
    with pytest.raises(ValueError, match="load type"):
        port.LLaMAConfig.load_config("pickle::/x.pkl")


def test_model_is_built_on_the_card_by_default():
    """Without a device the model goes to the card; with no card it raises
    rather than landing on the CPU."""
    cfg = port.LLaMAConfig.from_dict(dict(BASE, attn_impl="auto"))
    if torch.cuda.is_available():
        assert port.LLaMAForCausalLM(cfg).wte.weight.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port.LLaMAForCausalLM(cfg)
    assert port.LLaMAForCausalLM(cfg, device="cpu").wte.weight.device.type == "cpu"


@pytest.mark.parametrize("jax_impl, port_impl", [
    ("xla", "plain"), ("pallas", "auto"), ("auto", "auto"),
])
def test_config_loads_the_jax_attn_impl_spellings(tmp_path, jax_impl, port_impl):
    """A JAX LLaMAConfig's dict, built or loaded from json, gives the
    port's spelling of the same attention path."""
    jax_dict = JaxConfig(**dict(BASE, mesh_dim=None, attn_impl=jax_impl)).to_dict()
    assert port.LLaMAConfig.from_dict(jax_dict).attn_impl == port_impl
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(jax_dict))
    assert port.LLaMAConfig.load_config(f"json::{path}").attn_impl == port_impl
    assert port.LLaMAConfig(attn_impl=jax_impl).replace(theta=5e7).attn_impl == port_impl


def test_config_rejects_what_the_port_lacks():
    with pytest.raises(ValueError, match="attn_impl"):
        port.LLaMAConfig(attn_impl="ring")
    with pytest.raises(ValueError, match="quant_dense"):
        port.LLaMAConfig(quant_dense="int4")
    with pytest.raises(ValueError, match="quant_dense"):
        port.LLaMAConfig(quant_dense="int8_pallas")
    for spelling in ("none", "int8", "int8_xla", "int8_w8a8"):
        assert port.LLaMAConfig(quant_dense=spelling).quant_dense == spelling
    # a shared prefix is served now: the cache carries a frozen batch-1 block
    cfg = port.LLaMAConfig.from_dict(dict(BASE, decode_index="per_row", prefix_len=128,
                                          prefix_tokens=100))
    cache = port.LLaMAForCausalLM(cfg, device="cpu").init_cache(2, 32)
    assert cache.layers[0].prefix.k.shape == (1, 4, 128, 16)
    assert cache.slot(1).layers[0].prefix is cache.layers[0].prefix
    with pytest.raises(ValueError, match="divide"):
        port.LLaMAConfig(num_attention_heads=32, num_key_value_heads=5)
    assert port.round_cache_length(None, 30000) == 30720
    assert port.round_cache_length(None, 1000) == 1000
