"""The port's VideoLLaMA (lwm_tpu_torch.models.vision_llama) against the JAX
`FlaxVideoLLaMAForCausalLM` on the same weights, carried across by
`convert_flax_params`, and inputs from a numpy seed, on the CPU (the
kernel wrappers run their plain twins): the logits of every `sample_mode`,
the embedding mix, tied heads, single-token cached decode, the fp32
residual stream of a bf16 multi-token forward, and the param tree both ways.

Tolerances: 1e-5 at fp32, 2e-2 at bf16.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lwm_tpu.models import FlaxVideoLLaMAForCausalLM
from lwm_tpu.models import VideoLLaMAConfig as JaxConfig
from lwm_tpu.models.llama import FlaxLLaMABlockCollection
from lwm_tpu_torch.models import vision_llama as port
from lwm_tpu_torch.utils.convert import convert_flax_params, flax_params_tree, materialize

FP32_TOL, BF16_TOL = 1e-5, 2e-2
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, max_sequence_length=256, scan_attention=False,
            scan_mlp=False)
B, S = 2, 24


@functools.cache
def jax_model(scan_layers=True, param_scan_axis=0, tie=False):
    cfg = JaxConfig(**TINY, scan_layers=scan_layers, param_scan_axis=param_scan_axis,
                    mesh_dim=None, attn_impl="xla", sample_mode="all",
                    tie_vision_embeddings=tie, tie_word_embeddings=tie)
    return FlaxVideoLLaMAForCausalLM(cfg, input_shape=(1, 8), seed=0)


def jax_logits(jm, ids, vm, sample_mode="all", dtype=jnp.float32, params=None):
    cfg = JaxConfig(**{**jm.config.to_dict(), "sample_mode": sample_mode})
    m = FlaxVideoLLaMAForCausalLM(cfg, input_shape=(1, 8), dtype=dtype, _do_init=False)
    out = m(jnp.asarray(ids), vision_masks=jnp.asarray(vm), params=params or jm.params).logits
    return jax.tree.map(lambda x: np.asarray(x, np.float32), out)


def port_model(jm, sample_mode="all", dtype=torch.float32, **kw):
    cfg = port.VideoLLaMAConfig.from_dict(
        dict(jm.config.to_dict(), attn_impl="auto", sample_mode=sample_mode, **kw))
    m = port.VideoLLaMAForCausalLM(cfg, dtype=dtype, device="cpu")
    m.load_state_dict(convert_flax_params(jax.device_get(jm.params), cfg, dtype=dtype))
    return m.eval()


def inputs(seed=0):
    """Ids and masks: rows 6-17 of each row are VQ codes (ids up to 8191,
    beyond the 128-token text vocabulary), the rest text."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 128, (B, S))
    vm = np.zeros((B, S), bool)
    vm[:, 6:18] = True
    ids[vm] = rng.integers(0, 8192, int(vm.sum()))
    return ids, vm


def run(m, ids, vm, **kw):
    with torch.no_grad():
        out = m(torch.from_numpy(ids), vision_masks=torch.from_numpy(vm), **kw)
    return out


def np32(x):
    return x.float().numpy()


@pytest.mark.parametrize("mode", ["all", "text", "vision"])
def test_logits_match_jax(mode):
    jm = jax_model()
    ids, vm = inputs()
    want = jax_logits(jm, ids, vm, mode)
    got = run(port_model(jm, mode), ids, vm)
    if mode == "all":
        assert isinstance(got, port.VideoLLaMADualOutput)
        assert got.vision_logits.shape == (B, S, 8448) and got.lm_logits.shape == (B, S, 128)
        for g, w in zip(got, want):
            np.testing.assert_allclose(np32(g), w, atol=FP32_TOL, rtol=0)
    else:
        assert got.shape == want.shape
        np.testing.assert_allclose(np32(got), want, atol=FP32_TOL, rtol=0)


def test_heads_are_the_pairs_members():
    jm = jax_model()
    ids, vm = inputs(1)
    both = run(port_model(jm, "all"), ids, vm)
    torch.testing.assert_close(run(port_model(jm, "text"), ids, vm), both.lm_logits,
                               atol=0, rtol=0)
    torch.testing.assert_close(run(port_model(jm, "vision"), ids, vm), both.vision_logits,
                               atol=0, rtol=0)


def test_embedding_mix_routes_by_mask():
    """A vision row reads vte, a text row wte: changing a vision-masked id,
    or flipping its mask to text, changes the logits, as in JAX."""
    jm = jax_model()
    m = port_model(jm, "text")
    ids, vm = inputs(2)
    base = np32(run(m, ids, vm))
    ids2 = ids.copy()
    ids2[0, 10] = (ids2[0, 10] + 1) % 8192
    vm3 = vm.copy()
    vm3[0, 10] = False
    ids3 = ids.copy()
    ids3[0, 10] %= 128   # a text row must hold a text id
    for new_ids, new_vm in ((ids2, vm), (ids3, vm3)):
        got = np32(run(m, new_ids, new_vm))
        assert not np.allclose(got, base)
        np.testing.assert_allclose(got, jax_logits(jm, new_ids, new_vm, "text"), atol=FP32_TOL,
                                   rtol=0)
    # row 1 and row 0's text rows before the change are untouched by it
    np.testing.assert_allclose(np32(run(m, ids2, vm))[:, :10], base[:, :10], atol=0, rtol=0)
    # the mixed embedding: the vte row where masked, the wte row elsewhere
    emb = m._embed(torch.from_numpy(ids), torch.from_numpy(vm))
    want = torch.where(torch.from_numpy(vm)[..., None], m.vte.weight[torch.from_numpy(ids)],
                       m.wte.weight[torch.from_numpy(np.where(vm, 0, ids))])
    torch.testing.assert_close(emb, want, atol=0, rtol=0)


def test_tied_vision_and_word_embeddings():
    jm = jax_model(tie=True)
    ids, vm = inputs(3)
    m = port_model(jm, "all")
    assert m.vision_head is None and m.lm_head is None
    got, want = run(m, ids, vm), jax_logits(jm, ids, vm, "all")
    for g, w in zip(got, want):
        np.testing.assert_allclose(np32(g), w, atol=FP32_TOL, rtol=0)


def jax_cached_decode(jm, mode, ids, vm, tok, T=64):
    """JAX: prefill ids (with vm) into a cache, then one decode step of
    `tok` under `mode`; the step's logits."""
    cfg = JaxConfig(**{**jm.config.to_dict(), "sample_mode": mode})
    m = FlaxVideoLLaMAForCausalLM(cfg, input_shape=(1, 8), _do_init=False)
    n = ids.shape[1]
    cache = m.init_cache(1, T)
    mask = (np.arange(T) < n + 1)[None].astype(np.int32)
    out = m(jnp.asarray(ids), vision_masks=jnp.asarray(vm), attention_mask=mask,
            position_ids=jnp.arange(n)[None], params=jm.params, past_key_values=cache)
    out = m(jnp.asarray([[tok]]), vision_masks=jnp.zeros((1, 1), bool), attention_mask=mask,
            position_ids=jnp.asarray([[n]]), params=jm.params,
            past_key_values=out.past_key_values)
    return np.asarray(out.logits[0, 0], np.float32)


@pytest.mark.parametrize("mode", ["text", "vision"])
def test_single_token_cached_decode(mode):
    """A one-token forward embeds through the table of `sample_mode`: after
    a prefill into the cache, one decode step of a code (vision) or a word
    (text) matches JAX's cached step, and the uncached forward of the whole
    sequence with that token's mask set accordingly."""
    jm = jax_model(scan_layers=False)
    m = port_model(jm, mode, decode_index="per_row")
    ids, vm = (x[:1, :16] for x in inputs(4))
    tok = 5000 if mode == "vision" else 77
    T, n = 64, ids.shape[1]
    cache = m.init_cache(1, T)
    keys = torch.arange(T)[None] < n + 1
    run(m, ids, vm, attention_mask=keys, position_ids=torch.arange(n)[None], cache=cache)
    with torch.no_grad():
        got = m(torch.tensor([[tok]]), keys, torch.tensor([[n]]), cache=cache)[0, 0]
    np.testing.assert_allclose(np32(got), jax_cached_decode(jm, mode, ids, vm, tok, T),
                               atol=FP32_TOL, rtol=0)
    full_ids = np.concatenate([ids, [[tok]]], 1)
    full_vm = np.concatenate([vm, [[mode == "vision"]]], 1)
    np.testing.assert_allclose(np32(got), np32(run(m, full_ids, full_vm)[0, -1]), atol=FP32_TOL,
                               rtol=0)


def test_single_token_all_raises():
    m = port_model(jax_model(), "all")
    with pytest.raises(ValueError, match="requires sample_mode text"):
        m(torch.tensor([[3]]))
    with pytest.raises(ValueError, match="invalid sample_mode"):
        port.VideoLLaMAConfig(sample_mode="both")


def _jax_block_input_dtype(jm, ids, vm):
    """The dtype of the JAX block stack's input in a bf16 forward."""
    seen = []

    def spy(next_fun, args, kwargs, context):
        if isinstance(context.module, FlaxLLaMABlockCollection) and context.method_name == (
                "__call__"):
            seen.append(args[0].dtype)
        return next_fun(*args, **kwargs)

    cfg = JaxConfig(**{**jm.config.to_dict(), "sample_mode": "text"})
    m = FlaxVideoLLaMAForCausalLM(cfg, input_shape=(1, 8), dtype=jnp.bfloat16, _do_init=False)
    with nn.intercept_methods(spy):
        m(jnp.asarray(ids), vision_masks=jnp.asarray(vm), params=jm.params)
    return seen[0]


@pytest.mark.parametrize("width", [S, 1])
def test_bf16_residual_stream_dtype(width):
    """At bf16 a multi-token forward enters the blocks as fp32 (the mix by
    fp32 masks promotes, even with every row text), a single token as
    bf16, as in JAX; the logits agree with JAX's bf16 ones."""
    jm = jax_model()
    ids, vm = (x[:, :width] for x in inputs(5))
    if width == 1:
        ids, vm = ids % 128, vm & False
    m = port_model(jm, "text", dtype=torch.bfloat16)
    seen = []
    hook = m.h[0].register_forward_pre_hook(lambda mod, args: seen.append(args[0].dtype))
    got = run(m, ids, vm)
    hook.remove()
    want = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16}[
        jnp.dtype(_jax_block_input_dtype(jm, ids, vm))]
    assert seen == [want] and want == (torch.float32 if width > 1 else torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(got), jax_logits(jm, ids, vm, "text", jnp.bfloat16),
                               atol=BF16_TOL, rtol=0)
    if width > 1:   # all text, still fp32
        seen.clear()
        hook = m.h[0].register_forward_pre_hook(lambda mod, args: seen.append(args[0].dtype))
        run(m, ids % 128, vm & False)
        hook.remove()
        assert seen == [torch.float32]


@pytest.mark.parametrize("layout", [(True, 0), (True, 1), (False, 0), "tied"])
def test_param_tree_both_ways(layout):
    """The JAX tree → the port's state dict → the tree again, leaf for leaf:
    scanned on axis 0 or 1, unscanned, and tied (no heads in the tree)."""
    jm = jax_model(tie=True) if layout == "tied" else jax_model(*layout)
    cfg = port.VideoLLaMAConfig.from_dict(jm.config.to_dict())
    tree = jax.device_get(jm.params)
    sd = convert_flax_params(tree, cfg)
    assert "vte.weight" in sd and ("vision_head.weight" in sd) == (layout != "tied")
    back = flax_params_tree(sd, cfg)
    flat_want = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda x: np.asarray(materialize(x)), back,
                     is_leaf=lambda x: callable(x) or isinstance(x, torch.Tensor)))[0])
    assert sorted(map(str, flat_got)) == sorted(str(p) for p, _ in flat_want)
    got = {str(p): v for p, v in flat_got.items()}
    for path, leaf in flat_want:
        np.testing.assert_array_equal(got[str(path)], np.asarray(leaf))


def test_presets_and_on_tensors():
    cfg = port.VideoLLaMAConfig.load_config("7b")
    assert (cfg.hidden_size, cfg.num_hidden_layers, cfg.vision_vocab_size) == (4096, 32, 8448)
    assert cfg.sample_mode == "all" and not cfg.tie_vision_embeddings
    jm = jax_model()
    m = port_model(jm, "text")
    twin = port.VideoLLaMAForCausalLM.on_tensors(m.config, m.state_dict(), torch.float32)
    assert twin.vte.weight.data_ptr() == m.vte.weight.data_ptr()
    ids, vm = inputs(6)
    torch.testing.assert_close(run(twin, ids, vm), run(m, ids, vm), atol=0, rtol=0)
