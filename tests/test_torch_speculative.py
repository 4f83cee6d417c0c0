"""The port's speculative decoding (lwm_tpu_torch.speculative) against the
JAX package's (lwm_tpu.speculative) on the same converted weights (fp32,
CPU, tiny serving configs as tests/test_speculative.py's): greedy
draft-model and prompt-lookup decoding give JAX's sequences, `accepted`
and `steps` exactly, for a mismatched draft, a batch in lockstep, the
target as its own draft, and a GQA target with an int8 cache; the lookup
proposals equal JAX's on random sequences; the rejection-sampling rule
emits the target's distribution; a near-zero temperature gives the greedy
tokens; sampling refuses a batch of more than one.

Tokens are held exactly. The port runs its kernel path ("auto"), whose
wrappers take the kernels' plain twins on CPU tensors; the JAX models run
their XLA path. Each model pair and each JAX runner is built once a module
(its jitted while loop compiles once per shape).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lwm_tpu import speculative as jax_spec
from lwm_tpu.models import FlaxLLaMAForCausalLM
from lwm_tpu.models import LLaMAConfig as JaxConfig
from lwm_tpu_torch import generation, speculative
from lwm_tpu_torch.models import llama as port
from lwm_tpu_torch.utils.convert import convert_flax_params


def serving_config(layers=2, hidden=64, **kw):
    """tests/test_speculative.py's tiny serving config."""
    return dict(vocab_size=128, hidden_size=hidden, intermediate_size=hidden * 2,
                num_hidden_layers=layers, num_attention_heads=4, max_sequence_length=2048,
                scan_attention=False, scan_mlp=False, scan_layers=False, **kw)


MODELS = {   # name: (config, seed), as tests/test_speculative.py builds them
    "target": (serving_config(layers=2), 0),
    "draft": (serving_config(layers=1, hidden=32), 7),
    "gqa_int8": (serving_config(layers=2, num_key_value_heads=2, kv_cache_dtype="int8"), 0),
}


@functools.cache
def models(name):
    """(JAX model, port model) with the same weights."""
    cfg, seed = MODELS[name]
    jm = FlaxLLaMAForCausalLM(JaxConfig(**cfg, mesh_dim=None, attn_impl="xla"),
                              input_shape=(1, 8), seed=seed)
    pcfg = port.LLaMAConfig.from_dict(cfg)
    pm = port.LLaMAForCausalLM(pcfg, device="cpu")
    pm.load_state_dict(convert_flax_params(jax.device_get(jm.params), pcfg))
    return jm, pm.eval()


def ids_of(seed, shape):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, 2, 128), np.int32)


def _t(x):
    return torch.from_numpy(np.array(x)).long()


def assert_same(got, want):
    """A port SpecResult equals a JAX one: tokens, accepted and steps."""
    np.testing.assert_array_equal(got.sequences.numpy(), np.asarray(want.sequences))
    assert (got.accepted, got.steps) == (int(want.accepted), int(want.steps))


def port_greedy(pm, ids, new):
    """The port's plain greedy decoding (`generation.generate`)."""
    cfg = generation.GenerationConfig(max_new_tokens=new, pad_token_id=0)
    return torch.cat([_t(ids), generation.generate(pm, _t(ids), config=cfg)], 1).numpy()


def run_both(target, draft, ids, new, k, cache_len=128, **kw):
    (jt, pt), (jd, pd) = models(target), models(draft)
    want = jax_spec.speculative_generate(jt, jd, jt.params, jd.params, jnp.asarray(ids),
                                         max_new_tokens=new, k=k, cache_len=cache_len, **kw)
    got = speculative.speculative_generate(pt, pd, _t(ids), new, k=k, cache_len=cache_len)
    return got, want


@pytest.mark.parametrize("k", [1, 3, 7])
def test_greedy_mismatched_draft_matches_jax(k):
    """An unrelated random draft: JAX's sequences, accepted and steps, and
    the target's own greedy tokens."""
    ids = ids_of(2, (1, 12))
    got, want = run_both("target", "draft", ids, 16, k)
    assert_same(got, want)
    np.testing.assert_array_equal(got.sequences.numpy(), port_greedy(models("target")[1], ids, 16))


def test_greedy_batched_rows_in_lockstep_match_jax():
    ids = ids_of(3, (3, 10))
    got, want = run_both("target", "draft", ids, 12, 3)
    assert_same(got, want)
    np.testing.assert_array_equal(got.sequences.numpy(), port_greedy(models("target")[1], ids, 12))


def test_draft_equal_to_target_accepts_everything():
    """draft == target: every proposal verifies, k + 1 tokens a verify."""
    ids = ids_of(4, (1, 8))
    k, new = 3, 16
    got, want = run_both("target", "target", ids, new, k)
    assert_same(got, want)
    assert got.accepted == got.steps * k and got.steps == -(-new // (k + 1))


def test_gqa_int8_target_matches_jax():
    """A GQA target with an int8 cache and an MHA draft: the caches are the
    models' own, the contract unchanged."""
    ids = ids_of(5, (1, 10))
    got, want = run_both("gqa_int8", "draft", ids, 8, 3)
    assert_same(got, want)


def test_lookup_proposals_match_jax():
    """On random sequences over a small vocabulary (occurrences found,
    rows with none, continuations past the frontier: zeros) and on JAX's
    own unit case, the proposals equal `lwm_tpu.speculative`'s."""
    rng = np.random.default_rng(0)
    L, k = 48, 5
    cases = []
    for n, g, vocab in ((20, 3, 4), (30, 2, 3), (45, 2, 6), (10, 3, 50), (46, 1, 5)):
        seq = rng.integers(0, vocab, (4, L)).astype(np.int32)
        seq[:, n + 1:] = 0                      # past the frontier
        cases.append((seq, n, g))
    unit = np.zeros((2, 32), np.int32)           # tests/test_speculative.py's unit case
    unit[0, 2:9] = [7, 8, 9, 1, 2, 3, 4]
    unit[0, 10:15] = [7, 8, 9, 5, 6]
    unit[0, 18:21] = [7, 8, 9]
    unit[1, 18:21] = [3, 3, 3]
    cases.append((unit, 20, 3))
    found = missing = overlong = 0
    for seq, n, g in cases:
        tok = seq[:, n]
        want = np.asarray(jax_spec._lookup_proposals(jnp.asarray(seq), jnp.asarray(n),
                                                     jnp.asarray(tok), k, g))
        got = speculative._lookup_proposals(_t(seq), n, _t(tok), k, g).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"n {n} g {g}")
        repeated = (got == tok[:, None]).all(1)
        found += int((~repeated).sum())
        missing += int(repeated.sum())
        overlong += int((got[~repeated] == 0).any(1).sum())
    np.testing.assert_array_equal(got, [[5, 6, 0, 0, 0], [3, 3, 3, 3, 3]])
    assert found and missing and overlong, (found, missing, overlong)


@pytest.mark.parametrize("shape,k,ngram,new", [((1, 12), 4, 3, 14), ((3, 10), 3, 2, 10)])
def test_prompt_lookup_greedy_matches_jax(shape, k, ngram, new):
    """Greedy prompt lookup, one row whose prompt repeats (the lookup
    fires) and a batch: JAX's sequences, accepted and steps."""
    jt, pt = models("target")
    ids = (np.asarray([[5, 6, 7, 8, 9, 5, 6, 7, 8, 9, 5, 6]], np.int32) if shape[0] == 1
           else ids_of(8, shape))
    want = jax_spec.prompt_lookup_generate(jt, jt.params, jnp.asarray(ids), max_new_tokens=new,
                                           k=k, ngram=ngram, cache_len=128)
    got = speculative.prompt_lookup_generate(pt, _t(ids), new, k=k, ngram=ngram, cache_len=128)
    assert_same(got, want)
    np.testing.assert_array_equal(got.sequences.numpy(), port_greedy(pt, ids, new))


def test_accept_and_emit_emission_law():
    """The speculative-sampling lemma (tests/test_speculative.py's emission
    law): with proposals drawn from d_probs, the token emitted at position 1
    is distributed as t_probs[0], and at position 2 (given position 1
    accepted) as t_probs[1]; within 0.02 over 20000 rounds (a bin's
    standard error is under 0.004). Exactly: a proposal the target gives
    at least the draft's probability is always accepted, and one it gives
    0 never is, nor emitted."""
    V, k, N = 5, 3, 20_000
    rng = np.random.default_rng(0)
    pd = torch.from_numpy(rng.dirichlet(np.ones(V), size=k).astype(np.float32))
    pt = torch.from_numpy(rng.dirichlet(np.ones(V), size=k + 1).astype(np.float32))
    gen = torch.Generator().manual_seed(1)
    firsts, seconds = np.zeros(V), np.zeros(V)
    for _ in range(N):
        props = torch.multinomial(pd, 1, generator=gen)[:, 0]
        m, c = speculative.accept_and_emit(gen, props, pd, pt)
        firsts[int(props[0]) if m >= 1 else int(c)] += 1
        if m >= 1:
            seconds[int(props[1]) if m >= 2 else int(c)] += 1
    np.testing.assert_allclose(firsts / N, pt[0].numpy(), atol=0.02)
    np.testing.assert_allclose(seconds / seconds.sum(), pt[1].numpy(), atol=0.02)

    sure = pt.clone()
    sure[0] = pd[0] * 0.5
    sure[0, 2] += 1 - sure[0].sum()             # pt(2) ≥ pd(2) at position 1
    never = pt.clone()
    never[0, 2] = 0.0
    never[0] /= never[0].sum()
    props = torch.tensor([2, 0, 1])
    for _ in range(200):
        assert speculative.accept_and_emit(gen, props, pd, sure)[0] >= 1
        m, c = speculative.accept_and_emit(gen, props, pd, never)
        assert m == 0 and int(c) != 2


def test_warp_matches_jax():
    """Temperature, then top-k (None or 0: no truncation); no top-p."""
    logits = np.random.default_rng(3).standard_normal((2, 50)).astype(np.float32)
    for temperature, top_k in ((0.7, None), (1.3, 5), (1.0, 0)):
        want = np.asarray(jax_spec.make_warp_fn(temperature, top_k)(jnp.asarray(logits)))
        got = speculative.make_warp_fn(temperature, top_k)(torch.from_numpy(logits)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_near_zero_temperature_gives_greedy():
    """Sampling at temperature 1e-4: every draw is forced, so the tokens are
    the greedy ones (the draft-model and the lookup runner)."""
    _, pt = models("target")
    _, pd = models("draft")
    ids = ids_of(6, (1, 9))
    gen = torch.Generator().manual_seed(0)
    greedy = port_greedy(pt, ids, 10)
    out = speculative.speculative_generate(pt, pd, _t(ids), 10, k=3, cache_len=128,
                                           temperature=1e-4, generator=gen)
    np.testing.assert_array_equal(out.sequences.numpy(), greedy)
    out = speculative.prompt_lookup_generate(pt, _t(ids), 10, k=3, ngram=2, cache_len=128,
                                             temperature=1e-4, generator=gen)
    np.testing.assert_array_equal(out.sequences.numpy(), greedy)


def test_sampling_refuses_batch_gt_one_and_short_caches():
    _, pt = models("target")
    ids = torch.ones((2, 6), dtype=torch.long)
    with pytest.raises(ValueError, match="batch-1"):
        speculative.speculative_generate(pt, pt, ids, 4, k=2, cache_len=64, temperature=1.0)
    with pytest.raises(ValueError, match="batch-1"):
        speculative.prompt_lookup_generate(pt, ids, 4, k=2, cache_len=64, temperature=1.0)
    with pytest.raises(ValueError, match="cache_len"):
        speculative.speculative_generate(pt, pt, ids, 60, k=2, cache_len=64)
    assert speculative._cache_len(1000, 100, 7, None) == 2048
