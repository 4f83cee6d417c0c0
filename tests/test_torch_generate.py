"""The port's batched generation (lwm_tpu_torch.generation over the model's
shared-index cache, and `apps.sampler.TextSampler`) against the JAX package
on the same converted weights (fp32, CPU): the shared-cache prefill and
decode logits of `FlaxLLaMAForCausalLM` with `prepare_inputs_for_generation`,
`FlaxLLaMAForCausalLM.generate`'s tokens (transformers' Flax loop), the JAX
`TextSampler`'s texts, and `AutoTokenizer`'s left-padded batches.

Logits are compared at real positions only (ROADMAP C1): a left-padded
row's first pad queries see no valid key, which the JAX XLA path turns into
a mean of v and the port into 0; those rows only feed keys that every real
query masks. The port runs its kernel path ("auto"), whose wrappers take
the kernels' plain twins on CPU tensors.
"""

import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import AutoTokenizer
from transformers import GenerationConfig as HFGenerationConfig
from transformers.generation.flax_logits_process import (
    FlaxTemperatureLogitsWarper,
    FlaxTopKLogitsWarper,
    FlaxTopPLogitsWarper,
)

from lwm_tpu.apps.sampler import TextSampler as JaxSampler
from lwm_tpu.models import FlaxLLaMAForCausalLM
from lwm_tpu.models import LLaMAConfig as JaxConfig
from lwm_tpu_torch import generation
from lwm_tpu_torch.apps.sampler import TextSampler
from lwm_tpu_torch.models import llama as port
from lwm_tpu_torch.utils.convert import convert_flax_params
from lwm_tpu_torch.utils.tokenizer import Tokenizer

FP32_TOL = dict(atol=1e-5, rtol=1e-5)
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_sequence_length=256,
            scan_attention=False, scan_mlp=False, scan_layers=False)
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
NEW_TOKENS = 8


@functools.cache
def models():
    """(JAX model, port model) with the same weights, decode_index 'shared'."""
    jm = FlaxLLaMAForCausalLM(JaxConfig(**TINY, mesh_dim=None, attn_impl="xla"),
                              input_shape=(1, 8), seed=0)
    cfg = port.LLaMAConfig.from_dict(TINY)
    pm = port.LLaMAForCausalLM(cfg, device="cpu")
    pm.load_state_dict(convert_flax_params(jax.device_get(jm.params), cfg))
    return jm, pm.eval()


# prompt widths: 72 takes the kernel path's per-key bias (q > 64), 12 its
# full-tile bias; rows of three lengths, left-padded
PROMPTS = {"q72_per_key_bias": (72, (72, 50, 9)), "q12_full_tile_bias": (12, (12, 7, 3))}


def prompts(case, seed=0):
    width, lengths = PROMPTS[case]
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 128, (len(lengths), width)).astype(np.int32)
    mask = (np.arange(width)[None] >= width - np.asarray(lengths)[:, None]).astype(np.int32)
    return np.where(mask > 0, ids, 0).astype(np.int32), mask


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x)).long()


@functools.cache
def jax_step():
    """One jitted forward of the JAX model over its cache: (logits, cache)."""
    jm, _ = models()

    @jax.jit
    def step(params, tokens, mask, pos, cache):
        out = jm(tokens, attention_mask=mask, position_ids=pos, past_key_values=cache,
                 params=params)
        return out.logits, out.past_key_values

    return functools.partial(step, jm.params)


@pytest.mark.parametrize("case", sorted(PROMPTS))
def test_shared_cache_prefill_and_decode_match_jax(case):
    """The prefill of a left-padded batch into the shared-index cache, then
    three decode steps (the JAX tokens fed to both), as `generate` drives
    them: logits within 1e-5 at the real positions."""
    jm, pm = models()
    ids, mask = prompts(case)
    max_length = ids.shape[1] + NEW_TOKENS
    jkw = jm.prepare_inputs_for_generation(jnp.asarray(ids), max_length, jnp.asarray(mask))
    pkw = pm.prepare_inputs_for_generation(_t(ids), max_length, _t(mask))
    assert pkw["cache"].length == jkw["past_key_values"]["transformer"]["h"]["0"][
        "attention"]["cached_key"].shape[2]
    np.testing.assert_array_equal(pkw["attention_mask"].numpy(), np.asarray(jkw["attention_mask"]))
    np.testing.assert_array_equal(pkw["position_ids"].numpy(), np.asarray(jkw["position_ids"]))
    tokens, real = ids, mask > 0
    for step in range(4):
        logits, cache = jax_step()(jnp.asarray(tokens), jkw["attention_mask"],
                                   jkw["position_ids"], jkw["past_key_values"])
        want = np.asarray(logits)
        got = pm(_t(tokens), pkw["attention_mask"], pkw["position_ids"], pkw["cache"])
        np.testing.assert_allclose(got.numpy()[real], want[real], err_msg=f"step {step}",
                                   **FP32_TOL)
        assert pkw["cache"].index == ids.shape[1] + step
        tokens = want[:, -1].argmax(-1).astype(np.int32)[:, None]
        real = np.ones(tokens.shape, bool)
        jkw = jm.update_inputs_for_generation(types.SimpleNamespace(past_key_values=cache), jkw)
        pkw = pm.update_inputs_for_generation(pkw)


def jax_generate(ids, mask, **cfg):
    jm, _ = models()
    out = jm.generate(jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                      generation_config=HFGenerationConfig(**cfg),
                      prng_key=jax.random.PRNGKey(0)).sequences
    return np.asarray(out)[:, ids.shape[1]:]


GENERATE_SEED = 44   # prompts whose greedy rows share tokens (early_eos)


@functools.cache
def greedy_tokens():
    ids, mask = prompts("q72_per_key_bias", seed=GENERATE_SEED)
    return jax_generate(ids, mask, max_new_tokens=NEW_TOKENS, pad_token_id=0,
                        eos_token_id=None, do_sample=False)


def early_eos():
    """A token every row of the greedy rollout emits, the one whose last
    first emission comes earliest: with it as eos, every row finishes
    before the budget (rows finishing at different steps emit pad after)."""
    toks = greedy_tokens()
    common = set.intersection(*(set(r.tolist()) for r in toks))
    assert common, toks
    return min(common, key=lambda t: max(r.tolist().index(t) for r in toks))


GENERATE_CASES = {
    "greedy": dict(do_sample=False),
    "sample_top_k1": dict(do_sample=True, top_k=1, temperature=0.7),
    "eos_mid_way": dict(do_sample=False),
}


@pytest.mark.parametrize("case", sorted(GENERATE_CASES))
def test_generate_matches_jax_tokens(case, monkeypatch):
    """`generation.generate` gives JAX `generate`'s new tokens exactly over
    left-padded prompts of three lengths: greedy, sampled at top_k 1, and
    with an eos the rows emit mid-way (pad after a row's eos; the loop
    stops once every row has finished)."""
    _, pm = models()
    ids, mask = prompts("q72_per_key_bias", seed=GENERATE_SEED)
    kw = dict(GENERATE_CASES[case], max_new_tokens=NEW_TOKENS, pad_token_id=0,
              eos_token_id=early_eos() if case == "eos_mid_way" else None)
    want = jax_generate(ids, mask, **kw)
    calls = []
    real = pm.forward
    monkeypatch.setattr(pm, "forward", lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    got = generation.generate(pm, _t(ids), _t(mask), generation.GenerationConfig(**kw),
                              torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "eos_mid_way":
        eos = kw["eos_token_id"]
        ends = [r.tolist().index(eos) for r in want]
        assert len(set(ends)) > 1 and max(ends) < NEW_TOKENS - 1, want
        assert (want[0, ends[0] + 1:] == 0).all()
        assert len(calls) == max(ends) + 1      # no forward after the last row's eos
    else:
        assert len(calls) == NEW_TOKENS


def test_warpers_match_transformers():
    """Temperature, top-k and top-p as transformers' Flax warpers compute
    them, on logits with ties."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((4, 64)).astype(np.float32)
    logits[:, 10] = logits[:, 11]
    for temperature, top_k, top_p in ((0.7, 0, 1.0), (1.0, 5, 1.0), (1.0, 0, 0.8),
                                      (0.5, 9, 0.6)):
        want = jnp.asarray(logits)
        if temperature != 1.0:
            want = FlaxTemperatureLogitsWarper(temperature)(None, want, 0)
        if top_k:
            want = FlaxTopKLogitsWarper(top_k)(None, want, 0)
        if top_p < 1.0:
            want = FlaxTopPLogitsWarper(top_p)(None, want, 0)
        got = generation.warp_logits(torch.from_numpy(logits), generation.GenerationConfig(
            temperature=temperature, top_k=top_k, top_p=top_p, do_sample=True))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_generate_refuses_what_jax_never_asks():
    _, pm = models()
    ids, mask = prompts("q12_full_tile_bias")
    with pytest.raises(NotImplementedError, match="beam"):
        generation.generate(pm, _t(ids), _t(mask), generation.GenerationConfig(num_beams=2))
    per_row = port.LLaMAForCausalLM(pm.config.replace(decode_index="per_row"), device="cpu")
    with pytest.raises(ValueError, match="shared"):
        generation.generate(per_row, _t(ids), _t(mask), generation.GenerationConfig(
            pad_token_id=0))


@pytest.mark.parametrize("fixture", ["tokenizer", "tokenizer_bpe"])
def test_batch_encode_and_decode_match_autotokenizer(fixture):
    """Left truncation and left padding to max_length, and batch_decode
    without special tokens, as `AutoTokenizer(truncation_side="left",
    padding_side="left")` gives them."""
    path = os.path.join(FIXTURES, fixture)
    hf = AutoTokenizer.from_pretrained(path, truncation_side="left", padding_side="left")
    tok = Tokenizer(path)
    assert (tok.pad_token_id, tok.pad_token, tok.eos_token) == (
        hf.pad_token_id, hf.pad_token, hf.eos_token)
    texts = ["The special magic Paris number is: 1234567. Keep it short and direct.",
             "hi", "", "USER: what is 42? ASSISTANT: 42 </s> more"]
    for max_length in (1, 6, 40):
        want = hf(texts, padding="max_length", truncation=True, max_length=max_length,
                  return_tensors="np")
        ids, mask = tok.batch_encode(texts, max_length)
        assert ids == want.input_ids.tolist() and mask == want.attention_mask.tolist()
        assert tok.batch_decode(ids, skip_special_tokens=True) == hf.batch_decode(
            want.input_ids, skip_special_tokens=True)


# the golden checkpoint's model (vocab 128) read by both samplers; the
# tokenizer_bpe fixture keeps each digit one token below 128
GOLDEN = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=4, max_sequence_length=256, scan_attention=False,
              scan_mlp=False, scan_layers=False, theta=50000000, scan_query_chunk_size=16,
              scan_key_chunk_size=16)


def sampler_flags(**kw):
    return types.SimpleNamespace(
        mesh_dim="1,-1,1,1", tokenizer=os.path.join(FIXTURES, "tokenizer_bpe"),
        load_llama_config="", llama=dict(GOLDEN), update_llama_config="",
        load_checkpoint=f"params::{os.path.join(FIXTURES, 'v1_golden_params.ckpt')}",
        dtype="fp32", seed=0, **kw)


def test_text_sampler_matches_jax_sampler():
    """The port's TextSampler and the JAX one, each loading the golden
    checkpoint: the same texts for 8 prompts (the JAX sampler shards the
    batch over the 8 CPU devices), one longer than max_input_length (cut
    from the left), each cut at the stop string."""
    prompts_ = ["4819203", "31415926535", "2718281828459", "1" * 40, "5", "66", "777",
                "80808"]
    want = JaxSampler(sampler_flags(), greedy=True, stop_strings=("9",))(prompts_, 32)
    got = TextSampler(sampler_flags(device="cpu"), greedy=True, stop_strings=("9",))
    assert (got.block_size, got.data_dim) == (16, 1)
    assert got(prompts_, 32) == want
    assert any(len(s) for s in want)
