"""The port's in-flight server (lwm_tpu_torch.serve) against the JAX
`InflightServer` on the same converted weights (fp32, CPU): every greedy
request must emit exactly the JAX server's tokens, whatever the admission
pattern. Sampled rows cannot match across frameworks (different RNGs); they
must repeat under one seed.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from lwm_tpu.models import FlaxLLaMAForCausalLM
from lwm_tpu.models import LLaMAConfig as JaxConfig
from lwm_tpu.serve import InflightServer as JaxServer
from lwm_tpu_torch.models import llama as port
from lwm_tpu_torch.serve import InflightServer
from lwm_tpu_torch.utils.convert import convert_flax_params

BASE = dict(
    vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
    num_attention_heads=4, max_sequence_length=256, scan_attention=False,
    scan_mlp=False, scan_layers=False, decode_index="per_row",
)


@functools.cache
def models(kv_cache_dtype="auto"):
    """(JAX model, port model) with the same weights."""
    kw = dict(BASE, kv_cache_dtype=kv_cache_dtype, num_key_value_heads=2)
    jm = FlaxLLaMAForCausalLM(
        JaxConfig(**kw, mesh_dim=None, attn_impl="xla"), input_shape=(1, 8), seed=0
    )
    cfg = port.LLaMAConfig.from_dict(dict(kw, attn_impl="auto"))
    pm = port.LLaMAForCausalLM(cfg, device="cpu")
    pm.load_state_dict(convert_flax_params(jax.device_get(jm.params), cfg))
    return jm, pm


def drive(srv, script):
    """Run a script of ('submit', prompt, max_new) / ('step', n) items,
    then drain; returns {request id: Finished}."""
    for item in script:
        if item[0] == "submit":
            srv.submit(item[1], max_new_tokens=item[2])
        else:
            for _ in range(item[1]):
                srv.step()
    return {f.req_id: f for f in srv.run()}


SCRIPTS = {
    "single_request": (2, (8, 16), [("submit", [5, 9, 2, 77, 31], 10)]),
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


@functools.cache
def jax_tokens(case, kv="auto", stop=()):
    slots, buckets, script = SCRIPTS[case]
    jm, _ = models(kv)
    srv = JaxServer(jm, jm.params, slots=slots, cache_len=64, prompt_buckets=buckets,
                    stop_tokens=stop)
    return {rid: (f.tokens.tolist(), f.stopped) for rid, f in drive(srv, script).items()}


def port_tokens(case, kv="auto", stop=()):
    slots, buckets, script = SCRIPTS[case]
    _, pm = models(kv)
    srv = InflightServer(pm, slots=slots, cache_len=64, prompt_buckets=buckets, stop_tokens=stop)
    return {rid: (f.tokens.tolist(), f.stopped) for rid, f in drive(srv, script).items()}


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_greedy_tokens_match_jax_server(case):
    assert port_tokens(case) == jax_tokens(case)


def test_int8_cache_pool_matches_jax_server():
    assert port_tokens("staggered_admission", "int8") == jax_tokens("staggered_admission", "int8")


def test_stop_token_matches_jax_server():
    toks = jax_tokens("single_request")[0][0]
    i = next(i for i in range(1, len(toks)) if toks[i] not in toks[:i])
    stop = (toks[i],)               # its first appearance ends the request
    got = port_tokens("single_request", stop=stop)
    assert got == jax_tokens("single_request", stop=stop)
    assert got[0] == (toks[: i + 1], "eos")


def test_sampling_reproducible_under_one_seed():
    _, pm = models()

    def run(seed):
        srv = InflightServer(pm, slots=2, cache_len=64, prompt_buckets=(8,), seed=seed)
        srv.submit([5, 9, 2, 77, 31], max_new_tokens=12, temperature=1.0)
        srv.submit([27, 18, 28], max_new_tokens=6)          # greedy neighbour
        return {f.req_id: f.tokens.tolist() for f in srv.run()}

    a, b, c = run(7), run(7), run(8)
    assert a == b
    assert a[0] != c[0] and a[1] == c[1]
    assert all(0 <= t < 128 for t in a[0])


def test_stream_cancel_and_stats():
    _, pm = models()
    seen = []
    srv = InflightServer(pm, slots=1, cache_len=64, prompt_buckets=(8,))
    r1 = srv.submit([3, 14, 15], max_new_tokens=10, on_token=lambda r, t: seen.append(t))
    r2 = srv.submit([27, 18], max_new_tokens=10)
    srv.step()
    srv.step()
    assert srv.cancel(r2) and srv.cancel(r1) and not srv.cancel(99)
    done = {f.req_id: f for f in srv.finished}
    assert done[r2].stopped == "cancelled" and len(done[r2].tokens) == 0
    assert done[r1].stopped == "cancelled" and done[r1].tokens.tolist() == seen
    assert srv.stats["admitted"] == 1 and srv.stats["rounds"] == 2
    assert "tok/round" in srv.stats_line()


def test_validation():
    jm, pm = models()
    srv = InflightServer(pm, slots=1, cache_len=32, prompt_buckets=(8,))
    assert srv.cache_len == 128      # rounded as the JAX server rounds
    assert srv.cache_len == JaxServer(jm, jm.params, slots=1, cache_len=32).cache_len
    with pytest.raises(ValueError, match="exceeds"):
        srv.submit([1, 2, 3], max_new_tokens=126)
    with pytest.raises(ValueError, match="bucket"):
        srv.submit(list(range(9)), max_new_tokens=2)
    with pytest.raises(NotImplementedError, match="mesh"):
        InflightServer(pm, slots=1, cache_len=64, mesh=object())
    look = InflightServer(pm, slots=1, cache_len=32, prompt_buckets=(8,), lookup_k=4)
    with pytest.raises(ValueError, match="lookup_k 4"):   # k rows of headroom
        look.submit([1, 2, 3], max_new_tokens=122)
    chunked = InflightServer(pm, slots=1, cache_len=32, prompt_buckets=(8,), admit_chunk=4)
    chunked.submit(list(range(2, 22)), max_new_tokens=2)   # beyond the bucket: staged
    shared = port.LLaMAForCausalLM(pm.config.replace(decode_index="shared"), device="cpu")
    with pytest.raises(ValueError, match="per_row"):
        InflightServer(shared, slots=1, cache_len=64)


# ----------------------------------------------------------- serving modes
# the shared document: 70 tokens, built in chunks of 32 (P_store 128)
PREFIX = np.random.default_rng(0).integers(2, 120, 70).tolist()
QUOTE = [11, 12, 13, 14, 15, 16, 17, 18]     # a span the prompts repeat (lookup hits)
MODE_SCRIPT = [
    ("submit", [3, 14, 15, 92], 10), ("step", 2),
    ("submit", QUOTE + [5, 6] + QUOTE[:3], 9),
    ("submit", [27, 18, 28, 66, 91], 6),
]
LONG = np.random.default_rng(3).integers(2, 120, 40).tolist()   # > the bucket 16
MODES = {
    "prefix": ("auto", dict(prefix_ids=PREFIX, prefix_chunk=32), MODE_SCRIPT),
    "prefix_int8_cache": ("int8", dict(prefix_ids=PREFIX, prefix_chunk=32), MODE_SCRIPT),
    "prefix_lookup": ("auto", dict(prefix_ids=PREFIX, prefix_chunk=32, lookup_k=4), MODE_SCRIPT),
    "prefix_admit_chunk": ("auto", dict(prefix_ids=PREFIX, admit_chunk=8),
                           MODE_SCRIPT + [("submit", LONG[:20], 5)]),
    "lookup": ("auto", dict(lookup_k=7), MODE_SCRIPT),
    "admit_chunk_beyond_bucket": ("auto", dict(admit_chunk=16),
                                  [("submit", LONG, 6), ("step", 1), ("submit", [3, 14, 15], 8),
                                   ("submit", LONG[5:37], 4)]),
}


def mode_server(cls, case, model, **extra):
    kv, kw, _ = MODES[case]
    args = (model, model.params) if cls is JaxServer else (model,)
    return cls(*args, slots=2, cache_len=64, prompt_buckets=(16,), **dict(kw, **extra))


@functools.cache
def jax_mode_tokens(case):
    jm, _ = models(MODES[case][0])
    srv = mode_server(JaxServer, case, jm)
    return {rid: (f.tokens.tolist(), f.stopped) for rid, f in drive(srv, MODES[case][2]).items()}


@pytest.mark.parametrize("case", sorted(MODES))
def test_serving_modes_match_jax_server(case):
    _, pm = models(MODES[case][0])
    srv = mode_server(InflightServer, case, pm)
    got = {rid: (f.tokens.tolist(), f.stopped) for rid, f in drive(srv, MODES[case][2]).items()}
    assert got == jax_mode_tokens(case)
    if "lookup_k" in MODES[case][1]:
        assert srv.stats["spec_rows"] > 0 and "lookup acceptance" in srv.stats_line()


def test_prefix_index_loads_across_packages(tmp_path, monkeypatch):
    """A prefix index saved by the JAX server serves the same tokens from the
    port, and the port's index from the JAX server, neither rebuilding; an
    index for another prefix length is refused as stale."""
    import lwm_tpu.serve as jax_serve
    import lwm_tpu_torch.serve as port_serve

    jm, pm = models()
    jax_path, port_path = str(tmp_path / "jax_index"), str(tmp_path / "port_index")
    want = jax_mode_tokens("prefix")
    mode_server(JaxServer, "prefix", jm, prefix_cache_path=jax_path)
    mode_server(InflightServer, "prefix", pm, prefix_cache_path=port_path)

    def boom(*a, **kw):
        raise AssertionError("the index should have been loaded, not built")

    monkeypatch.setattr(port_serve, "build_prefix_cache", boom)
    monkeypatch.setattr(jax_serve, "build_prefix_cache", boom)
    for cls, model, path in ((InflightServer, pm, jax_path), (JaxServer, jm, port_path)):
        srv = mode_server(cls, "prefix", model, prefix_cache_path=path)
        got = {rid: (f.tokens.tolist(), f.stopped) for rid, f in drive(srv, MODE_SCRIPT).items()}
        assert got == want, cls
    with pytest.raises(ValueError, match="stale"):
        InflightServer(pm, slots=1, cache_len=64, prompt_buckets=(8,),
                       prefix_ids=PREFIX[:50], prefix_cache_path=jax_path)


def test_prefix_index_bytes_match_jax_writer(tmp_path):
    """The port's index writer gives the JAX writer's bytes for the same
    block: the JAX index loaded by the port and saved again."""
    jm, pm = models("int8")
    jax_path = str(tmp_path / "jax_index")
    mode_server(JaxServer, "prefix_int8_cache", jm, prefix_cache_path=jax_path)
    from lwm_tpu_torch.serve import load_prefix_cache, save_prefix_cache

    cache, P_store, P_true = load_prefix_cache(jax_path, "cpu", torch.float32)
    assert (P_store, P_true, cache.index) == (128, 70, 96)
    save_prefix_cache(str(tmp_path / "again"), cache, P_store, P_true)
    assert (tmp_path / "again").read_bytes() == open(jax_path, "rb").read()
