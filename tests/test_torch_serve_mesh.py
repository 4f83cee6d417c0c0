"""The port's inference on a mesh (dp × fsdp × tp × sp, gloo ranks on the
CPU) against the one-device port, and one cache forward against JAX's.

The in-flight server on a mesh must emit exactly the one-device port's
greedy tokens (which `tests/test_torch_serve.py` holds to the JAX server's):
a tp pool on (1, 2, 2, 1), an sp slot pool with staggered admission on
(1, 1, 2, 2) (and its int8 KV cache), chunked admission on (1, 1, 1, 4),
lookup verify blocks that straddle the shards of a 128-slot cache on
(1, 1, 1, 4), and a shared prefix split over sp on (1, 1, 2, 2); so must
`generate` over a cache split over sp (1, 1, 1, 4) and over dp × tp
(2, 1, 2, 1). All of them run in one spawn of 4 ranks for the module
(`tests/torch_dist_workers.py`), every rank writing its tokens. One case
holds the cache forward (a 16-token prefill, then 4 decode steps) on
(1, 1, 2, 2) to the JAX model's on the same mesh, fp32 at 1e-5 (the pattern
of `tests/test_gqa.py:229-262`). The server's mesh errors (`lookup_k`,
`cache_len % sp`) and tp dividing the kv heads are checked in this process
over a stand-in mesh, as they raise before any collective. One more case
runs `eval_needle` on 2 ranks at tp 2 and compares its results with the
one-device run's: only rank 0 writes them.
"""

import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lwm_tpu.models import FlaxLLaMAForCausalLM
from lwm_tpu.models import LLaMAConfig as JaxConfig
from lwm_tpu_torch import checkpoint
from lwm_tpu_torch.apps import eval_needle
from lwm_tpu_torch.generation import GenerationConfig, generate
from lwm_tpu_torch.models import llama as port
from lwm_tpu_torch.serve import InflightServer
from lwm_tpu_torch.utils.convert import convert_flax_params, flax_params_tree

import torch_dist_workers as workers
from test_torch_needle import CLI_MODEL, TOKENIZER, write_haystack

BASE = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_sequence_length=256,
            scan_attention=False, scan_mlp=False, scan_layers=False)
FP32_TOL = dict(atol=1e-5, rtol=1e-5)

STAGGERED = [("submit", [3, 14, 15, 92, 65, 35], 12), ("step", 4),
             ("submit", [27, 18, 28], 9), ("submit", [7, 3, 9, 100, 42, 5, 77, 1, 2], 7)]
CHUNKED = [("submit", list(range(3, 40)), 8), ("step", 2), ("submit", [9, 8, 7], 6),
           ("submit", [5] * 30 + [6, 7], 5)]
# quoting prompts: the lookup proposals hit, and the slots' frontiers cross
# the 32-position shards of a 128-slot cache on sp 4 mid-block
LOOKUP = [("submit", [5, 6, 7, 8, 9, 10, 11] * 4, 40), ("step", 3),
          ("submit", [20, 21, 22, 23] * 6 + [20, 21], 60)]
PREFIX = [int(x) for x in np.random.default_rng(4).integers(2, 128, 100)]
PREFIX_SCRIPT = [("submit", [3, 4, 5], 10), ("step", 2), ("submit", [9, 10], 8)]

SERVE_RUNS = {
    "tp_pool": dict(mesh="1,2,2,1", server=dict(slots=2, cache_len=64, prompt_buckets=(8, 16)),
                    script=STAGGERED),
    "sp_slots": dict(mesh="1,1,2,2", server=dict(slots=2, cache_len=64,
                                                 prompt_buckets=(8, 16)), script=STAGGERED),
    "sp_slots_int8": dict(mesh="1,1,2,2", config=dict(kv_cache_dtype="int8"),
                          server=dict(slots=2, cache_len=64, prompt_buckets=(8, 16)),
                          script=STAGGERED),
    "chunked_sp4": dict(mesh="1,1,1,4", server=dict(slots=2, cache_len=64, prompt_buckets=(8,),
                                                    admit_chunk=8), script=CHUNKED),
    "lookup_sp4": dict(mesh="1,1,1,4", server=dict(slots=2, cache_len=128,
                                                   prompt_buckets=(32,), lookup_k=7),
                       script=LOOKUP),
    "prefix_sp2": dict(mesh="1,1,2,2", server=dict(slots=2, cache_len=64, prompt_buckets=(8,),
                                                   prefix_ids=PREFIX, prefix_chunk=64),
                       script=PREFIX_SCRIPT),
}
GEN_IDS = np.random.default_rng(6).integers(2, 128, (4, 20))
GEN_MASK = np.ones((4, 20), np.int64)
GEN_MASK[1, :5] = GEN_MASK[3, :11] = 0   # left padding
GEN_RUNS = {"generate_sp4": "1,1,1,4", "generate_dp_tp": "2,1,2,1"}
FORWARD = dict(mesh="1,1,2,2", config=dict(decode_index="shared"), prefill=16, cache=32,
               ids=np.random.default_rng(5).integers(0, 128, (2, 20)))


@functools.cache
def models():
    """(JAX model, port model) with the same weights."""
    jm = FlaxLLaMAForCausalLM(JaxConfig(**BASE, mesh_dim=None, attn_impl="xla"),
                              input_shape=(1, 8), seed=0)
    cfg = port.LLaMAConfig.from_dict(dict(BASE, attn_impl="auto", decode_index="per_row"))
    pm = port.LLaMAForCausalLM(cfg, device="cpu")
    pm.load_state_dict(convert_flax_params(jax.device_get(jm.params), cfg))
    return jm, pm


def one_device(pm, run):
    cfg = pm.config.replace(**run.get("config", {}))
    m = port.LLaMAForCausalLM.on_tensors(cfg, pm.state_dict(), torch.float32)
    return workers.drive_server(InflightServer(m, **run["server"]), run["script"])


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Every mesh run's tokens on each of the 4 ranks, and the cache
    forward's logits (one spawn)."""
    work = tmp_path_factory.mktemp("serve_mesh")
    _, pm = models()
    torch.save(pm.state_dict(), work / "weights.pt")
    runs = {name: dict(run, kind="serve") for name, run in SERVE_RUNS.items()}
    for name, mesh in GEN_RUNS.items():
        runs[name] = dict(kind="generate", mesh=mesh, config=dict(decode_index="shared"),
                          ids=GEN_IDS, mask=GEN_MASK, new=8)
    payload = dict(config=dict(pm.config.__dict__), weights=str(work / "weights.pt"), runs=runs,
                   forward=FORWARD)
    workers.spawn(workers.serve_mesh_ranks, 4, work, payload)
    ranks = [json.loads((work / f"serve_rank{r}.json").read_text()) for r in range(4)]
    return ranks, np.load(work / "forward.npy")


@pytest.mark.parametrize("name", list(SERVE_RUNS))
def test_mesh_server_emits_the_one_device_tokens(mesh_runs, name):
    ranks, _ = mesh_runs
    _, pm = models()
    want = {str(k): v for k, v in one_device(pm, SERVE_RUNS[name]).items()}
    for r, got in enumerate(ranks):
        assert got[name] == want, f"rank {r}"


@pytest.mark.parametrize("name", list(GEN_RUNS))
def test_mesh_generate_matches_one_device(mesh_runs, name):
    ranks, _ = mesh_runs
    _, pm = models()
    m = port.LLaMAForCausalLM.on_tensors(pm.config.replace(decode_index="shared"),
                                         pm.state_dict(), torch.float32)
    want = generate(m, torch.from_numpy(GEN_IDS), torch.from_numpy(GEN_MASK),
                    GenerationConfig(max_new_tokens=8, eos_token_id=-1, pad_token_id=0))
    for r, got in enumerate(ranks):
        assert got[name] == want.tolist(), f"rank {r}"


def test_cache_forward_on_mesh_matches_jax(mesh_runs, devices8, monkeypatch):
    """The port's cache forward on (1, 1, 2, 2) (tp 2 over the kv heads, the
    cache split over sp 2, the 16-token prefill's queries split too) against
    the JAX model's on the same mesh (`tests/test_gqa.py:229-262`), made of
    the first 4 forced CPU devices."""
    from lwm_tpu.models import llama as jax_llama
    from lwm_tpu.parallel.mesh import create_mesh

    monkeypatch.setattr(jax_llama, "_cached_mesh",
                        lambda mesh_dim: create_mesh(mesh_dim, devices=devices8[:4]))
    _, got = mesh_runs
    jm, _ = models()
    cfg = JaxConfig(**BASE, mesh_dim=FORWARD["mesh"], attn_impl="xla")
    mm = FlaxLLaMAForCausalLM(cfg, input_shape=(1, 16))
    mesh = JaxConfig.get_jax_mesh(FORWARD["mesh"])
    ids, s0, T = FORWARD["ids"], FORWARD["prefill"], FORWARD["cache"]
    b = ids.shape[0]

    @jax.jit   # one compile a shape (the serving path's own jitted apply, serve.py)
    def step(cache, ids, pos):
        out, new = mm.module.apply({"params": jm.params, "cache": cache}, ids,
                                   jnp.ones((b, T), "i4"), None, pos, True, False, False, False,
                                   True, mutable=["cache"])
        return out.logits, new["cache"]

    with mesh:
        cache = mm.init_cache(b, T)
        out, cache = step(cache, ids[:, :s0], jnp.broadcast_to(jnp.arange(s0)[None], (b, s0)))
        logits = [np.asarray(out)]
        for t in range(s0, ids.shape[1]):
            out, cache = step(cache, ids[:, t:t + 1], jnp.full((b, 1), t))
            logits.append(np.asarray(out))
    np.testing.assert_allclose(got, np.concatenate(logits, 1), **FP32_TOL)


def stand_in_mesh(tp=1, sp=1, batch=1):
    """What the server and the model read of a mesh, before any collective."""
    return types.SimpleNamespace(dims=(batch, 1, tp, sp), size=batch * tp * sp, tp=tp, sp=sp,
                                 batch=batch, fsdp=1, tp_rank=0, sp_rank=0, batch_rank=0)


@pytest.mark.parametrize("case", ["lookup_k", "cache_len_sp", "slots_dp", "tp_kv_heads"])
def test_mesh_errors(case):
    _, pm = models()

    def server(mesh, **kw):
        m = port.LLaMAForCausalLM.on_tensors(pm.config, pm.state_dict(), torch.float32, mesh)
        return InflightServer(m, mesh=mesh, **kw)

    if case == "lookup_k":
        with pytest.raises(ValueError, match="lookup_k <= 63"):
            server(stand_in_mesh(sp=4), slots=2, cache_len=128, lookup_k=64)
    elif case == "cache_len_sp":
        with pytest.raises(ValueError, match="must divide the sp axis"):
            server(stand_in_mesh(sp=3), slots=2, cache_len=128)
    elif case == "slots_dp":
        with pytest.raises(ValueError, match="multiple of dp\\*fsdp=2"):
            server(stand_in_mesh(batch=2), slots=3, cache_len=128)
    else:   # tp 4 > h_kv 2 (`tests/test_gqa.py:264-268`)
        with pytest.raises(ValueError, match="num_key_value_heads"):
            port.LLaMAForCausalLM(pm.config, device="cpu", mesh=stand_in_mesh(tp=4))


@pytest.fixture(scope="module")
def needle_inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("needle_mesh")
    haystack = tmp / "haystack.jsonl"
    write_haystack(haystack)
    cfg = port.LLaMAConfig.from_dict(CLI_MODEL)
    model = port.LLaMAForCausalLM(cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    params = tmp / "params"
    checkpoint.save_tree(flax_params_tree(model.state_dict(), cfg), str(params))
    return tmp, haystack, params


def test_eval_needle_on_two_ranks_writes_the_one_device_results(needle_inputs):
    tmp, haystack, params = needle_inputs
    update = ", ".join(f"{k}={v!r}" for k, v in CLI_MODEL.items())

    def argv(out, mesh_dim):
        return ["--device=cpu", "--load_llama_config=debug",
                f"--update_llama_config=dict({update})",
                f"--load_checkpoint=params::{params}", f"--tokenizer={TOKENIZER}",
                f"--haystack_file={haystack}", f"--output_file={out}", f"--mesh_dim={mesh_dim}",
                "--context_lengths_min=300", "--context_lengths_max=400",
                "--n_context_length_intervals=2", "--n_document_depth_intervals=2",
                "--n_rounds=1", "--max_tokens_per_batch=100000"]

    eval_needle.main(argv(tmp / "one.json", "1,-1,1,1"))
    workers.spawn(workers.eval_needle_ranks, 2, tmp, argv(tmp / "mesh.json", "!1,-1,2,1"))
    assert json.loads((tmp / "mesh.json").read_text()) == json.loads(
        (tmp / "one.json").read_text())
    writes = [json.loads((tmp / f"writes_rank{r}.json").read_text()) for r in range(2)]
    assert writes[0] and all(w == str(tmp / "mesh.json") for w in writes[0])
    assert writes[1] == []   # only rank 0 writes
