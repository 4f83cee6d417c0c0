"""The port's `ring_attention_inference` (attention over a KV cache whose
sequence is split across sp ranks) against the JAX package's.

`lwm_tpu_torch.ops.ring.ring_attention_inference` runs on gloo ranks spawned
once for the module (`tests/torch_dist_workers.py`; sp 2 on the sp groups of
a (1, 1, 2, 2) mesh, sp 4 on (1, 1, 1, 4)) and is held to JAX's
`ring_attention_inference` under `shard_map` on the forced CPU mesh
(1, 1, 1, sp), fp32 at 1e-5 (JAX's XLA tile, its path off the TPU). Cases:
decode, prefill with the queries split over sp and replicated, a short
verify block's full-tile mask, GQA, an int8 cache with its scales (JAX reads
it dequantized, as its model hands it over) and a shard whose keys are all
masked. K4's plain twin is also held with `kv_len` as a tensor, a scalar
and one a row, to its int form.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as PS

from lwm_tpu.ops.ring import ring_attention_inference as jax_ring_inference
from lwm_tpu_torch.ops.decode import flash_decode, flash_decode_split_plain

import torch_dist_workers as workers

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

FP32_TOL = dict(atol=1e-5, rtol=1e-5)


def _case(name, sp, sq, q_offset, h_kv=4, mask="key", **kw):
    return dict(name=name, sp=sp, h=4, h_kv=h_kv, sq=sq, T=64, d=16, q_offset=q_offset,
                mask=mask, seed=len(name) * 7 + sp + sq, **kw)


CASES = [
    _case("decode", 2, 1, 40),
    _case("decode_gqa", 2, 1, 50, h_kv=2),
    _case("prefill_sharded", 2, 16, 20, q_sharded=True),
    _case("prefill_replicated", 2, 15, 20),
    _case("verify_tile_gqa", 2, 5, 30, h_kv=1, mask="tile"),
    _case("decode_int8", 2, 1, 45, int8=True),
    _case("prefill_int8_sharded", 2, 16, 10, int8=True, q_sharded=True),
    _case("decode_dead_shard", 2, 1, 50, dead_shard=1),
    _case("decode_gqa", 4, 1, 60, h_kv=2),
    _case("prefill_sharded", 4, 16, 8, q_sharded=True),
    _case("prefill_replicated_gqa", 4, 6, 30, h_kv=2),
    _case("decode_int8_dead_shard", 4, 1, 55, int8=True, dead_shard=2),
    _case("verify_tile", 4, 7, 35, mask="tile"),
]


@pytest.fixture(scope="module")
def port_out(tmp_path_factory):
    """The port's outputs at every case (all rows, in order), one spawn of
    4 gloo ranks."""
    work = tmp_path_factory.mktemp("ring_inference")
    workers.spawn(workers.ring_inference_ranks, 4, work, CASES)
    out = []
    for i, case in enumerate(CASES):
        ranks = range(case["sp"]) if case["sp"] == 4 else (0, 1)   # (1,1,2,2): sp ranks 0, 1
        parts = [np.load(work / f"ri{i}_rank{r}.npy") for r in ranks]
        out.append(np.concatenate(parts, 1) if case.get("q_sharded") else parts[0])
        for p in parts[1:]:
            if not case.get("q_sharded"):   # replicated queries: every rank the same rows
                np.testing.assert_array_equal(p, parts[0])
    return out


def _jax_out(case):
    q, k, v, scales, valid, q_offset = workers.ring_inference_inputs(case)
    if scales is not None:   # the JAX model dequantizes before the mesh path
        k = k.astype(np.float32) * scales[0][..., None]
        v = v.astype(np.float32) * scales[1][..., None]
    sq, T = q.shape[1], k.shape[2]
    frontier = q_offset + np.arange(sq)
    mask = valid[:, None, None, :] & (np.arange(T)[None, None, None, :]
                                      <= frontier[None, None, :, None])
    sp = case["sp"]
    q_sharded = case.get("q_sharded", False)
    q_dim = "sp" if q_sharded else None
    mesh = Mesh(np.array(jax.devices()[:sp]).reshape(1, 1, 1, sp), ("dp", "fsdp", "tp", "sp"))
    fn = jax.jit(shard_map(   # jitted: an eager shard_map takes seconds a case
        partial(jax_ring_inference, axis_name="sp", q_sharded=q_sharded, key_chunk_size=16,
                impl="auto"),
        mesh=mesh,
        in_specs=(PS(None, q_dim, None, None), PS(None, None, "sp", None),
                  PS(None, None, "sp", None), PS(None, None, q_dim, None)),
        out_specs=PS(None, q_dim, None, None), check_vma=False,
    ))
    with mesh:
        return np.asarray(fn(*(jnp.asarray(x) for x in (q, k, v, mask))))


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"sp{c['sp']}_{c['name']}" for c in CASES])
def test_ring_attention_inference_matches_jax(port_out, i):
    np.testing.assert_allclose(port_out[i], _jax_out(CASES[i]), **FP32_TOL)


@pytest.mark.parametrize("form", ["scalar", "rows"])
def test_k4_twin_takes_kv_len_on_the_device(form):
    """K4's plain twins read `kv_len` as an int32 tensor (a scalar, or one a
    row) as they read the int: the same output and partials; one a row
    bounds each row by its own."""
    rng = np.random.default_rng(3)
    b, h, h_kv, T, d = 3, 8, 2, 96, 64
    q = torch.from_numpy(rng.standard_normal((b, 1, h, d), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, h_kv, T, d), np.float32)) for _ in "kv")
    mask = torch.from_numpy(rng.random((b, T)) > 0.3)
    lens = [70, 33, 96]
    if form == "scalar":
        got = flash_decode(q, k, v, mask, torch.tensor(70, dtype=torch.int32),
                           return_partials=True)
        want = flash_decode(q, k, v, mask, 70, return_partials=True)
        split = flash_decode_split_plain(q, k, v, mask, torch.tensor(70), return_partials=True)
        want_split = flash_decode_split_plain(q, k, v, mask, 70, return_partials=True)
    else:
        got = flash_decode(q, k, v, mask, torch.tensor(lens, dtype=torch.int32),
                           return_partials=True)
        want = [torch.cat(x) for x in zip(*(
            flash_decode(q[i:i + 1], k[i:i + 1], v[i:i + 1], mask[i:i + 1], n,
                         return_partials=True) for i, n in enumerate(lens)))]
        split = flash_decode_split_plain(q, k, v, mask, torch.tensor(lens), split=256,
                                         return_partials=True)
        want_split = [torch.cat(x) for x in zip(*(
            flash_decode_split_plain(q[i:i + 1], k[i:i + 1], v[i:i + 1], mask[i:i + 1], n,
                                     split=256, return_partials=True)
            for i, n in enumerate(lens)))]
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=0, rtol=0)
    for a, w in zip(split, want_split):
        torch.testing.assert_close(a, w, atol=0, rtol=0)
