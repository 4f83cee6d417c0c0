"""The port's mesh grammar and sequence-parallel ring attention against the
JAX package's.

`parse_mesh_dims` is held to `lwm_tpu.parallel.mesh.parse_mesh_dims` on the
same strings, errors included. `lwm_tpu_torch.ops.ring.ring_attention` runs
on gloo ranks spawned once for the module (world 2 and 4, the CPU) and is
held to JAX's `ring_attention` under `shard_map` on the forced CPU mesh
(1, 1, 1, sp) (the pattern of `tests/test_attention.py:580-622`, its XLA
block oracle): both layouts, a per-key bias, segment ids of three packed
documents and GQA, fp32, out, dq, dk and dv at 1e-5. Every query sees at
least one key (the bias's holes spare each document's first token).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as PS

from lwm_tpu.ops.ring import ring_attention as jax_ring_attention
from lwm_tpu.parallel.mesh import parse_mesh_dims as jax_parse_mesh_dims
from lwm_tpu_torch.ops import striped as torch_striped
from lwm_tpu_torch.parallel.mesh import parse_mesh_dims

import torch_dist_workers as workers

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

FP32_TOL = dict(atol=1e-5, rtol=1e-5)

MESH_STRINGS = ["1,-1,1,1", "!1,-1,2,2", "2,1,1,4", "1,1,1,-1", " !2,2,1,2 ", "1,2,3",
                "-1,-1,1,1", "1,3,1,-1", "2,2,2,2", "1,x,1,1"]


@pytest.mark.parametrize("n_devices", [4, 8])
@pytest.mark.parametrize("text", MESH_STRINGS)
def test_parse_mesh_dims_matches_jax(text, n_devices):
    try:
        want = jax_parse_mesh_dims(text, n_devices)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_mesh_dims(text, n_devices)
        assert str(got.value) == str(e)
        return
    assert parse_mesh_dims(text, n_devices) == want


def test_striped_layout_matches_jax():
    from lwm_tpu.ops import striped as jax_striped

    for seq, sp in ((16, 2), (24, 4), (32, 8)):
        np.testing.assert_array_equal(torch_striped.stripe_positions(seq, sp),
                                      jax_striped.stripe_positions(seq, sp))
        x = np.arange(2 * seq).reshape(2, seq)
        np.testing.assert_array_equal(torch_striped.stripe_permute(x, sp, 1),
                                      jax_striped.stripe_permute(x, sp, 1))
        import torch

        xt = torch.from_numpy(x)
        assert torch.equal(torch_striped.stripe_unpermute(torch_striped.stripe_permute(
            xt, sp, 1), sp, 1), xt)
    with pytest.raises(ValueError, match="multiple of sp"):
        torch_striped.stripe_positions(10, 4)


RING_CASES = [
    dict(world=w, layout=layout, h=4, h_kv=h_kv, s_local=s, d=16, seed=10 * w + i)
    for i, (w, layout, h_kv, s) in enumerate([
        (2, "contiguous", 4, 48), (2, "striped", 2, 48),
        (4, "contiguous", 2, 32), (4, "striped", 4, 32), (4, "striped", 1, 40),
    ])
]


@pytest.fixture(scope="module")
def port_ring(tmp_path_factory):
    """The port's ring at every RING_CASES case, one spawn of 4 gloo ranks."""
    work = tmp_path_factory.mktemp("ring")
    workers.spawn(workers.ring_ranks, 4, work, RING_CASES)
    out = []
    for i, case in enumerate(RING_CASES):
        parts = [np.load(work / f"ring{i}_rank{r}.npz") for r in range(case["world"])]
        out.append({k: np.concatenate([p[k] for p in parts], 1) for k in ("out", "dq", "dk",
                                                                            "dv")})
    return out


def _jax_ring(case):
    q, k, v, g, bias, segs = workers.ring_inputs(case)
    mesh = Mesh(np.array(jax.devices()[:case["world"]]).reshape(1, 1, 1, case["world"]),
                ("dp", "fsdp", "tp", "sp"))
    bkw = dict(causal_block_size=1, deterministic=True, query_chunk_size=16,
               key_chunk_size=16, dtype=jnp.float32, precision=None, prevent_cse=True,
               policy=jax.checkpoint_policies.nothing_saveable, layout=case["layout"])
    seq_spec = PS(("dp", "fsdp"), "sp", "tp", None)
    fn = shard_map(
        partial(jax_ring_attention, axis_name="sp", float32_logits=True, cache_idx=None,
                blockwise_kwargs=bkw),
        mesh=mesh,
        in_specs=(seq_spec, seq_spec, seq_spec, PS(("dp", "fsdp"), None, None, None),
                  PS(("dp", "fsdp"), None)),
        out_specs=seq_spec, check_vma=False,
    )
    @jax.jit   # jitted: an eager shard_map and its vjp take seconds a case
    def out_and_grads(q, k, v, g):
        out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, jnp.asarray(bias), jnp.asarray(segs)),
                           q, k, v)
        return out, vjp(g)

    with mesh:
        out, grads = out_and_grads(*(jnp.asarray(x) for x in (q, k, v, g)))
    return dict(out=out, dq=grads[0], dk=grads[1], dv=grads[2])


@pytest.mark.parametrize("i", range(len(RING_CASES)),
                         ids=[f"sp{c['world']}_{c['layout']}_hkv{c['h_kv']}" for c in RING_CASES])
def test_ring_attention_matches_jax_ring(port_ring, i):
    want = _jax_ring(RING_CASES[i])
    for name in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(port_ring[i][name], np.asarray(want[name]), err_msg=name,
                                   **FP32_TOL)
