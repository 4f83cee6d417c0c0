"""The port's checkpoint streams (lwm_tpu_torch.checkpoint, utils/msgpack.py)
against the JAX package's (`lwm_tpu/checkpoint.py`, msgpack and flax): the
released-format v1 golden fixture and v2 streams written by the JAX writer
read equal in both packages, the port's writer gives the JAX writer's bytes,
and the golden params give the JAX model's logits through the port.
"""

import os

import jax.numpy as jnp
import msgpack as real_msgpack
import numpy as np
import pytest
import torch
from flax.core import unfreeze
from flax.serialization import msgpack_serialize, to_bytes

from lwm_tpu import checkpoint as jax_ckpt
from lwm_tpu.models import FlaxLLaMAForCausalLM
from lwm_tpu.models import LLaMAConfig as JaxConfig
from lwm_tpu_torch import checkpoint as ckpt
from lwm_tpu_torch.models import llama as port
from lwm_tpu_torch.utils import msgpack
from lwm_tpu_torch.utils.convert import convert_flax_params

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "v1_golden_params.ckpt")


def as_numpy(x):
    """A loaded leaf as numpy; bfloat16 tensors by their fp32 values."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32 if np.asarray(x).dtype.name == "bfloat16" else None)


def assert_same_leaves(got, want):
    assert list(got) == list(want)
    for key in want:
        g, w = got[key], want[key]
        if isinstance(w, (str, bytes, bool, type(None))):
            assert g == w and type(g) is type(w), key
            continue
        wn = np.asarray(w)
        assert (g.dtype == torch.bfloat16) if wn.dtype.name == "bfloat16" else (
            np.asarray(g).dtype == wn.dtype), key
        assert tuple(g.shape) == wn.shape, key
        np.testing.assert_array_equal(as_numpy(g), as_numpy(w), err_msg=str(key))


def test_golden_v1_stream_reads_as_jax_reads_it():
    assert_same_leaves(ckpt.load_stream(GOLDEN), jax_ckpt.load_stream(GOLDEN))


def v2_leaves():
    """Leaves of every kind the v2 writer takes: a bf16 leaf, leaves chunked
    by rows and by flat elements at a tiny chunk_bytes, a 0-d leaf, ints,
    an empty leaf, and obj records."""
    rng = np.random.default_rng(0)
    return {
        ("params", "wte", "embedding"): rng.standard_normal((6, 5)).astype(np.float32),
        ("params", "bf16"): jnp.asarray(rng.standard_normal((3, 7)), jnp.bfloat16),
        ("params", "rows"): rng.standard_normal((9, 4)).astype(np.float32),   # 16 B rows
        ("params", "flat"): rng.integers(-99, 99, (2, 40)).astype(np.int8),  # 40 B rows
        ("step",): np.asarray(1234567, np.int64),
        ("scalar_f32",): np.asarray(-2.5, np.float32),
        ("empty",): np.zeros((0, 3), np.float32),
        ("meta", "name"): "lwm",
        ("meta", "blob"): b"\x00\x01raw",
        ("meta", "flag"): True,
        ("meta", "none"): None,
    }


@pytest.mark.parametrize("chunk_bytes", [32, ckpt.DEFAULT_CHUNK_BYTES])
def test_v2_stream_written_by_jax_reads_equal(tmp_path, chunk_bytes):
    path = str(tmp_path / "v2.ckpt")
    jax_ckpt.save_stream(v2_leaves(), path, chunk_bytes=chunk_bytes)
    assert_same_leaves(ckpt.load_stream(path), jax_ckpt.load_stream(path))
    sub = ckpt.load_stream(path, remove_prefix=("params",))
    assert sorted(sub) == [("bf16",), ("flat",), ("rows",), ("wte", "embedding")]


def test_iter_stream_reads_leaves_in_file_order(tmp_path):
    """`iter_stream` yields the stream's records one at a time, in the
    order the JAX reader meets them, with the JAX reader's values."""
    path = str(tmp_path / "v2.ckpt")
    jax_ckpt.save_stream(v2_leaves(), path, chunk_bytes=32)
    records = list(ckpt.iter_stream(path))
    assert_same_leaves(dict(records), jax_ckpt.load_stream(path))   # keys in order too
    assert list(ckpt.iter_stream(GOLDEN)) and dict(ckpt.iter_stream(GOLDEN)).keys() == \
        ckpt.load_stream(GOLDEN).keys()


@pytest.mark.parametrize("float_dtype", [None, "bf16"])
@pytest.mark.parametrize("chunk_bytes", [32, ckpt.DEFAULT_CHUNK_BYTES])
def test_v2_writer_gives_jax_writer_bytes(tmp_path, chunk_bytes, float_dtype):
    leaves = v2_leaves()
    jax_ckpt.save_stream(leaves, str(tmp_path / "jax"), float_dtype=float_dtype,
                         chunk_bytes=chunk_bytes)
    mine = {k: torch.from_numpy(np.asarray(v, np.float32)).bfloat16() if k == ("params", "bf16")
            else v for k, v in leaves.items()}
    ckpt.save_stream(mine, str(tmp_path / "port"), float_dtype=float_dtype,
                     chunk_bytes=chunk_bytes)
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()


def test_msgpack_widths_and_ext_match_msgpack():
    """Every width of every type the decoder takes, and the encoder's bytes
    against msgpack.packb's; flax's ext records through flax_restore."""
    objs = [None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
            2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
            1.5, -0.0, "", "a" * 31, "é" * 20, "b" * 255, "c" * 256, "d" * 70000,
            b"", b"x" * 255, b"y" * 256, b"z" * 70000, list(range(15)), list(range(16)),
            list(range(70000)), {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
            {str(i): [i, {"n": None}] for i in range(70000)}]
    for obj in objs:
        want = real_msgpack.packb(obj, use_bin_type=True)
        assert msgpack.pack(obj) == want
        assert msgpack.unpackb(want) == obj
    for code, n in [(5, 1), (5, 2), (5, 4), (5, 8), (5, 16), (3, 3), (7, 300), (7, 70000)]:
        want = real_msgpack.packb(real_msgpack.ExtType(code, b"q" * n))
        assert msgpack.pack(msgpack.ExtType(code, b"q" * n)) == want
        assert msgpack.unpackb(want) == msgpack.ExtType(code, b"q" * n)
    f32 = real_msgpack.packb(1.25, use_single_float=True)
    assert msgpack.unpackb(f32) == 1.25
    tree = {"a": np.arange(6, dtype=np.int32).reshape(2, 3), "s": np.float32(3.5),
            "c": 1 + 2j, "bf": jnp.asarray([[1.5, -2.0]], jnp.bfloat16),
            "nested": {"u8": np.arange(4, dtype=np.uint8)}}
    got = msgpack.flax_restore(msgpack_serialize(tree))
    np.testing.assert_array_equal(got["a"], tree["a"])
    assert got["s"] == np.float32(3.5) and got["s"].dtype == np.float32
    assert got["c"] == 1 + 2j
    assert got["bf"].dtype == torch.bfloat16 and got["bf"].tolist() == [[1.5, -2.0]]
    np.testing.assert_array_equal(got["nested"]["u8"], tree["nested"]["u8"])
    with pytest.raises(ValueError, match="ends inside"):
        msgpack.unpackb(real_msgpack.packb("abc")[:-1])


def test_load_specs(tmp_path):
    """params::, trainstate_params:: and flax_params:: as the JAX loader
    dispatches them; trainstate:: refused when disallowed."""
    want = jax_ckpt.StreamingCheckpointer.load_trainstate_checkpoint(f"params::{GOLDEN}")[1]
    _, got = ckpt.load_trainstate_checkpoint(f"params::{GOLDEN}", disallow_trainstate=True)
    flat_want = ckpt.flatten_dict(unfreeze(want))
    assert_same_leaves(ckpt.flatten_dict(got), flat_want)

    state = {"params": {"params": got["params"]}, "step": np.asarray(3, np.int32)}
    jax_ckpt.StreamingCheckpointer.save_train_state_to_file(state, str(tmp_path / "ts"))
    _, sub = ckpt.load_trainstate_checkpoint(f"trainstate_params::{tmp_path / 'ts'}")
    assert_same_leaves(ckpt.flatten_dict(sub), flat_want)
    whole, none = ckpt.load_trainstate_checkpoint(f"trainstate::{tmp_path / 'ts'}")
    assert none is None and int(whole["step"]) == 3
    with pytest.raises(ValueError, match="disallowed"):
        ckpt.load_trainstate_checkpoint(f"trainstate::{tmp_path / 'ts'}", disallow_trainstate=True)

    (tmp_path / "flax").write_bytes(to_bytes(unfreeze(want)["params"]))
    _, flax_got = ckpt.load_trainstate_checkpoint(f"flax_params::{tmp_path / 'flax'}")
    assert_same_leaves(ckpt.flatten_dict(flax_got), flat_want)
    with pytest.raises(ValueError, match="invalid load_from type"):
        ckpt.load_trainstate_checkpoint(f"bogus::{GOLDEN}")


GOLDEN_CONFIG = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                     num_attention_heads=4, max_sequence_length=64, scan_attention=False,
                     scan_mlp=False, scan_layers=False)


def test_golden_params_give_jax_logits():
    _, params = ckpt.load_trainstate_checkpoint(f"params::{GOLDEN}")
    _, jparams = jax_ckpt.StreamingCheckpointer.load_trainstate_checkpoint(f"params::{GOLDEN}")
    jm = FlaxLLaMAForCausalLM(JaxConfig(**GOLDEN_CONFIG, mesh_dim=None, attn_impl="xla"),
                              input_shape=(1, 8), seed=0, _do_init=False)
    cfg = port.LLaMAConfig.from_dict(GOLDEN_CONFIG)
    pm = port.LLaMAForCausalLM(cfg, device="cpu")
    pm.load_state_dict(convert_flax_params(params, cfg))
    ids = np.random.default_rng(1).integers(0, 128, (2, 12))
    want = np.asarray(jm(jnp.asarray(ids, jnp.int32), params=jparams["params"]).logits)
    got = pm(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_bf16_stream_converts(tmp_path):
    """A bf16 params stream (as the JAX trainer saves with float_dtype bf16)
    loads as bfloat16 tensors that the converter takes as they are."""
    _, params = ckpt.load_trainstate_checkpoint(f"params::{GOLDEN}")
    ckpt.save_tree(params["params"], str(tmp_path / "bf16"), float_dtype="bf16")
    _, p16 = ckpt.load_trainstate_checkpoint(f"params::{tmp_path / 'bf16'}")
    wq = p16["params"]["transformer"]["h"]["0"]["attention"]["wq"]["kernel"]
    assert isinstance(wq, torch.Tensor) and wq.dtype == torch.bfloat16
    cfg = port.LLaMAConfig.from_dict(GOLDEN_CONFIG)
    sd = convert_flax_params(p16, cfg)
    want = torch.from_numpy(np.asarray(
        params["params"]["transformer"]["h"]["0"]["attention"]["wq"]["kernel"])).bfloat16().T
    assert sd["h.0.attention.wq.weight"].dtype == torch.bfloat16
    assert torch.equal(sd["h.0.attention.wq.weight"], want)
