"""The port's data pipeline (lwm_tpu_torch.data, .native, .utils.io) against
the JAX package's (`lwm_tpu/data/text.py`, `lwm_tpu/native`): the field DSL
gives the same tokens and masks, and `JsonDataset` the same batches byte for
byte, with the native and the Python packer, `pad`, `always_start_with_bos`,
a tokenizer pool, DP line sharding and resume from a state dict (the port's
or one the JAX trainer wrote, read without ml_collections). The metrics
that do not depend on the clock (`dataset_file_loc`, `_example_index`,
`_total_tokens`) are held exactly; the two throughput ones read the wall
clock and are only checked to be positive.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
from transformers import AutoTokenizer

from lwm_tpu.data import JsonDataset as JaxJsonDataset
from lwm_tpu.data import TextProcessor as JaxTextProcessor
from lwm_tpu.utils.io import save_pickle as jax_save_pickle
from lwm_tpu_torch.data import DatasetFactory, JsonDataset, TextProcessor
from lwm_tpu_torch.native import token_buffer
from lwm_tpu_torch.utils.io import load_pickle, open_file
from lwm_tpu_torch.utils.tokenizer import Tokenizer

REPO = Path(__file__).resolve().parent.parent
TOKENIZER = str(REPO / "tests" / "fixtures" / "tokenizer")
NODE_INFO = dict(dp_node_size=1, dp_node_rank=0)
EXACT_METRICS = ("dataset_file_loc", "dataset_example_index", "dataset_total_tokens")
BATCH_KEYS = ("input_tokens", "target_tokens", "loss_masks", "input_vision_masks",
              "target_vision_masks")
WORDS = "the magic number is in haystack needle model world sky blue green".split()


@pytest.fixture(scope="module")
def tokenizers():
    return Tokenizer(TOKENIZER), AutoTokenizer.from_pretrained(TOKENIZER)


@pytest.fixture(scope="module")
def jsonl(tmp_path_factory):
    """Lines of 1-80 words from a seed, with question/answer fields, a
    field spec of their own, and one blank and one broken line."""
    rng = np.random.default_rng(0)
    path = tmp_path_factory.mktemp("data") / "data.jsonl"

    def words(lo, hi):
        return " ".join(rng.choice(WORDS, rng.integers(lo, hi)))

    with open(path, "w") as f:
        for i in range(160):
            f.write(json.dumps({"text": f"{words(1, 80)} {i}", "question": words(1, 12),
                                "answer": words(1, 12), "spec": "[question],answer"}) + "\n")
            if i == 40:
                f.write("\n{broken json\n")
    return str(path)


DSL_CASES = {
    "basic": dict(fields="text"),
    "masked_and_join": dict(fields="[question],answer", add_bos_token=False,
                            add_eos_token=False),
    "subfields": dict(fields="[question+answer],text", subfield_separator=" | "),
    "from_example": dict(fields_from_example="spec"),
    "special_tokens": dict(fields="<|bos|>,text,[<|eos|>]", add_bos_token=False,
                           add_eos_token=False),
    "prepend": dict(fields="question,answer", prepend_text="Q: "),
}


@pytest.mark.parametrize("case", sorted(DSL_CASES))
def test_field_dsl_matches_jax(tokenizers, case):
    port_tok, hf_tok = tokenizers
    ours = TextProcessor(DSL_CASES[case], port_tok)
    theirs = JaxTextProcessor(JaxTextProcessor.get_default_config(DSL_CASES[case]), hf_tok)
    example = {"text": "the magic number is 42", "question": "where is the needle",
               "answer": "in the haystack", "spec": "[question],answer"}
    assert ours(example) == theirs(example)
    assert ours((example, 7, 3), has_aux=True) == theirs((example, 7, 3), has_aux=True)


DATASET_CASES = {
    "native": dict(),
    "python": dict(use_native_buffer=False),
    "pad": dict(pad=True, seq_length=24),
    "bos_native": dict(always_start_with_bos=True),
    "bos_python": dict(always_start_with_bos=True, use_native_buffer=False),
    "pool": dict(tokenizer_processes=2, tokenizer_parallel_batch_size=16,
                 tokenizer_parallel_chunk_size=4),
}


def _config(path, **updates):
    return dict(dict(path=path, seq_length=32, batch_size=2, return_local_batch=True), **updates)


def _port_dataset(path, tok, fields="text", **updates):
    return JsonDataset(_config(path, **updates), tok, TextProcessor(dict(fields=fields), tok),
                       NODE_INFO)


def _jax_dataset(path, tok, fields="text", **updates):
    updates.pop("tokenizer_processes", None)   # the JAX pool gives its serial batches
    proc = JaxTextProcessor(JaxTextProcessor.get_default_config(dict(fields=fields)), tok)
    config = JaxJsonDataset.get_default_config(_config(path, **updates))
    return JaxJsonDataset(config, tok, proc, node_info=NODE_INFO)


def _take(dataset, n):
    it = iter(dataset)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def assert_same_batches(ours, theirs):
    assert len(ours) == len(theirs)
    for (b, m), (wb, wm) in zip(ours, theirs):
        for key in BATCH_KEYS:
            assert b[key].dtype == wb[key].dtype and b[key].shape == wb[key].shape, key
            assert b[key].tobytes() == wb[key].tobytes(), key
        for key in EXACT_METRICS:
            assert m[key] == wm[key], key
        assert m.keys() == wm.keys()
        assert m["dataset_accumulated_tps"] > 0 and m["dataset_average_tps"] > 0


@pytest.mark.parametrize("case", sorted(DATASET_CASES))
def test_batches_match_jax_byte_for_byte(tokenizers, jsonl, case):
    port_tok, hf_tok = tokenizers
    updates = DATASET_CASES[case]
    n = 85 if case == "pad" else 12   # past the broken line; pad wraps past the file's end
    assert_same_batches(_take(_port_dataset(jsonl, port_tok, **updates), n),
                        _take(_jax_dataset(jsonl, hf_tok, **updates), n))


def test_resume_from_state_dicts(tokenizers, jsonl):
    """From a JAX dataset's state (its config a ConfigDict) the port resumes
    as the JAX dataset does. The port's state names the line after the last
    one read (the JAX state names that last line, ROADMAP C4), so from it
    both packages resume with each example's index one above the JAX
    resume's, as in an uninterrupted run; the batches are the same."""
    port_tok, hf_tok = tokenizers
    ours, theirs = _port_dataset(jsonl, port_tok), _jax_dataset(jsonl, hf_tok)
    _take(ours, 5)
    _take(theirs, 5)
    state, jax_state = ours.get_state_dict(), theirs.get_state_dict()
    assert (state["file_loc"], state["total_tokens"]) == (jax_state["file_loc"],
                                                         jax_state["total_tokens"])
    assert state["index"] == jax_state["index"] + 1
    want = _jax_dataset(jsonl, hf_tok)
    want.load_state_dict(jax_state)
    want = _take(want, 4)
    resumed = _port_dataset(jsonl, port_tok, seq_length=8)   # the state's config wins
    resumed.load_state_dict(jax_state)
    assert resumed.seq_length == 32
    assert_same_batches(_take(resumed, 4), want)
    shifted = [(b, dict(m, dataset_example_index=m["dataset_example_index"] + 1))
               for b, m in want]
    for dataset in (_port_dataset(jsonl, port_tok), _jax_dataset(jsonl, hf_tok)):
        dataset.load_state_dict(state)
        assert_same_batches(_take(dataset, 4), shifted)


def test_dp_sharding_matches_jax(tokenizers, jsonl):
    port_tok, hf_tok = tokenizers
    for rank in range(2):
        info = dict(dp_node_size=2, dp_node_rank=rank)
        config = _config(jsonl, batch_size=4)
        ours = JsonDataset(config, port_tok, TextProcessor(dict(fields="text"), port_tok), info)
        theirs = JaxJsonDataset(JaxJsonDataset.get_default_config(config), hf_tok,
                                JaxTextProcessor(JaxTextProcessor.get_default_config(
                                    dict(fields="text")), hf_tok), node_info=info)
        lines = ours.json_iterator()
        got = [next(lines)[1:] for _ in range(30)]
        lines.close()
        assert all(index % 2 == rank for _, index in got)
        assert_same_batches(_take(ours, 3), _take(theirs, 3))


def test_jax_dataset_state_reads_without_ml_collections(tokenizers, jsonl, tmp_path):
    """A dataset.pkl the JAX trainer wrote (its config a pickled ConfigDict)
    loads in a process where ml_collections cannot be imported."""
    _, hf_tok = tokenizers
    theirs = _jax_dataset(jsonl, hf_tok)
    _take(theirs, 3)
    path = tmp_path / "dataset.pkl"
    jax_save_pickle(theirs.get_state_dict(), str(path))
    code = textwrap.dedent(f"""
        import json, sys
        sys.modules["ml_collections"] = None
        from lwm_tpu_torch.utils.io import load_pickle
        state = load_pickle({str(path)!r})
        assert type(state["config"]) is dict, type(state["config"])
        print(json.dumps(state))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    want = theirs.get_state_dict()
    assert json.loads(out.stdout) == dict(want, config=want["config"].to_dict())
    assert load_pickle(str(path))["index"] == want["index"]


def test_io_refuses_gcs_and_foreign_pickles(tmp_path):
    with pytest.raises(NotImplementedError, match="gcsfs"):
        open_file("gs://bucket/data.jsonl", "r")
    path = tmp_path / "evil.pkl"
    jax_save_pickle({"f": np.float32}, str(path))
    with pytest.raises(Exception, match="refusing"):
        load_pickle(str(path))


def test_native_buffer_direct():
    assert token_buffer.native_available(), "g++ token buffer failed to build"
    buf = token_buffer.NativeTokenBuffer()
    buf.append([1, 2, 3, 4, 5], [1.0, 0.0, 1.0, 1.0, 0.0])
    assert len(buf) == 5
    assert buf.emit(1, 8) is None
    buf.append(list(range(10, 20)), [1.0] * 10)
    batch = buf.emit(2, 4)
    np.testing.assert_array_equal(batch["input_tokens"].reshape(-1), [1, 2, 3, 4, 5, 10, 11, 12])
    np.testing.assert_array_equal(batch["target_tokens"].reshape(-1),
                                  [2, 3, 4, 5, 10, 11, 12, 13])
    np.testing.assert_array_equal(batch["loss_masks"].reshape(-1),
                                  [0.0, 1.0, 1.0, 0.0, 1.0, 1.0, 1.0, 1.0])
    assert len(buf) == 7
    buf.clear()
    assert len(buf) == 0


def test_factory_and_vocab(tokenizers, jsonl):
    port_tok, hf_tok = tokenizers
    config = DatasetFactory.get_default_config(dict(
        type="json", text_processor=dict(fields="text"), json_dataset=dict(path=jsonl)))
    ds = DatasetFactory.load_dataset(config, port_tok, node_info=NODE_INFO)
    assert ds.vocab_size == len(hf_tok) == 457
    assert len(Tokenizer(str(REPO / "tests/fixtures/tokenizer_bpe"))) == len(
        AutoTokenizer.from_pretrained(str(REPO / "tests/fixtures/tokenizer_bpe")))
    for kind in ("huggingface", "json_vision"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            DatasetFactory.load_dataset(dict(type=kind), port_tok, node_info=NODE_INFO)
    with pytest.raises(ValueError):
        DatasetFactory.load_dataset(dict(type="nope"), port_tok, node_info=NODE_INFO)
    with pytest.raises(KeyError):
        DatasetFactory.get_default_config(dict(json_dataset=dict(bogus=1)))
