"""The port's vision-text data pipeline (lwm_tpu_torch.data.vision) against
the JAX package's (`lwm_tpu/data/vision.py`): the processor gives the same
tokens, loss masks and vision masks on every field form, and
`JsonVisionDataset` the same batches byte for byte in `pad` and `no_pad`,
with one tokenizer process and with a pool of two (against the JAX
dataset's serial batches: its pool gives the same), and resumes from
either package's state dict. The metrics that do not read the clock are
held exactly.
"""

import json
from pathlib import Path

import numpy as np
import pytest
from transformers import AutoTokenizer

from lwm_tpu.data.vision import JsonVisionDataset as JaxJsonVisionDataset
from lwm_tpu.data.vision import VisionTextProcessor as JaxVisionTextProcessor
from lwm_tpu_torch.data import DatasetFactory, JsonVisionDataset, VisionTextProcessor
from lwm_tpu_torch.utils.tokenizer import Tokenizer

REPO = Path(__file__).resolve().parent.parent
TOKENIZER = str(REPO / "tests" / "fixtures" / "tokenizer")
NODE_INFO = dict(dp_node_size=1, dp_node_rank=0)
EXACT_METRICS = ("dataset_file_loc", "dataset_example_index", "dataset_total_tokens")
BATCH_KEYS = ("input_tokens", "target_tokens", "loss_masks", "input_vision_masks",
              "target_vision_masks")
WORDS = "the magic number is in haystack needle model world sky blue green".split()
PER_FRAME = 8   # codes a frame in these tests (256 in a real clip; one case runs 256)
SPECS = ["[caption],vision", "vision,caption", "<|bos|>,vision,[question+caption],<|eos|>",
         ["vision,caption", "[question],vision,answer", "[caption],vision"]]


@pytest.fixture(scope="module")
def tokenizers():
    return Tokenizer(TOKENIZER), AutoTokenizer.from_pretrained(TOKENIZER)


def _line(rng, i, per_frame=PER_FRAME):
    def words(lo, hi):
        return " ".join(rng.choice(WORDS, rng.integers(lo, hi)))

    frames = int(rng.integers(1, 7))
    return {"vision": rng.integers(0, 8192, frames * per_frame).tolist(),
            "caption": f"{words(1, 12)} {i}", "question": words(1, 6), "answer": words(1, 6),
            "spec": SPECS[i % len(SPECS)]}


@pytest.fixture(scope="module")
def jsonl(tmp_path_factory):
    """120 clips of 1-6 frames with captions from a seed, their field specs
    cycling through SPECS (a list among them: one pick a line), and one
    blank and one broken line."""
    rng = np.random.default_rng(0)
    path = tmp_path_factory.mktemp("vision") / "data.jsonl"
    with open(path, "w") as f:
        for i in range(120):
            f.write(json.dumps(_line(rng, i)) + "\n")
            if i == 30:
                f.write("\n{broken json\n")
    return str(path)


PROCESSOR_CASES = {
    "default": dict(),
    "fields_index": dict(fields_index=1),
    "max_n_frames": dict(max_n_frames=3),
    "prepend_and_separator": dict(prepend_text="Q: ", subfield_separator=" | "),
    "no_bos_eos": dict(add_bos_token=False, add_eos_token=False),
}


def _processors(tokenizers, per_frame=PER_FRAME, **updates):
    port_tok, hf_tok = tokenizers
    config = dict(fields_from_example="spec", n_tokens_per_frame=per_frame, **updates)
    return (VisionTextProcessor(config, port_tok),
            JaxVisionTextProcessor(JaxVisionTextProcessor.get_default_config(config), hf_tok))


@pytest.mark.parametrize("case", sorted(PROCESSOR_CASES))
def test_processor_matches_jax(tokenizers, case):
    ours, theirs = _processors(tokenizers, **PROCESSOR_CASES[case])
    rng = np.random.default_rng(1)
    for i in range(16):
        example = _line(rng, i)
        got = ours((example, 100 + i, i), has_aux=True)
        assert got == theirs((example, 100 + i, i), has_aux=True), i
        tokens, masks, vision, keep, *_ = got
        assert len(tokens) == len(masks) == len(vision) and keep
        if isinstance(example["spec"], str):   # no aux: the same pick, seed 0
            assert ours(example) == theirs(example)


def test_processor_frames_at_full_size(tokenizers):
    """256-code frames: EOF after each but the last, EOV after it, and the
    vision masks on the codes and their ends only."""
    ours, theirs = _processors(tokenizers, per_frame=256)
    example = _line(np.random.default_rng(2), 0, per_frame=256)
    example["spec"] = "vision,caption"
    tokens, masks, vision, _ = got = ours(example)
    assert got == theirs(example)
    n_frames = len(example["vision"]) // 256
    start = 1 + len(ours.vision_start)   # after the BOS and <vision>
    ends = [start + 256 + 257 * j for j in range(n_frames)]
    assert [tokens[e] for e in ends] == [8192] * (n_frames - 1) + [8193]
    assert sum(vision) == 257 * n_frames and all(vision[start:start + 257 * n_frames])
    with pytest.raises(ValueError, match="fields_from_example"):
        VisionTextProcessor({}, tokenizers[0])


DATASET_CASES = {
    "pad": dict(mode="pad", seq_length=40),
    "no_pad": dict(mode="no_pad"),
    "no_pad_pool": dict(mode="no_pad", tokenizer_processes=2, tokenizer_parallel_batch_size=16,
                        tokenizer_parallel_chunk_size=4),
    "pad_pool": dict(mode="pad", seq_length=40, tokenizer_processes=2,
                     tokenizer_parallel_batch_size=16, tokenizer_parallel_chunk_size=4),
}


def _config(path, **updates):
    return dict(dict(path=path, seq_length=64, batch_size=2, return_local_batch=True), **updates)


def _port_dataset(path, tok, **updates):
    return DatasetFactory.load_dataset(dict(
        type="json_vision", json_vision_dataset=_config(path, **updates),
        vision_text_processor=dict(fields_from_example="spec", n_tokens_per_frame=PER_FRAME),
    ), tok, node_info=NODE_INFO)


def _jax_dataset(path, tok, **updates):
    updates.pop("tokenizer_processes", None)   # the JAX pool gives its serial batches
    proc = JaxVisionTextProcessor(JaxVisionTextProcessor.get_default_config(
        dict(fields_from_example="spec", n_tokens_per_frame=PER_FRAME)), tok)
    config = JaxJsonVisionDataset.get_default_config(_config(path, **updates))
    return JaxJsonVisionDataset(config, tok, proc, node_info=NODE_INFO)


def _take(dataset, n):
    it = iter(dataset)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def assert_same_batches(ours, theirs):
    assert len(ours) == len(theirs)
    for (b, m), (wb, wm) in zip(ours, theirs):
        assert b.keys() == wb.keys() == set(BATCH_KEYS)
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
    n = 65 if updates["mode"] == "pad" else 20   # pad wraps past the file's end
    ours = _take(_port_dataset(jsonl, port_tok, **updates), n)
    assert_same_batches(ours, _take(_jax_dataset(jsonl, hf_tok, **updates), n))
    vision = sum(int(b["target_vision_masks"].sum()) for b, _ in ours)
    text = sum(int((b["loss_masks"] * ~b["target_vision_masks"]).sum()) for b, _ in ours)
    assert vision > 0 and text > 0   # both halves of the dual loss have targets


@pytest.mark.parametrize("mode", ["pad", "no_pad"])
def test_resume_from_state_dicts(tokenizers, jsonl, mode):
    """From a JAX dataset's state the port resumes as the JAX dataset does.
    The port's state names the line after the last one read (the JAX state
    names that last line, ROADMAP C4), so from it both packages resume with
    each example's index one above the JAX resume's, as in an
    uninterrupted run; in `pad` mode the batches are the uninterrupted
    run's too (the random field picks follow the index)."""
    port_tok, hf_tok = tokenizers
    ours, theirs = (_port_dataset(jsonl, port_tok, mode=mode),
                    _jax_dataset(jsonl, hf_tok, mode=mode))
    assert isinstance(ours, JsonVisionDataset)
    _take(ours, 5)
    _take(theirs, 5)
    state, jax_state = ours.get_state_dict(), theirs.get_state_dict()
    assert (state["file_loc"], state["total_tokens"]) == (jax_state["file_loc"],
                                                         jax_state["total_tokens"])
    assert state["index"] == jax_state["index"] + 1
    want = _jax_dataset(jsonl, hf_tok, mode=mode)
    want.load_state_dict(jax_state)
    want = _take(want, 4)
    resumed = _port_dataset(jsonl, port_tok, mode=mode, seq_length=8)   # the state's config wins
    resumed.load_state_dict(jax_state)
    assert resumed.seq_length == 64
    assert_same_batches(_take(resumed, 4), want)
    from_port = [_port_dataset(jsonl, port_tok, mode=mode), _jax_dataset(jsonl, hf_tok, mode=mode)]
    for dataset in from_port:
        dataset.load_state_dict(state)
    got = [_take(d, 4) for d in from_port]
    assert_same_batches(got[0], got[1])
    assert [m["dataset_example_index"] for _, m in got[0]] == [
        m["dataset_example_index"] + 1 for _, m in want]
    if mode == "pad":
        whole = _take(_port_dataset(jsonl, port_tok, mode=mode), 9)[5:]
        assert_same_batches(got[0], whole)
