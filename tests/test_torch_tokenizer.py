"""The port's tokenizer reader (lwm_tpu_torch.utils.tokenizer) against
`transformers.AutoTokenizer` on the same directory: the two vendored
byte-level BPE fixtures, and a LLaMA-layout tokenizer (BPE with byte
fallback, `Prepend`/`Replace` normalizer, `TemplateProcessing` adding <s>)
built here with `tokenizers` and saved by `LlamaTokenizerFast`. Encode and
decode must be identical, on unicode letters and digits, whitespace runs,
special-token strings and out-of-vocabulary ids.
"""

import functools
import json
import os

import pytest
from tokenizers import Tokenizer as HFTokenizer
from tokenizers import models, normalizers, trainers
from transformers import AutoTokenizer, LlamaTokenizerFast

from lwm_tpu_torch.utils.tokenizer import Tokenizer

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")

TEXTS = [
    "The special magic Tokyo number is: 4819203.",
    "Hello world, the 12345 numbers!  And  double  spaces.",
    "   leading spaces, trailing   ",
    "tabs\tand\nnew\n\nlines \n mixed",
    "Ünïcödé café naïve — 東京 ١٢٣ ½ Ⅻ Straße",
    "emoji 😀 and math ∑ x² ≤ 3",
    "special <s> inside </s> text<pad>and<s><s>",
    "it's they're we've I'm you'll he'd don't",
    "",
    "a",
]


@functools.cache
def llama_dir(tmp):
    """A LLaMA-layout tokenizer (the layout LlamaTokenizerFast saves for the
    LWM tokenizers) trained on a small corpus and saved under `tmp`."""
    corpus = [t for t in TEXTS if t] * 3 + [
        "the quick brown fox jumps over the lazy dog " * 3,
        "numbers 0123456789 and letters abcdefghijklmnopqrstuvwxyz",
    ]
    tok = HFTokenizer(models.BPE(unk_token="<unk>", byte_fallback=True, fuse_unk=True))
    tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                           normalizers.Replace(" ", "▁")])
    tok.train_from_iterator(corpus, trainers.BpeTrainer(
        vocab_size=200, special_tokens=["<unk>", "<s>", "</s>"], show_progress=False))
    spec = json.loads(tok.to_str())
    # the LLaMA vocab: the specials, the 256 byte tokens, then the pieces
    pieces = [t for t, _ in sorted(spec["model"]["vocab"].items(), key=lambda kv: kv[1])
              if t not in ("<unk>", "<s>", "</s>")]
    vocab = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)] + pieces
    spec["model"]["vocab"] = {t: i for i, t in enumerate(vocab)}
    spec["added_tokens"] = [dict(id=i, content=t, single_word=False, lstrip=False, rstrip=False,
                                 normalized=False, special=True)
                            for i, t in enumerate(["<unk>", "<s>", "</s>"])]
    spec["decoder"] = {"type": "Sequence", "decoders": [
        {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
        {"type": "ByteFallback"}, {"type": "Fuse"},
        {"type": "Strip", "content": " ", "start": 1, "stop": 0}]}
    backend = HFTokenizer.from_str(json.dumps(spec))
    hf = LlamaTokenizerFast(tokenizer_object=backend, bos_token="<s>", eos_token="</s>",
                            unk_token="<unk>", add_bos_token=True, add_eos_token=False,
                            legacy=True, clean_up_tokenization_spaces=False)
    path = os.path.join(tmp, "llama")
    hf.save_pretrained(path)
    saved = json.load(open(os.path.join(path, "tokenizer.json")))
    assert saved["post_processor"]["type"] == "TemplateProcessing"
    assert saved["model"]["byte_fallback"] and saved["pre_tokenizer"] is None
    return path


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return {"tokenizer": os.path.join(FIXTURES, "tokenizer"),
            "tokenizer_bpe": os.path.join(FIXTURES, "tokenizer_bpe"),
            "llama": llama_dir(str(tmp_path_factory.mktemp("tok")))}


@pytest.mark.parametrize("layout", ["tokenizer", "tokenizer_bpe", "llama"])
def test_encode_decode_match_autotokenizer(dirs, layout):
    want, got = AutoTokenizer.from_pretrained(dirs[layout]), Tokenizer(dirs[layout])
    assert (got.bos_token_id, got.eos_token_id) == (want.bos_token_id, want.eos_token_id)
    n_vocab = len(want)
    for text in TEXTS:
        ids = want.encode(text)
        assert got.encode(text) == ids, text
        oov = ids + [n_vocab, n_vocab + 7, 31999]     # ids a 32000-vocab model may emit
        for skip in (False, True):
            assert got.decode(oov, skip_special_tokens=skip) == \
                want.decode(oov, skip_special_tokens=skip), (text, skip)
    if got.bos_token_id is not None:
        ids = [got.bos_token_id] + want.encode("round trip", add_special_tokens=False)
        assert got.decode(ids, skip_special_tokens=True) == "round trip"


def test_long_text_is_one_word_for_the_llama_layout(dirs):
    """The LLaMA layout has no pre-tokenizer: a whole document is one BPE
    word, merged by a heap (a document of tens of thousands of characters
    encodes in well under a second)."""
    text = " ".join(TEXTS) * 40
    want, got = AutoTokenizer.from_pretrained(dirs["llama"]), Tokenizer(dirs["llama"])
    assert got.encode(text) == want.encode(text)


def test_refuses_hub_names_and_unknown_components(tmp_path, dirs):
    with pytest.raises(ValueError, match="local directory"):
        Tokenizer("LargeWorldModel/LWM-Text-1M")
    spec = json.load(open(os.path.join(dirs["tokenizer_bpe"], "tokenizer.json")))
    spec["normalizer"] = {"type": "NFKC"}
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec))
    with pytest.raises(NotImplementedError, match="normalizer 'NFKC'"):
        Tokenizer(str(tmp_path))
    spec["normalizer"], spec["pre_tokenizer"] = None, {"type": "Whitespace"}
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec))
    with pytest.raises(NotImplementedError, match="pre-tokenizer 'Whitespace'"):
        Tokenizer(str(tmp_path))
