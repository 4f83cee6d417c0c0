"""A reader of Hugging Face `tokenizer.json` directories, with no dependency.

The JAX CLI reads its tokenizer through `transformers.AutoTokenizer`
(`lwm_tpu/apps/serve.py:101-103`); the GPU machine has neither
`transformers` nor `tokenizers`, so the port's CLI reads the files itself:
`tokenizer.json`, plus `tokenizer_config.json` / `special_tokens_map.json`
for the bos and eos tokens, from a local directory. `encode`,
`decode(ids, skip_special_tokens=...)`, `bos_token_id` and `eos_token_id`
give what `AutoTokenizer` gives for two layouts:

- byte-level BPE (GPT-2's): a `ByteLevel` pre-tokenizer, optionally after a
  `Digits` one, and a `ByteLevel` decoder (the vendored fixtures
  `tests/fixtures/tokenizer` and `tokenizer_bpe`);
- the LLaMA layout that `LlamaTokenizerFast` saves (the LWM tokenizers): a
  BPE with `byte_fallback`, a `Prepend("▁")` + `Replace(" ", "▁")`
  normalizer, no pre-tokenizer, a `Replace` / `ByteFallback` / `Fuse` /
  `Strip` decoder and a `TemplateProcessing` post-processor adding `<s>`.

Any other component raises, naming it. Ids outside the vocabulary decode
to nothing, as `tokenizers` does. GPT-2's split pattern uses `\\p{L}` and
`\\p{N}`, which Python's `re` lacks: the classes are built from
`unicodedata` at first use. A hub name is refused: nothing is downloaded.
"""

from __future__ import annotations

import functools
import heapq
import itertools
import json
import os
import re
import sys
import unicodedata

# Unicode White_Space, the set `\s` matches in the Rust regex engines
_WHITESPACE = "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"


@functools.cache
def _category_class(prefix):
    """A regex character class body of every code point whose Unicode
    general category starts with `prefix` ("L" letters, "N" numbers)."""
    ranges, start = [], None
    for cp in range(sys.maxunicode + 2):
        inside = cp <= sys.maxunicode and unicodedata.category(chr(cp)).startswith(prefix)
        if inside and start is None:
            start = cp
        elif not inside and start is not None:
            ranges.append((start, cp - 1))
            start = None
    return "".join(re.escape(chr(a)) if a == b else f"{re.escape(chr(a))}-{re.escape(chr(b))}"
                   for a, b in ranges)


@functools.cache
def _gpt2_split():
    """GPT-2's pre-tokenizer pattern (tokenizers' ByteLevel `use_regex`):
    's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+"""
    L, N, S = _category_class("L"), _category_class("N"), _WHITESPACE
    return re.compile(
        rf"'s|'t|'re|'ve|'m|'ll|'d| ?[{L}]+| ?[{N}]+| ?[^{S}{L}{N}]+|[{S}]+(?![^{S}])|[{S}]+")


@functools.cache
def _bytes_to_unicode():
    """GPT-2's reversible byte → printable character map."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


def _is_numeric(c):
    return unicodedata.category(c) in ("Nd", "Nl", "No")   # Rust's char::is_numeric


# ----------------------------------------------------------------- normalizers

def _normalizer(spec):
    """A str → str function for the normalizer spec (or None)."""
    if spec is None:
        return lambda s: s
    kind = spec["type"]
    if kind == "Sequence":
        steps = [_normalizer(s) for s in spec["normalizers"]]
        return functools.reduce(lambda f, g: (lambda s: g(f(s))), steps, lambda s: s)
    if kind == "Prepend":
        return lambda s: spec["prepend"] + s if s else s
    if kind == "Replace":
        pattern, content = _replace_pattern(spec), spec["content"]
        return lambda s: pattern.sub(lambda _: content, s)
    raise NotImplementedError(f"tokenizer normalizer {kind!r} is not supported")


def _replace_pattern(spec):
    pat = spec["pattern"]
    if "String" in pat:
        return re.compile(re.escape(pat["String"]))
    raise NotImplementedError(f"tokenizer Replace pattern {pat} is not supported")


# -------------------------------------------------------------- pre-tokenizers

def _pre_tokenizer(spec):
    """A list-of-pieces → list-of-pieces function for the spec (or None)."""
    if spec is None:
        return lambda pieces: pieces
    kind = spec["type"]
    if kind == "Sequence":
        steps = [_pre_tokenizer(s) for s in spec["pretokenizers"]]
        return functools.reduce(lambda f, g: (lambda p: g(f(p))), steps, lambda p: p)
    if kind == "Digits":
        individual = spec.get("individual_digits", False)

        def digits(pieces):
            out = []
            for piece in pieces:
                for numeric, run in itertools.groupby(piece, _is_numeric):
                    run = "".join(run)
                    out += list(run) if numeric and individual else [run]
            return out
        return digits
    if kind == "ByteLevel":
        if not spec.get("use_regex", True):
            raise NotImplementedError("tokenizer ByteLevel pre-tokenizer without use_regex")
        prefix = spec.get("add_prefix_space", False)
        table = _bytes_to_unicode()

        def byte_level(pieces):
            out = []
            for piece in pieces:
                if prefix and not piece.startswith(" "):
                    piece = " " + piece
                for m in _gpt2_split().finditer(piece):
                    out.append("".join(table[b] for b in m.group().encode("utf-8")))
            return out
        return byte_level
    raise NotImplementedError(f"tokenizer pre-tokenizer {kind!r} is not supported")


# --------------------------------------------------------------------- model

class _BPE:
    """tokenizers' BPE model: characters (bytes through `byte_fallback`, or
    the unk token) merged pair by pair, the lowest merge rank first, the
    leftmost of equal ranks first."""

    def __init__(self, spec):
        for key in ("continuing_subword_prefix", "end_of_word_suffix", "dropout"):
            if spec.get(key):
                raise NotImplementedError(f"tokenizer BPE {key}={spec[key]!r} is not supported")
        self.vocab = spec["vocab"]
        self.unk = spec.get("unk_token")
        self.fuse_unk = spec.get("fuse_unk", False)
        self.byte_fallback = spec.get("byte_fallback", False)
        self.ignore_merges = spec.get("ignore_merges", False)
        self.merges = {}
        for rank, m in enumerate(spec["merges"]):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b])

    def tokenize(self, word):
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        ids, unk = [], None   # unk: (pending unk run) as in merge_word
        for c in word:
            if c in self.vocab:
                if unk is not None:
                    ids.append(unk)
                    unk = None
                ids.append(self.vocab[c])
                continue
            if self.byte_fallback:
                codes = [f"<0x{b:02X}>" for b in c.encode("utf-8")]
                if all(t in self.vocab for t in codes):
                    ids += [self.vocab[t] for t in codes]
                    continue
            if self.unk is not None:
                if unk is not None and not self.fuse_unk:
                    ids.append(unk)
                unk = self.vocab[self.unk]
        if unk is not None:
            ids.append(unk)
        return self._merge(ids)

    def _merge(self, ids):
        n = len(ids)
        nxt, prev, alive = list(range(1, n + 1)), list(range(-1, n - 1)), [True] * n
        heap = []
        for i in range(n - 1):
            m = self.merges.get((ids[i], ids[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _, i, new = heapq.heappop(heap)
            j = nxt[i]
            if not alive[i] or j >= n:
                continue
            m = self.merges.get((ids[i], ids[j]))
            if m is None or m[1] != new:     # an expired entry
                continue
            ids[i], alive[j] = new, False
            nxt[i] = nxt[j]
            if nxt[j] < n:
                prev[nxt[j]] = i
            if prev[i] >= 0:
                m = self.merges.get((ids[prev[i]], new))
                if m is not None:
                    heapq.heappush(heap, (m[0], prev[i], m[1]))
            if nxt[i] < n:
                m = self.merges.get((new, ids[nxt[i]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], i, m[1]))
        return [t for t, a in zip(ids, alive) if a]


# ------------------------------------------------------------------- decoders

def _decoder(spec):
    """A tokens → tokens function (tokenizers' `decode_chain`)."""
    if spec is None:
        return lambda toks: [" ".join(toks)]
    kind = spec["type"]
    if kind == "Sequence":
        steps = [_decoder(s) for s in spec["decoders"]]
        return functools.reduce(lambda f, g: (lambda t: g(f(t))), steps, lambda t: t)
    if kind == "ByteLevel":
        table = {c: b for b, c in _bytes_to_unicode().items()}

        def byte_level(toks):
            out = bytearray()
            for t in toks:
                bs = [table.get(c) for c in t]
                out += t.encode("utf-8") if None in bs else bytes(bs)
            return [out.decode("utf-8", errors="replace")]
        return byte_level
    if kind == "Replace":
        pattern, content = _replace_pattern(spec), spec["content"]
        return lambda toks: [pattern.sub(lambda _: content, t) for t in toks]
    if kind == "ByteFallback":
        def byte_fallback(toks):
            out, pending = [], bytearray()

            def flush():
                if pending:
                    try:
                        out.append(pending.decode("utf-8"))
                    except UnicodeDecodeError:
                        out.extend("�" * len(pending))
                    pending.clear()

            for t in toks:
                if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
                    try:
                        pending.append(int(t[3:5], 16))
                        continue
                    except ValueError:
                        pass
                flush()
                out.append(t)
            flush()
            return out
        return byte_fallback
    if kind == "Fuse":
        return lambda toks: ["".join(toks)]
    if kind == "Strip":
        content, start, stop = spec["content"], spec["start"], spec["stop"]

        def strip(toks):
            out = []
            for t in toks:
                a = 0
                while a < min(start, len(t)) and t[a] == content:
                    a += 1
                b = len(t)
                while len(t) - b < stop and b > a and t[b - 1] == content:
                    b -= 1
                out.append(t[a:b])
            return out
        return strip
    raise NotImplementedError(f"tokenizer decoder {kind!r} is not supported")


def _post_processor(spec):
    """ids → ids with the single-sequence template's special tokens."""
    if spec is None:
        return lambda ids: ids
    kind = spec["type"]
    if kind == "TemplateProcessing":
        single = spec["single"]

        def template(ids):
            out = []
            for piece in single:
                if "Sequence" in piece:
                    out += ids
                else:
                    name = piece["SpecialToken"]["id"]
                    out += spec["special_tokens"][name]["ids"]
            return out
        return template
    raise NotImplementedError(f"tokenizer post-processor {kind!r} is not supported")


def _clean_up(text):
    """transformers' `clean_up_tokenization`."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                 (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
        text = text.replace(a, b)
    return text


class Tokenizer:
    """`AutoTokenizer.from_pretrained(path)` for a local directory of one of
    the two layouts in the module note."""

    def __init__(self, path):
        if not os.path.isdir(path):
            raise ValueError(
                f"tokenizer {path!r} is not a local directory: the port reads tokenizer.json "
                "(and tokenizer_config.json) from a local directory and downloads nothing; "
                "save the tokenizer with save_pretrained and pass that directory"
            )
        with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
            spec = json.load(f)
        config = {}
        for name in ("special_tokens_map.json", "tokenizer_config.json"):
            full = os.path.join(path, name)
            if os.path.exists(full):
                with open(full, encoding="utf-8") as f:
                    config.update(json.load(f))
        if spec["model"].get("type", "BPE") != "BPE":
            raise NotImplementedError(f"tokenizer model {spec['model']['type']!r} is not supported")
        self.model = _BPE(spec["model"])
        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.decode_chain = _decoder(spec.get("decoder"))
        self.post_process = _post_processor(spec.get("post_processor"))
        self.clean_up = bool(config.get("clean_up_tokenization_spaces", False))
        self.added = {}        # content → (id, special, normalized)
        for t in spec.get("added_tokens", []):
            for flag in ("single_word", "lstrip", "rstrip"):
                if t.get(flag):
                    raise NotImplementedError(f"added token {t['content']!r} with {flag}")
            self.added[t["content"]] = (t["id"], t["special"], t.get("normalized", False))
        self.id_to_token = {i: tok for tok, i in self.model.vocab.items()}
        self.id_to_token.update({v[0]: k for k, v in self.added.items()})
        self.special_ids = {v[0] for v in self.added.values() if v[1]}
        self._raw_split = self._splitter(normalized=False)
        self._norm_split = self._splitter(normalized=True)

        def token_of(key):
            tok = config.get(key)
            if isinstance(tok, dict):
                tok = tok.get("content")
            return None if tok is None else self.token_to_id(tok)

        self.bos_token_id = token_of("bos_token")
        self.eos_token_id = token_of("eos_token")

    def token_to_id(self, token):
        if token in self.added:
            return self.added[token][0]
        return self.model.vocab.get(token)

    def _splitter(self, normalized):
        toks = sorted((t for t, v in self.added.items() if v[2] == normalized), key=len,
                      reverse=True)
        return re.compile("|".join(re.escape(t) for t in toks)) if toks else None

    def _split_added(self, text, pattern):
        """[(piece, added-token id or None)], the added tokens matched
        leftmost-longest."""
        if pattern is None:
            return [(text, None)]
        out, pos = [], 0
        for m in pattern.finditer(text):
            if m.start() > pos:
                out.append((text[pos:m.start()], None))
            out.append((None, self.added[m.group()][0]))
            pos = m.end()
        if pos < len(text):
            out.append((text[pos:], None))
        return out

    def encode(self, text, add_special_tokens=True):
        ids = []
        for piece, tid in self._split_added(text, self._raw_split):
            if tid is not None:
                ids.append(tid)
                continue
            for sub, sid in self._split_added(self.normalize(piece), self._norm_split):
                if sid is not None:
                    ids.append(sid)
                    continue
                for word in self.pre_tokenize([sub]):
                    if word:
                        ids += self.model.tokenize(word)
        return self.post_process(ids) if add_special_tokens else ids

    def decode(self, ids, skip_special_tokens=False):
        toks = []
        for i in ids:
            i = int(i)
            tok = self.id_to_token.get(i)
            if tok is None or (skip_special_tokens and i in self.special_ids):
                continue
            toks.append(tok)
        text = "".join(self.decode_chain(toks))
        return _clean_up(text) if self.clean_up else text
