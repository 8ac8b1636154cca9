"""The port's tokenizer (`eetq_tpu_torch/serve/tokenizer.py`) against the
JAX package's on the fixture specs of `tests/test_tokenizer.py` (built here
as there): byte-level BPE with an added token, SentencePiece-style BPE with
byte fallback, a Split pre-tokenizer with Unicode property escapes and a
regex Replace decoder; encode and decode (special tokens skipped and kept)
equal on texts that avoid the JAX package's two known faults, then the
port's behaviour where those faults show (`ADVICE.md` r5): `_` survives the
byte-level round trip, and a merge sweep leaves an unranked split of the
merged string alone. Exact equality throughout: the tokenizer is integer
and string logic."""

import json
import os
import tempfile

import pytest

from eetq_tpu.serve.tokenizer import Tokenizer as JaxTokenizer
from eetq_tpu_torch.serve.tokenizer import Tokenizer, _bytes_to_unicode, _merge_pair, _split


def _bytelevel_spec():
    """gpt2-style byte-level BPE: the 256 byte symbols and merges for
    'hello' and ' wor' ('Ġ' is the byte-level space), one special token."""
    b2u = _bytes_to_unicode()
    vocab = {c: i for i, c in enumerate(b2u[b] for b in range(256))}
    for tok in ["he", "ll", "hell", "hello", "Ġw", "Ġwo", "Ġwor"]:
        vocab[tok] = len(vocab)
    merges = ["h e", "l l", "he ll", "hell o", "Ġ w", "Ġw o", "Ġwo r"]
    vocab["<|end|>"] = len(vocab)
    return {
        "model": {"type": "BPE", "vocab": vocab, "merges": merges},
        "added_tokens": [{"id": vocab["<|end|>"], "content": "<|end|>", "special": True}],
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False},
        "decoder": {"type": "ByteLevel"},
    }


def _sentencepiece_spec():
    """llama-style BPE: Prepend/Replace normalizer, byte-fallback vocab,
    Sequence decoder (Replace ▁ -> space, ByteFallback, Fuse, Strip)."""
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    for tok in ["▁", "h", "e", "l", "o", "w", "r", "d", "he", "ll", "hell", "hello", "▁hello",
                "wo", "wor", "worl", "world", "▁world", "▁w"]:
        vocab.setdefault(tok, len(vocab))
    merges = ["h e", "l l", "he ll", "hell o", "▁ hello", "w o", "wo r", "wor l", "worl d",
              "▁ world", "▁ w"]
    return {
        "model": {"type": "BPE", "vocab": vocab, "merges": merges, "byte_fallback": True,
                  "unk_token": "<unk>"},
        "added_tokens": [{"id": 1, "content": "<s>", "special": True},
                         {"id": 2, "content": "</s>", "special": True}],
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"},
            {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]},
        "pre_tokenizer": None,
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
    }


def _split_spec():
    """The qwen2 layout: a Split pre-tokenizer on a Rust-regex pattern with
    Unicode property escapes, then ByteLevel without its own regex."""
    spec = _bytelevel_spec()
    spec["pre_tokenizer"] = {"type": "Sequence", "pretokenizers": [
        {"type": "Split", "pattern": {"Regex": r" ?\p{L}+| ?\p{N}+|[^\s\p{L}\p{N}]+|\s+"},
         "behavior": "Isolated", "invert": False},
        {"type": "ByteLevel", "add_prefix_space": False, "use_regex": False}]}
    return spec


def _regex_decoder_spec():
    spec = _sentencepiece_spec()
    spec["decoder"]["decoders"][0] = {"type": "Replace", "pattern": {"Regex": "▁+"},
                                      "content": " "}
    return spec


SPECS = {"bytelevel": _bytelevel_spec, "sentencepiece": _sentencepiece_spec,
         "split": _split_spec, "regex_decoder": _regex_decoder_spec}
TEXTS = ["hello world", "héllo ☃", "hello<|end|>hello", "<s>hello</s>", "hello  world\nnew",
         "it's 42 worlds! (x+y) ", "  wor hell", ""]


@pytest.mark.parametrize("text", TEXTS)
@pytest.mark.parametrize("spec", SPECS)
def test_encode_decode_match_jax(spec, text):
    ours, theirs = Tokenizer(SPECS[spec]()), JaxTokenizer(SPECS[spec]())
    ids = ours.encode(text)
    assert ids == theirs.encode(text)
    for skip in (True, False):
        assert ours.decode(ids, skip_special_tokens=skip) == theirs.decode(
            ids, skip_special_tokens=skip)
    assert ours.vocab_size == theirs.vocab_size
    assert ours.token_to_id("hello") == theirs.token_to_id("hello")


def test_known_outputs():
    """The JAX test's own expectations, on the port."""
    tok = Tokenizer(_bytelevel_spec())
    ids = tok.encode("hello world")
    assert tok.id_to_token[ids[0]] == "hello" and tok.decode(ids) == "hello world"
    ids = tok.encode("hello<|end|>hello")
    assert ids.count(tok.vocab["<|end|>"]) == 1 and tok.decode(ids) == "hellohello"
    assert tok.decode(ids, skip_special_tokens=False) == "hello<|end|>hello"
    tok = Tokenizer(_sentencepiece_spec())
    assert [tok.id_to_token[i] for i in tok.encode("hello world")] == ["▁hello", "▁world"]
    ids = tok.encode("héllo")
    assert tok.decode(ids) == "héllo" and any(tok.id_to_token[i].startswith("<0x") for i in ids)
    ids = tok.encode("<s>hello</s>")
    assert ids[0] == 1 and ids[-1] == 2 and tok.decode(ids) == "hello"


def test_from_dir_and_from_file():
    spec = _sentencepiece_spec()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "tokenizer.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(spec, f)
        for tok in (Tokenizer.from_dir(d), Tokenizer.from_file(path)):
            assert tok.encode("hello world") == Tokenizer(spec).encode("hello world")


def test_split_merged_with_previous():
    import re

    rx = re.compile("-")
    assert _split(rx, "the-final--countdown", "MergedWithPrevious", False) == [
        "the-", "final-", "-", "countdown"]
    assert _split(rx, "-abc", "MergedWithPrevious", False) == ["-", "abc"]


def test_unsupported_model_raises():
    with pytest.raises(ValueError, match="only BPE"):
        Tokenizer({"model": {"type": "Unigram"}})


# ---- where the JAX package's tokenizer is faulty ----

@pytest.mark.parametrize("text", ["a_b snake_case __init__", "x_1 _ __", "my_var!_y"])
def test_underscore_survives_bytelevel(text):
    """The GPT-2 pre-tokenizer keeps `_` (in the punctuation run), so the
    byte-level round trip is exact; the JAX package's pattern drops it."""
    tok = Tokenizer(_bytelevel_spec())
    assert tok.decode(tok.encode(text)) == text
    theirs = JaxTokenizer(_bytelevel_spec())
    assert theirs.decode(theirs.encode(text)) != text


def test_merge_sweep_merges_the_ranked_pair_only():
    """A sweep merges every occurrence of the ranked pair ('ab', 'c') and
    leaves the unranked ('a', 'bc') beside it alone, although both spell
    'abc' (the JAX package's sweep merges both). The state is held
    directly: greedy merging from single characters never holds both
    splits of one string in a word."""
    assert _merge_pair(["ab", "c", "a", "bc", "ab", "c"], "ab", "c") == [
        "abc", "a", "bc", "abc"]
    assert _merge_pair(["a", "a", "a"], "a", "a") == ["aa", "a"]
