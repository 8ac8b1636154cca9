"""Dependency-free `tokenizer.json` (HF tokenizers BPE) encode/decode.

Port of `eetq_tpu/serve/tokenizer.py` by copy (importing it would import
JAX), without two of its faults: its GPT-2 pre-tokenizer pattern drops
`_`, and its merge sweep also merges an unranked pair of neighbours whose
concatenation equals the ranked merge. Here `_` joins the punctuation run,
as in the real pattern, and a sweep merges only the ranked pair itself, as
HF tokenizers do.

It gives `serve.api.EngineServer` text in and text out without any
dependency (no `tokenizers` wheel, nothing downloaded): a pure-Python
reader for the `tokenizer.json` format covering the two families every
supported model uses —

* **byte-level BPE** (gpt2/qwen2/mixtral style): ByteLevel pre-tokenizer +
  decoder, optional regex Split pre-tokenizer;
* **SentencePiece-style BPE** (llama/mistral/gemma style): Prepend/Replace
  normalizers, Metaspace ("▁") handling, byte-fallback (<0xXX> tokens),
  Fuse/Strip decoders.

Scope: BPE models only (every llama-family tokenizer.json is BPE);
Unigram/WordPiece raise. Encode applies added/special tokens first (they
bypass BPE, matching the `tokenizers` split behavior), then normalizes,
pre-tokenizes, and greedily merges by rank.
"""

from __future__ import annotations

import functools
import json
import os
import re


# ---------------------------------------------------------------------------
# GPT-2 byte-level alphabet: every byte maps to a printable unicode char.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _bytes_to_unicode() -> dict[int, str]:
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(0xA1, 0xAD))
        + list(range(0xAE, 0x100))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@functools.lru_cache(maxsize=1)
def _unicode_to_bytes() -> dict[str, int]:
    return {c: b for b, c in _bytes_to_unicode().items()}


class Tokenizer:
    """Minimal HF-`tokenizer.json` BPE tokenizer (see module docstring)."""

    def __init__(self, spec: dict):
        model = spec.get("model") or {}
        if model.get("type") not in ("BPE", None):
            raise ValueError(
                f"only BPE tokenizer.json models are supported, got "
                f"{model.get('type')!r}"
            )
        self.vocab: dict[str, int] = dict(model.get("vocab") or {})
        merges = model.get("merges") or []
        # merges are "a b" strings (old format) or [a, b] pairs (new)
        self.ranks: dict[tuple[str, str], int] = {}
        for i, m in enumerate(merges):
            pair = tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
            self.ranks[pair] = i
        self.byte_fallback = bool(model.get("byte_fallback"))
        self.unk_token = model.get("unk_token")
        self.fuse_unk = bool(model.get("fuse_unk"))

        self.added: dict[str, int] = {}
        self.special_ids: set[int] = set()
        for t in spec.get("added_tokens") or []:
            self.added[t["content"]] = t["id"]
            self.vocab.setdefault(t["content"], t["id"])
            if t.get("special"):
                self.special_ids.add(t["id"])
        self.id_to_token: dict[int, str] = {}
        for tok, i in self.vocab.items():
            self.id_to_token.setdefault(i, tok)

        self.normalizers = _flatten(spec.get("normalizer"))
        self.pre_tokenizers = _flatten(spec.get("pre_tokenizer"))
        self.decoders = _flatten(spec.get("decoder"))
        self._byte_level = any(
            n.get("type") == "ByteLevel"
            for n in self.pre_tokenizers + self.decoders
        )
        # split pattern matching any added token, longest first (so
        # "<|endoftext|>" wins over a hypothetical "<|end")
        if self.added:
            alts = sorted(self.added, key=len, reverse=True)
            self._added_re = re.compile(
                "(" + "|".join(re.escape(a) for a in alts) + ")"
            )
        else:
            self._added_re = None

    # ---- construction ----

    @classmethod
    def from_file(cls, path: str) -> "Tokenizer":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))

    @classmethod
    def from_dir(cls, path: str) -> "Tokenizer":
        return cls.from_file(os.path.join(path, "tokenizer.json"))

    @property
    def vocab_size(self) -> int:
        return max(self.id_to_token) + 1 if self.id_to_token else 0

    def token_to_id(self, token: str) -> int | None:
        return self.vocab.get(token)

    # ---- encode ----

    def encode(self, text: str) -> list[int]:
        """Text -> token ids. Added/special tokens are matched verbatim
        first and bypass normalization + BPE (the `tokenizers` added-token
        split), everything between goes through the BPE pipeline."""
        ids: list[int] = []
        pieces = (
            self._added_re.split(text) if self._added_re is not None else [text]
        )
        for piece in pieces:
            if not piece:
                continue
            if piece in self.added:
                ids.append(self.added[piece])
                continue
            ids.extend(self._encode_span(piece))
        return ids

    def _encode_span(self, text: str) -> list[int]:
        text = self._normalize(text)
        out: list[int] = []
        for word in self._pre_tokenize(text):
            out.extend(self._bpe_word(word))
        return out

    def _normalize(self, text: str) -> str:
        for n in self.normalizers:
            t = n.get("type")
            if t == "Replace":
                text = _replace(text, _pattern(n["pattern"]), n["content"])
            elif t == "Prepend":
                if text and not text.startswith(n["prepend"]):
                    text = n["prepend"] + text
            elif t in ("NFC", "NFKC", "NFD", "NFKD"):
                import unicodedata

                text = unicodedata.normalize(t, text)
            elif t == "Lowercase":
                text = text.lower()
            elif t == "Strip":
                if n.get("strip_left", True):
                    text = text.lstrip()
                if n.get("strip_right", True):
                    text = text.rstrip()
            # unknown normalizers: no-op (best effort)
        return text

    def _pre_tokenize(self, text: str) -> list[str]:
        """Split the normalized text into BPE 'words' (merges never cross a
        word boundary) and map each into the model's symbol alphabet."""
        words = [text]
        byte_level = False
        for p in self.pre_tokenizers:
            t = p.get("type")
            if t == "ByteLevel":
                byte_level = True
                if p.get("add_prefix_space") and words and words[0] and not words[0][0].isspace():
                    words[0] = " " + words[0]
                if p.get("use_regex", True):
                    words = [m for w in words for m in _GPT2_RE.findall(w)]
            elif t == "Split":
                pat = _pattern(p["pattern"], allow_regex=True)
                # String patterns are literals; anything else is a compiled
                # pattern (possibly from the `regex` module, which is NOT an
                # re.Pattern instance)
                rx = re.compile(re.escape(pat)) if isinstance(pat, str) else pat
                behavior = p.get("behavior", "Removed")
                nxt = []
                for w in words:
                    nxt.extend(_split(rx, w, behavior, p.get("invert", False)))
                words = nxt
            elif t == "Whitespace":
                words = [m for w in words for m in re.findall(r"\w+|[^\w\s]+", w)]
            elif t == "WhitespaceSplit":
                words = [m for w in words for m in w.split()]
            elif t == "Metaspace":
                rep = p.get("replacement", "▁")
                prepend = p.get(
                    "prepend_scheme",
                    "always" if p.get("add_prefix_space", True) else "never",
                ) != "never"
                nxt = []
                for w in words:
                    w = w.replace(" ", rep)
                    if prepend and not w.startswith(rep):
                        w = rep + w
                    # split so each piece starts at a ▁ boundary (merges
                    # never cross word starts, like `tokenizers` Metaspace)
                    nxt.extend(
                        x for x in re.split(f"(?={re.escape(rep)})", w) if x
                    )
                words = nxt
            # unknown pre-tokenizers: no-op
        if byte_level:
            b2u = _bytes_to_unicode()
            words = ["".join(b2u[b] for b in w.encode("utf-8")) for w in words]
        return [w for w in words if w]

    def _bpe_word(self, word: str) -> list[int]:
        """Greedy rank-ordered BPE over one word, then symbol->id with
        byte-fallback/unk handling."""
        if word in self.vocab:  # fast path (also catches added tokens)
            return [self.vocab[word]]
        symbols = list(word)
        while len(symbols) > 1:
            best_rank, best_i = None, -1
            for i in range(len(symbols) - 1):
                r = self.ranks.get((symbols[i], symbols[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            symbols = _merge_pair(symbols, symbols[best_i], symbols[best_i + 1])
        ids: list[int] = []
        for s in symbols:
            if s in self.vocab:
                ids.append(self.vocab[s])
            elif self.byte_fallback:
                for b in s.encode("utf-8"):
                    tok = f"<0x{b:02X}>"
                    if tok in self.vocab:
                        ids.append(self.vocab[tok])
            elif self.unk_token is not None and self.unk_token in self.vocab:
                if not (
                    self.fuse_unk
                    and ids
                    and ids[-1] == self.vocab[self.unk_token]
                ):
                    ids.append(self.vocab[self.unk_token])
        return ids

    # ---- decode ----

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        toks = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in self.special_ids:
                continue
            toks.append(self.id_to_token.get(i, ""))
        return self._decode_tokens(toks)

    def _decode_tokens(self, toks: list[str]) -> str:
        if self._byte_level:
            u2b = _unicode_to_bytes()
            data = bytearray()
            for t in toks:
                for ch in t:
                    if ch in u2b:
                        data.append(u2b[ch])
                    else:  # added tokens aren't byte-level encoded
                        data.extend(ch.encode("utf-8"))
            return data.decode("utf-8", errors="replace")
        # SentencePiece-style decoder chain
        decoders = self.decoders or [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"},
            {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0},
        ]
        for d in decoders:
            t = d.get("type")
            if t == "Replace":
                pat = _pattern(d["pattern"])
                toks = [_replace(x, pat, d["content"]) for x in toks]
            elif t == "ByteFallback":
                out, buf = [], bytearray()
                for x in toks:
                    m = re.fullmatch(r"<0x([0-9A-Fa-f]{2})>", x)
                    if m:
                        buf.append(int(m.group(1), 16))
                        continue
                    if buf:
                        out.append(buf.decode("utf-8", errors="replace"))
                        buf = bytearray()
                    out.append(x)
                if buf:
                    out.append(buf.decode("utf-8", errors="replace"))
                toks = out
            elif t == "Fuse":
                toks = ["".join(toks)]
            elif t == "Strip":
                c = d.get("content", " ")
                if toks and d.get("start"):
                    toks[0] = toks[0][_strip_n(toks[0], c, d["start"]):]
                if toks and d.get("stop"):
                    n = _strip_n(toks[-1][::-1], c, d["stop"])
                    toks[-1] = toks[-1][: len(toks[-1]) - n]
            elif t == "Metaspace":
                rep = d.get("replacement", "▁")
                toks = [x.replace(rep, " ") for x in toks]
                if toks and toks[0].startswith(" ") and d.get(
                    "add_prefix_space", True
                ):
                    toks[0] = toks[0][1:]
            # unknown decoders: no-op
        return "".join(toks)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

# the GPT-2 pre-tokenization regex in python `re`: \p{L} as [^\W\d_] and
# \p{N} as \d; `_`, the one character of \w that is neither, joins the run
# of [^\s\p{L}\p{N}], as in the real pattern
_GPT2_RE = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?(?:[^\s\w]|_)+|\s+(?!\S)|\s+"
)


def _merge_pair(symbols: list[str], first: str, second: str) -> list[str]:
    """`symbols` with EVERY occurrence of the pair (first, second) merged,
    left to right (gpt2 reference behavior), and no other pair of neighbours
    whose concatenation is the same string."""
    out, i = [], 0
    while i < len(symbols):
        if i < len(symbols) - 1 and symbols[i] == first and symbols[i + 1] == second:
            out.append(first + second)
            i += 2
        else:
            out.append(symbols[i])
            i += 1
    return out


def _strip_n(s: str, ch: str, at_most: int) -> int:
    """Count up to `at_most` leading occurrences of `ch` in `s`."""
    n = 0
    while n < at_most and s[n : n + 1] == ch:
        n += 1
    return n


def _flatten(component) -> list[dict]:
    """normalizer/pre_tokenizer/decoder -> flat list of step dicts."""
    if not component:
        return []
    if component.get("type") == "Sequence":
        steps = []
        for key in ("normalizers", "pretokenizers", "decoders"):
            for s in component.get(key) or []:
                steps.extend(_flatten(s))
        return steps
    return [component]


def _compile(src: str):
    """Compile a tokenizer.json Regex. Real tokenizer files (gpt2/qwen2
    Split pre-tokenizers) use Rust-regex syntax — notably Unicode property
    escapes (\\p{L}, \\p{N}) that Python's `re` rejects with 'bad escape
    \\p' — so those route through the `regex` module."""
    if re.search(r"\\[pP]\{", src):
        try:
            import regex
        except ImportError as e:  # pragma: no cover
            raise NotImplementedError(
                f"tokenizer pattern {src[:60]!r} uses Unicode property "
                "escapes; the 'regex' package is required for it"
            ) from e
        return regex.compile(src)
    return re.compile(src)


def _pattern(p, allow_regex: bool = False):
    """Resolve a tokenizers pattern node. Returns a str for String
    patterns; for Regex patterns returns a compiled pattern (callers must
    branch on the type — a regex source applied as a literal would
    silently match nothing)."""
    if isinstance(p, dict):
        if "String" in p:
            return p["String"]
        if "Regex" in p:
            return _compile(p["Regex"])
    return p


def _replace(text: str, pattern, content: str) -> str:
    """tokenizers `Replace`: literal for String patterns, re.sub for Regex
    (content is literal replacement text, never group references)."""
    if isinstance(pattern, str):
        return text.replace(pattern, content)
    return pattern.sub(lambda _m: content, text)


def _split(rx: re.Pattern, text: str, behavior: str, invert: bool) -> list[str]:
    """`tokenizers` Split behaviors over regex matches."""
    if invert:  # keep the matches themselves as the pieces
        return rx.findall(text)
    pieces, last = [], 0
    for m in rx.finditer(text):
        gap = text[last : m.start()]
        if behavior == "MergedWithPrevious":
            # each match fuses with ITS preceding segment (possibly empty:
            # a leading or consecutive delimiter forms its own piece — the
            # tokenizers crate's "the-final--countdown" ->
            # ["the-", "final-", "-", "countdown"] semantics; merging into
            # pieces[-1] instead would both drop a leading match and fuse
            # consecutive delimiters)
            pieces.append(gap + m.group())
            last = m.end()
            continue
        if gap:
            pieces.append(gap)
        if behavior == "Isolated":
            pieces.append(m.group())
        elif behavior == "MergedWithNext":
            pieces.append(m.group())  # will fuse with the next piece below
        last = m.end()
    if last < len(text):
        if behavior == "MergedWithNext" and pieces and rx.fullmatch(pieces[-1]):
            pieces[-1] += text[last:]
        else:
            pieces.append(text[last:])
    return [p for p in pieces if p]
