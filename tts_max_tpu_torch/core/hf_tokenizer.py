"""A reader of Hugging Face ``tokenizer.json`` files for byte-level BPE
tokenizers, Llama 3's kind, written with the standard library only (no
``tokenizers``, ``transformers`` or ``regex``).

``HFTokenizer`` gives the ids ``transformers.AutoTokenizer`` gives for such
a file, by the same steps:

1. **Added tokens** are cut out of the text first: those the file marks
   ``normalized: false`` (Llama 3's specials) in one pass, then, in the
   pieces between, those marked ``normalized: true`` (what ``add_tokens``
   adds: the speech vocabulary). In each pass the leftmost match wins, and
   the longest one at that place; ``lstrip``, ``rstrip`` and
   ``single_word`` are honoured. Tokens are looked up by their first
   character and then by length in a dict, so 190k added tokens cost a few
   dict lookups at each ``<``.
2. **Pre-tokenization** of each piece between added tokens: Llama 3's
   ``Split`` regex (``LLAMA3_PATTERN``) or GPT-2's (``ByteLevel`` with
   ``use_regex``), each written out as a scanner over character classes
   that mirrors the regex engine's ordered alternation and backtracking.
   ``\\s`` is Unicode's White_Space (25 code points; ``str.isspace`` is
   another set), ``\\p{L}`` the categories L*, ``\\p{N}`` Nd/Nl/No, with the
   letters and numbers that Unicode 16 added when ``unicodedata`` is older,
   as the ``tokenizers`` package's regex engine knows them.
3. **ByteLevel**: the UTF-8 bytes of each pre-token mapped to GPT-2's
   printable alphabet (``add_prefix_space`` prepends a space to each piece
   that does not start with one).
4. **BPE** by merge rank (lowest rank first, then leftmost), with
   ``ignore_merges``: a pre-token that is in the vocab is emitted whole.
5. **Post-processing** by the file's ``TemplateProcessing`` (Llama 3:
   ``<|begin_of_text|> $A``) when ``add_special_tokens`` is true.

``decode`` is the ``ByteLevel`` decoder, with ``skip_special_tokens`` and
``clean_up_tokenization_spaces`` from ``tokenizer_config.json``.

Anything else (a normalizer, another pre-tokenizer or regex, a model that
is not a byte-level BPE, such as a SentencePiece Llama 2 with
``byte_fallback``) raises ``ValueError``.
"""

from __future__ import annotations

import heapq
import json
import os
import re
import unicodedata
from dataclasses import dataclass

LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
                  r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")

# Unicode's White_Space property: what the regex engine's \s matches
WHITE_SPACE = frozenset(map(chr, [*range(0x9, 0xE), 0x20, 0x85, 0xA0, 0x1680,
                                  *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F, 0x205F,
                                  0x3000]))
# letters and numbers assigned in Unicode 16.0 (category Cn in older unicodedata)
_U16_LETTERS = ((0x1C89, 0x1C8A), (0xA7CB, 0xA7CD), (0xA7DA, 0xA7DC), (0x105C0, 0x105F3),
                (0x10D4A, 0x10D65), (0x10D6F, 0x10D85), (0x10EC2, 0x10EC4), (0x11380, 0x11389),
                (0x1138B, 0x1138B), (0x1138E, 0x1138E), (0x11390, 0x113B5), (0x113B7, 0x113B7),
                (0x113D1, 0x113D1), (0x113D3, 0x113D3), (0x11BC0, 0x11BE0), (0x13460, 0x143FA),
                (0x16100, 0x1611D), (0x16D40, 0x16D6C), (0x18CFF, 0x18CFF), (0x1E5D0, 0x1E5ED),
                (0x1E5F0, 0x1E5F0), (0x2EBF0, 0x2EE5D))
_U16_NUMBERS = ((0x10D40, 0x10D49), (0x116D0, 0x116E3), (0x11BF0, 0x11BF9), (0x16130, 0x16139),
                (0x16D70, 0x16D79), (0x1CCF0, 0x1CCF9), (0x1E5F1, 0x1E5FA))
# word characters (\w) assigned in Unicode 16.0, and the circled letters
# (So, but Alphabetic): what a ``single_word`` added token checks around it
_U16_WORD = ((0x897, 0x897), (0x1C89, 0x1C8A), (0xA7CB, 0xA7CD), (0xA7DA, 0xA7DC),
             (0x105C0, 0x105F3), (0x10D40, 0x10D65), (0x10D69, 0x10D6D), (0x10D6F, 0x10D85),
             (0x10EC2, 0x10EC4), (0x10EFC, 0x10EFC), (0x11380, 0x11389), (0x1138B, 0x1138B),
             (0x1138E, 0x1138E), (0x11390, 0x113B5), (0x113B7, 0x113C0), (0x113C2, 0x113C2),
             (0x113C5, 0x113C5), (0x113C7, 0x113CA), (0x113CC, 0x113D3), (0x113E1, 0x113E2),
             (0x116D0, 0x116E3), (0x11BC0, 0x11BE0), (0x11BF0, 0x11BF9), (0x11F5A, 0x11F5A),
             (0x13460, 0x143FA), (0x16100, 0x16139), (0x16D40, 0x16D6C), (0x16D70, 0x16D79),
             (0x18CFF, 0x18CFF), (0x1CCF0, 0x1CCF9), (0x1E5D0, 0x1E5FA), (0x2EBF0, 0x2EE5D))
_CIRCLED_LETTERS = ((0x24B6, 0x24E9), (0x1F130, 0x1F149), (0x1F150, 0x1F169),
                    (0x1F170, 0x1F189))
_OLD_UNICODE = tuple(map(int, unicodedata.unidata_version.split("."))) < (16,)

# character classes of the scanners: letter, number, White_Space, anything else
L, N, S, O = "L", "N", "S", "O"
_CLASS: dict[str, str] = {}


def _in(cp: int, ranges) -> bool:
    return any(a <= cp <= b for a, b in ranges)


def char_class(c: str) -> str:
    k = _CLASS.get(c)
    if k is None:
        cat = unicodedata.category(c)
        if c in WHITE_SPACE:
            k = S
        elif cat[0] == "L":
            k = L
        elif cat in ("Nd", "Nl", "No"):
            k = N
        elif cat == "Cn" and _OLD_UNICODE and _in(ord(c), _U16_LETTERS):
            k = L
        elif cat == "Cn" and _OLD_UNICODE and _in(ord(c), _U16_NUMBERS):
            k = N
        else:
            k = O
        _CLASS[c] = k
    return k


def _contraction(text: str, i: int, n: int, fold: bool) -> int:
    """End of 's|'t|'re|'ve|'m|'ll|'d at ``i`` (case-folded: S, T, ...
    and U+017F, which folds to s), else -1."""
    if text[i] != "'" or i + 1 >= n:
        return -1
    c = text[i + 1]
    if c in ("sStTdDmMſ" if fold else "stdm"):
        return i + 2
    if i + 2 < n:
        pair = c + text[i + 2]
        if (pair.lower() if fold and pair.isascii() else pair) in ("re", "ve", "ll"):
            return i + 3
    return -1


def _whitespace_end(text: str, cls, i: int, n: int, newline_run: bool) -> int:
    """The whitespace alternatives at ``i`` (a White_Space character):
    [\\s*[\\r\\n]+ (``newline_run``)], \\s+(?!\\S), \\s+."""
    j = i + 1
    while j < n and cls[j] == S:
        j += 1
    if newline_run:  # \s* backs off to the run's last \r or \n
        for m in range(j - 1, i - 1, -1):
            if text[m] in "\r\n":
                return m + 1
    if j == n or j - i >= 2:  # \s+(?!\S): the last space goes to the next word
        return j if j == n else j - 1
    return j


def _run(cls, j: int, n: int, k: str, limit: int | None = None) -> int:
    stop = n if limit is None else min(n, limit)
    while j < stop and cls[j] == k:
        j += 1
    return j


def _llama3_end(text: str, cls, i: int, n: int) -> int:
    e = _contraction(text, i, n, fold=True)
    if e > 0:
        return e
    c, k = text[i], cls[i]
    # [^\r\n\p{L}\p{N}]?\p{L}+
    if k == L or (k != N and c not in "\r\n" and i + 1 < n and cls[i + 1] == L):
        return _run(cls, i + 1, n, L)
    if k == N:  # \p{N}{1,3}
        return _run(cls, i + 1, n, N, i + 3)
    s = i + 1 if c == " " else i  # ' ?[^\s\p{L}\p{N}]+[\r\n]*'
    if s < n and cls[s] == O:
        j = _run(cls, s + 1, n, O)
        while j < n and text[j] in "\r\n":
            j += 1
        return j
    return _whitespace_end(text, cls, i, n, newline_run=True)


def _gpt2_end(text: str, cls, i: int, n: int) -> int:
    e = _contraction(text, i, n, fold=False)
    if e > 0:
        return e
    s = i + 1 if text[i] == " " else i  # ' ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+'
    if s < n and cls[s] != S:
        return _run(cls, s + 1, n, cls[s])
    return _whitespace_end(text, cls, i, n, newline_run=False)


def split_pretokens(text: str, pattern: str) -> list[str]:
    """The pieces a ``Split(pattern, "Isolated")`` pre-tokenizer gives:
    ``pattern`` is ``"llama3"`` or ``"gpt2"`` (every position of a string
    starts a match of either, so no piece falls between matches)."""
    end = _llama3_end if pattern == "llama3" else _gpt2_end
    cls = [char_class(c) for c in text]
    n, i, out = len(text), 0, []
    while i < n:
        j = end(text, cls, i, n)
        out.append(text[i:j])
        i = j
    return out


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's map of the 256 bytes to printable characters."""
    bs = [*range(ord("!"), ord("~") + 1), *range(ord("¡"), ord("¬") + 1),
          *range(ord("®"), ord("ÿ") + 1)]
    cs = list(bs)
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


BYTE_TO_CHAR = bytes_to_unicode()
CHAR_TO_BYTE = {c: b for b, c in BYTE_TO_CHAR.items()}


@dataclass(frozen=True)
class AddedToken:
    content: str
    special: bool = False
    normalized: bool = True
    lstrip: bool = False
    rstrip: bool = False
    single_word: bool = False


def _is_word_char(c: str) -> bool:
    """Unicode \\w: Alphabetic, marks, Nd, Pc and the joiners."""
    cat = unicodedata.category(c)
    return (cat[0] in "LM" or cat in ("Nd", "Nl", "Pc") or c in "\u200c\u200d"
            or _in(ord(c), _CIRCLED_LETTERS)
            or (cat == "Cn" and _OLD_UNICODE and _in(ord(c), _U16_WORD)))


class _Matcher:
    """Leftmost-longest matching of a set of literal strings: candidates are
    found by their first character and tried longest first."""

    def __init__(self, tokens: dict[str, int]):
        self.tokens = tokens
        lengths: dict[str, set[int]] = {}
        for t in tokens:
            lengths.setdefault(t[0], set()).add(len(t))
        self.lengths = {c: sorted(ls, reverse=True) for c, ls in lengths.items()}
        self.first = (re.compile("[" + "".join(re.escape(c) for c in sorted(lengths)) + "]")
                      if lengths else None)

    def finditer(self, text: str):
        """(start, end) of each non-overlapping leftmost-longest match."""
        pos = 0
        while self.first is not None:
            m = self.first.search(text, pos)
            if m is None:
                return
            i = m.start()
            for n in self.lengths[text[i]]:
                if text[i:i + n] in self.tokens:
                    yield i, i + n
                    pos = i + n
                    break
            else:
                pos = i + 1


class HFTokenizer:
    """A byte-level BPE ``tokenizer.json`` with the surface the port uses:
    ``__len__``, ``add_tokens``, ``convert_tokens_to_ids``, ``encode``,
    ``__call__``, ``decode`` and the bos/eos/pad tokens and ids."""

    def __init__(self, spec: dict, config: dict | None = None):
        config = config or {}
        if spec.get("normalizer") is not None:
            raise ValueError(f"unsupported tokenizer.json: a normalizer "
                             f"({spec['normalizer'].get('type')}); only byte-level BPE "
                             "tokenizers without one (Llama 3's kind) are read")
        self._pattern, self._prefix_space = _pre_tokenizer(spec.get("pre_tokenizer"))
        model = spec.get("model") or {}
        if model.get("type") != "BPE" or model.get("byte_fallback") or \
                model.get("continuing_subword_prefix") or model.get("end_of_word_suffix"):
            raise ValueError(
                f"unsupported tokenizer.json model: type {model.get('type')!r}, byte_fallback "
                f"{model.get('byte_fallback')}, continuing_subword_prefix "
                f"{model.get('continuing_subword_prefix')!r}, end_of_word_suffix "
                f"{model.get('end_of_word_suffix')!r}; only a byte-level BPE (Llama 3's) is "
                "read, not a SentencePiece-style one")
        decoder = spec.get("decoder") or {}
        if decoder.get("type") != "ByteLevel":
            raise ValueError(f"unsupported tokenizer.json decoder {decoder.get('type')!r}; "
                             "only ByteLevel is read")
        self._template = _template(spec.get("post_processor"))
        self.vocab: dict[str, int] = dict(model["vocab"])
        self._id_to_token = {i: t for t, i in self.vocab.items()}
        self.ignore_merges = bool(model.get("ignore_merges"))
        self._merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, m in enumerate(model.get("merges") or []):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            if a in self.vocab and b in self.vocab and a + b in self.vocab:
                self._merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b])
        self._cache: dict[str, list[int]] = {}

        self._added: dict[str, int] = {}  # content -> id
        self._added_tokens: dict[int, AddedToken] = {}  # id -> token
        self._special_ids: set[int] = set()
        self._max_added = -1  # the largest added id
        self._n_new = 0  # added contents that are not in the model's vocab
        self._matchers = None
        for t in sorted(spec.get("added_tokens") or [], key=lambda t: t["id"]):
            self._add(AddedToken(t["content"], t.get("special", False),
                                 t.get("normalized", True), t.get("lstrip", False),
                                 t.get("rstrip", False), t.get("single_word", False)),
                      t["id"])

        self.bos_token = _token_str(config.get("bos_token"))
        self.eos_token = _token_str(config.get("eos_token"))
        self.pad_token = _token_str(config.get("pad_token"))
        self.model_max_length = config.get("model_max_length")
        self.clean_up_tokenization_spaces = bool(config.get("clean_up_tokenization_spaces",
                                                            False))

    @classmethod
    def from_dir(cls, model_dir: str) -> "HFTokenizer":
        with open(os.path.join(model_dir, "tokenizer.json"), encoding="utf-8") as f:
            spec = json.load(f)
        config = {}
        path = os.path.join(model_dir, "tokenizer_config.json")
        if os.path.isfile(path):
            with open(path, encoding="utf-8") as f:
                config = json.load(f)
        return cls(spec, config)

    # --- vocabulary -------------------------------------------------------

    def __len__(self) -> int:
        return len(self.vocab) + self._n_new

    def token_to_id(self, token: str) -> int | None:
        i = self._added.get(token)
        return i if i is not None else self.vocab.get(token)

    def convert_tokens_to_ids(self, token: str | list[str]):
        """Ids of tokens, None for a token not in the vocabulary (as the
        ``transformers`` fast tokenizer without an unk token)."""
        if isinstance(token, list):
            return [self.token_to_id(t) for t in token]
        return self.token_to_id(token)

    def id_to_token(self, i: int) -> str | None:
        t = self._added_tokens.get(i)
        return t.content if t is not None else self._id_to_token.get(i)

    @property
    def bos_token_id(self):
        return None if self.bos_token is None else self.token_to_id(self.bos_token)

    @property
    def eos_token_id(self):
        return None if self.eos_token is None else self.token_to_id(self.eos_token)

    @property
    def pad_token_id(self):
        return None if self.pad_token is None else self.token_to_id(self.pad_token)

    def add_tokens(self, tokens, special_tokens: bool = False) -> int:
        """Add tokens as ``tokenizers``' ``AddedVocabulary`` does: a string
        is normalized and not special (special with ``special_tokens``); a
        token already in the vocabulary keeps its id, a new one takes the
        next id after the vocabulary and the tokens added so far. Returns
        the count added (tokens already added with the same flags are
        not)."""
        return sum(self._add(AddedToken(t, special=special_tokens,
                                        normalized=not special_tokens)
                             if isinstance(t, str) else t) for t in tokens)

    def _add(self, t: AddedToken, new_id: int | None = None) -> int:
        old = self._added.get(t.content)
        if not t.content or (old is not None and self._added_tokens[old] == t):
            return 0
        if new_id is None:
            if old is not None:
                new_id = old
            elif t.content in self.vocab:
                new_id = self.vocab[t.content]
            else:
                top = self._max_added
                new_id = top + 1 if top >= len(self.vocab) else len(self.vocab)
        if old is None and t.content not in self.vocab:
            self._n_new += 1
        self._max_added = max(self._max_added, new_id)
        self._added[t.content] = new_id
        self._added_tokens[new_id] = t
        if t.special:
            self._special_ids.add(new_id)
        self._matchers = None
        return 1

    # --- encode -----------------------------------------------------------

    def _get_matchers(self):
        if self._matchers is None:
            split = {}, {}
            for content, i in self._added.items():
                split[self._added_tokens[i].normalized][content] = i
            self._matchers = (_Matcher(split[False]), _Matcher(split[True]))
        return self._matchers

    def _split_added(self, text: str, matcher: _Matcher):
        """[(piece, id or None)] of ``text`` around ``matcher``'s tokens."""
        out, start_offset = [], 0
        for start, stop in matcher.finditer(text):
            tid = matcher.tokens[text[start:stop]]
            tok = self._added_tokens[tid]
            if tok.single_word:
                if (start > 0 and _is_word_char(text[start - 1])) or \
                        (stop < len(text) and _is_word_char(text[stop])):
                    continue
            if tok.lstrip:
                s = start
                while s > 0 and text[s - 1] in WHITE_SPACE:
                    s -= 1
                start = max(s, start_offset)
            if tok.rstrip:
                while stop < len(text) and text[stop] in WHITE_SPACE:
                    stop += 1
            if start > start_offset:
                out.append((text[start_offset:start], None))
            out.append((text[start:stop], tid))
            start_offset = stop
        if start_offset < len(text):
            out.append((text[start_offset:], None))
        return out

    def _bpe(self, word: str) -> list[int]:
        ids = self._cache.get(word)
        if ids is not None:
            return ids
        if self.ignore_merges and word in self.vocab:
            ids = [self.vocab[word]]
        else:
            # a character outside the vocab is dropped, as without an unk token
            sym = [self.vocab[c] for c in word if c in self.vocab]
            n = len(sym)
            nxt, prv, alive = [*range(1, n), -1], list(range(-1, n - 1)), [True] * n
            heap = []  # (rank, position, merged id): lowest rank first, then leftmost
            for p in range(n - 1):
                m = self._merges.get((sym[p], sym[p + 1]))
                if m is not None:
                    heap.append((m[0], p, m[1]))
            heapq.heapify(heap)
            while heap:
                _, p, new = heapq.heappop(heap)
                q = nxt[p] if alive[p] else -1
                if q < 0 or self._merges.get((sym[p], sym[q]), (0, None))[1] != new:
                    continue  # an expired entry
                sym[p], alive[q] = new, False
                nxt[p] = nxt[q]
                if nxt[q] >= 0:
                    prv[nxt[q]] = p
                for a in (prv[p], p):
                    b = nxt[a] if a >= 0 else -1
                    if a >= 0 and b >= 0 and (sym[a], sym[b]) in self._merges:
                        r, m = self._merges[(sym[a], sym[b])]
                        heapq.heappush(heap, (r, a, m))
            ids = [s for s, ok in zip(sym, alive) if ok]
        if len(self._cache) < 100_000:
            self._cache[word] = ids
        return ids

    def _encode_text(self, text: str) -> list[int]:
        """BPE ids of a piece between added tokens. ``add_prefix_space``
        prefixes the text ByteLevel is given: each piece of Llama 3's Split,
        or the whole piece before GPT-2's regex."""
        def prefixed(t):
            return " " + t if self._prefix_space and not t.startswith(" ") else t

        if self._pattern == "gpt2":
            pieces = split_pretokens(prefixed(text), "gpt2")
        else:
            pieces = [prefixed(p) for p in split_pretokens(text, "llama3")]
        ids = []
        for piece in pieces:
            ids.extend(self._bpe("".join(BYTE_TO_CHAR[b] for b in piece.encode("utf-8"))))
        return ids

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        raw, normalized = self._get_matchers()
        ids: list[int] = []
        for piece, tid in self._split_added(text, raw):
            if tid is not None:
                ids.append(tid)
                continue
            for sub, sid in self._split_added(piece, normalized):
                if sid is not None:
                    ids.append(sid)
                else:
                    ids.extend(self._encode_text(sub))
        if not add_special_tokens or self._template is None:
            return ids
        out = []
        for item in self._template:
            out.extend(ids if item is None else item)
        return out

    def __call__(self, text, add_special_tokens: bool = True, **kw):
        return {"input_ids": self.encode(text, add_special_tokens=add_special_tokens)}

    # --- decode -----------------------------------------------------------

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        buf = bytearray()
        for i in ids:
            i = int(i)
            tok = self.id_to_token(i)
            if tok is None or (skip_special_tokens and i in self._special_ids):
                continue
            if all(c in CHAR_TO_BYTE for c in tok):
                buf.extend(CHAR_TO_BYTE[c] for c in tok)
            else:
                buf.extend(tok.encode("utf-8"))
        text = buf.decode("utf-8", errors="replace")
        return _clean_up(text) if self.clean_up_tokenization_spaces else text


def _clean_up(text: str) -> str:
    """``transformers``' ``clean_up_tokenization``."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                 (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"),
                 (" 're", "'re")):
        text = text.replace(a, b)
    return text


def _token_str(t) -> str | None:
    return t.get("content") if isinstance(t, dict) else t


def _pre_tokenizer(p: dict | None) -> tuple[str | None, bool]:
    """(scanner, add_prefix_space) of the supported pre-tokenizers: Llama
    3's Sequence[Split(LLAMA3_PATTERN, Isolated), ByteLevel(use_regex=False)]
    or GPT-2's ByteLevel(use_regex=True)."""
    if p and p.get("type") == "ByteLevel" and p.get("use_regex", True):
        return "gpt2", bool(p.get("add_prefix_space"))
    if p and p.get("type") == "Sequence" and len(p.get("pretokenizers", [])) == 2:
        split, bl = p["pretokenizers"]
        if (split.get("type") == "Split" and split.get("pattern") == {"Regex": LLAMA3_PATTERN}
                and split.get("behavior") == "Isolated" and not split.get("invert")
                and bl.get("type") == "ByteLevel" and not bl.get("use_regex", True)):
            return "llama3", bool(bl.get("add_prefix_space"))
    raise ValueError(f"unsupported tokenizer.json pre_tokenizer {json.dumps(p)[:300]}; only "
                     "Llama 3's Split + ByteLevel and GPT-2's ByteLevel are read")


def _template(p: dict | None):
    """The single-sequence template as a list: None for the sequence, a
    list of ids for each special token; None without a template."""
    if p is None:
        return None
    if p.get("type") == "Sequence":
        found = [_template(q) for q in p.get("processors", [])]
        found = [t for t in found if t is not None]
        if len(found) > 1:
            raise ValueError("tokenizer.json has more than one TemplateProcessing")
        return found[0] if found else None
    if p.get("type") == "ByteLevel":  # offsets only
        return None
    if p.get("type") == "TemplateProcessing":
        out = []
        for item in p["single"]:
            if "Sequence" in item:
                if item["Sequence"]["id"] != "A":
                    raise ValueError(f"unsupported single-sequence template item {item}")
                out.append(None)
            else:
                out.append(list(p["special_tokens"][item["SpecialToken"]["id"]]["ids"]))
        return out
    raise ValueError(f"unsupported tokenizer.json post_processor {p.get('type')!r}; only "
                     "TemplateProcessing and ByteLevel are read")
