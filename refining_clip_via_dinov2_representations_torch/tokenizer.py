"""Tokenizers: byte-level BPE for CLIP, and fast-tokenizer files for SigLIP
and CLIPA.

The port's own copy of the JAX package's ``tokenizer.py`` ``SimpleTokenizer``
with its default ``lower`` cleaning: the same vocabulary file and the same
framing (``<sot> ids <eot>`` zero-padded to the context length, over-long
sequences cut with the last slot forced to EOT), as numpy int32 arrays.

``HFTokenizer`` and ``SigLipTokenizer`` are the JAX package's classes of
those names (``tpu/tokenizer.py:499-731``) without ``transformers``: a
``tokenizer.json`` is read by ``FastTokenizerFile``, which covers what the
SigLIP vocabularies use (a ``Unigram`` model decoded by Viterbi over the
piece scores, with the unknown piece's score and ``fuse_unk`` as the
``tokenizers`` library has them; the ``Metaspace`` pre-tokenizer; no
normalizer; ``TemplateProcessing``'s end token; the special tokens split
out first) and what ``bert-base-uncased`` uses, CLIPA's tokenizer
(``BertNormalizer``, ``BertPreTokenizer``, a greedy longest-match
``WordPiece`` model, ``TemplateProcessing``'s ``[CLS] $A [SEP]``), and
raises, naming what is missing, for anything else. Files
come from a path, from ``$REFINING_CLIP_VOCAB_DIR`` or from the hub-cache
layout (``models/pretrained.py:hub_snapshot_dirs``); nothing is downloaded.

It needs no ``regex`` package: the pre-tokenizer pattern
``specials|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``
(case-insensitive) is matched by a small scanner over ``unicodedata``
categories, trying the alternatives in the pattern's order at each position
as the regex engine does. ``ftfy`` is optional, as in the JAX package: without
it the text is NFC-normalised.
"""

from __future__ import annotations

import gzip
import html
import json
import os
import string
import unicodedata
import warnings
from functools import lru_cache
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

try:  # optional, as in the JAX package
    import ftfy
except ImportError:
    ftfy = None

DEFAULT_CONTEXT_LENGTH = 77
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
_BPE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                         "bpe_simple_vocab_16e6.txt.gz")
_SPECIAL_TOKENS = ["<start_of_text>", "<end_of_text>"]


@lru_cache()
def bytes_to_unicode():
    """Map the 256 byte values to printable code points (GPT-2/CLIP scheme)."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    mapping = {b: chr(b) for b in printable}
    shift = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + shift)
            shift += 1
    return mapping


def basic_clean(text: str) -> str:
    text = ftfy.fix_text(text) if ftfy is not None else unicodedata.normalize("NFC", text)
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return " ".join(text.split()).strip()


def clean_lower(text: str) -> str:
    return whitespace_clean(basic_clean(text)).lower()


_PUNCT_TABLE = str.maketrans("", "", string.punctuation)


def canonicalize_text(text: str, *, keep_punctuation_exact_string: Optional[str] = None,
                      trans_punctuation: dict = _PUNCT_TABLE) -> str:
    """Lower case, ASCII punctuation removed, whitespace collapsed (big_vision's
    prompt canonicalisation, ``tpu/tokenizer.py:95-113``)."""
    text = text.replace("_", " ")
    if keep_punctuation_exact_string:
        text = keep_punctuation_exact_string.join(
            part.translate(trans_punctuation)
            for part in text.split(keep_punctuation_exact_string))
    else:
        text = text.translate(trans_punctuation)
    return " ".join(text.lower().split()).strip()


def _clean_canonicalize(text: str) -> str:
    return canonicalize_text(basic_clean(text))


def _clean_whitespace(text: str) -> str:
    return whitespace_clean(basic_clean(text))


def get_clean_fn(type: str) -> Callable[[str], str]:
    """The ``clean`` option of the HF tokenizers (``tpu/tokenizer.py:124-131``)."""
    fns = {"canonicalize": _clean_canonicalize, "lower": clean_lower,
           "whitespace": _clean_whitespace}
    if type not in fns:
        raise ValueError(f"Invalid clean function ({type}).")
    return fns[type]


def _is_letter(c: str) -> bool:  # \p{L}
    return unicodedata.category(c)[0] == "L"


def _is_number(c: str) -> bool:  # \p{N}
    return unicodedata.category(c)[0] == "N"


def _match_literal(text: str, i: int, lit: str) -> bool:
    """Case-insensitive match of an ASCII literal at ``text[i:]`` (simple
    case folding, as the regex engine's IGNORECASE: 'ſ' matches 's')."""
    if i + len(lit) > len(text):
        return False
    return all(c == p or c.casefold() == p for c, p in zip(text[i:i + len(lit)], lit))


def pre_tokenize(text: str, specials: List[str]) -> List[str]:
    """The regex pre-tokenizer's ``findall``, without the regex package."""
    literals = [s.lower() for s in specials] + list(_CONTRACTIONS)
    # a literal can only start where its first character stands (no other
    # character case-folds to '<' or "'"): the scan skips the rest
    starts = {s[0] for s in literals}
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        lit = None
        if text[i] in starts:
            lit = next((s for s in literals if _match_literal(text, i, s)), None)
        if lit is not None:
            out.append(text[i:i + len(lit)])
            i += len(lit)
            continue
        c = text[i]
        j = i + 1
        if _is_letter(c):
            while j < n and _is_letter(text[j]):
                j += 1
        elif _is_number(c):
            pass  # one number character per token
        elif not c.isspace():
            while j < n and not (text[j].isspace() or _is_letter(text[j])
                                 or _is_number(text[j])):
                j += 1
        else:
            i = j  # whitespace separates tokens
            continue
        out.append(text[i:j])
        i = j
    return out


class SimpleTokenizer:
    """CLIP byte-BPE tokenizer producing fixed-length int32 id arrays.

    The merge loop runs in the C++ core (``native/__init__.py:NativeBPE``)
    where ``g++`` builds it, as the JAX tokenizer runs it
    (``tpu/tokenizer.py:171-177,235-248``), with each word's ids memoised;
    where it does not build, in Python. The ids are the same either way."""

    def __init__(self, context_length: int = DEFAULT_CONTEXT_LENGTH):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(_BPE_PATH) as f:
            lines = f.read().decode("utf-8").split("\n")
        merges = [tuple(line.split()) for line in lines[1: 49152 - 256 - 2 + 1]]
        base = list(self.byte_encoder.values())
        vocab = base + [tok + "</w>" for tok in base]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(_SPECIAL_TOKENS)
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self._cache = {t: t for t in _SPECIAL_TOKENS}
        self.vocab_size = len(self.encoder)
        self.sot_token_id, self.eot_token_id = (self.encoder[t] for t in _SPECIAL_TOKENS)
        self.context_length = context_length
        self._native = None
        self._id_cache: Dict[str, List[int]] = {}
        from .native import NativeBPE, load_native

        if load_native() is not None:
            self._native = NativeBPE(merges, vocab)

    def bpe(self, token: str) -> str:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            ranked = [(self.bpe_ranks[p], p) for p in zip(word[:-1], word[1:])
                      if p in self.bpe_ranks]
            if not ranked:
                break
            first, second = min(ranked)[1]
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in pre_tokenize(clean_lower(text), _SPECIAL_TOKENS):
            if self._native is not None:
                word_ids = self._id_cache.get(token)
                if word_ids is None:
                    word_ids = ([self.encoder[token]] if token in _SPECIAL_TOKENS
                                else self._native.encode_word(
                                    "".join(self.byte_encoder[b] for b in token.encode("utf-8"))))
                    self._id_cache[token] = word_ids
                ids.extend(word_ids)
                continue
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def decode(self, tokens) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(self, texts: Union[str, List[str]],
                 context_length: Optional[int] = None) -> np.ndarray:
        """Tokenize to a ``[len(texts), context_length]`` int32 array."""
        if isinstance(texts, str):
            texts = [texts]
        context_length = context_length or self.context_length
        result = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            tokens = [self.sot_token_id] + self.encode(text) + [self.eot_token_id]
            if len(tokens) > context_length:
                tokens = tokens[:context_length]
                tokens[-1] = self.eot_token_id
            result[i, : len(tokens)] = tokens
        return result


@lru_cache(maxsize=1)
def _default_tokenizer() -> SimpleTokenizer:
    return SimpleTokenizer()


def tokenize(texts: Union[str, List[str]],
             context_length: int = DEFAULT_CONTEXT_LENGTH) -> np.ndarray:
    """Module-level convenience matching ``open_clip.tokenize``."""
    return _default_tokenizer()(texts, context_length=context_length)


def decode(output_ids) -> str:
    return _default_tokenizer().decode(np.asarray(output_ids))


# ---------------------------------------------------------------------------
# fast-tokenizer files (``tokenizer.json``) without ``transformers``
# ---------------------------------------------------------------------------

# the ``tokenizers`` library's penalty of the unknown piece under the lowest
# piece score (``models/unigram/model.rs``: K_UNK_PENALTY)
UNK_PENALTY = 10.0


def _unsupported_file(path: str, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{path}: {what}; the port reads tokenizer.json files with a Unigram model, the "
        "Metaspace pre-tokenizer, no normalizer and TemplateProcessing (the SigLIP "
        "vocabularies), or a WordPiece model with the BertNormalizer, the BertPreTokenizer "
        "and TemplateProcessing (bert-base-uncased, CLIPA's); a sentencepiece .model needs "
        "the `sentencepiece` package, which the port does not use")


# Rust's ``char::is_whitespace`` (the Unicode White_Space property), which
# the BERT normalizer and pre-tokenizer use
_WHITESPACE = frozenset(chr(c) for c in (*range(0x9, 0xE), 0x20, 0x85, 0xA0, 0x1680,
                                         *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F,
                                         0x205F, 0x3000))
# the CJK blocks the BERT normalizer spaces out (``normalizers/bert.rs``)
_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def bert_normalize(text: str, clean_text: bool = True, handle_chinese_chars: bool = True,
                   strip_accents: Optional[bool] = None, lowercase: bool = True) -> str:
    """The ``tokenizers`` library's ``BertNormalizer``: drop NUL, U+FFFD and
    control characters (category C*, but tab, newline and return) and turn
    whitespace into spaces; pad CJK characters with spaces; strip accents
    (NFD, then no nonspacing marks; by default where ``lowercase``);
    lowercase character by character."""
    if clean_text:
        text = "".join(" " if c in _WHITESPACE else c for c in text
                       if not (c in "\0\ufffd" or (c not in "\t\n\r"
                                                   and unicodedata.category(c)[0] == "C")))
    if handle_chinese_chars:
        text = "".join(f" {c} " if any(a <= ord(c) <= b for a, b in _CJK) else c for c in text)
    if (lowercase if strip_accents is None else strip_accents):
        text = "".join(c for c in unicodedata.normalize("NFD", text)
                       if unicodedata.category(c) != "Mn")
    if lowercase:
        text = "".join(c.lower() for c in text)
    return text


def bert_pre_tokenize(text: str) -> List[str]:
    """The ``BertPreTokenizer``: words split at whitespace, each punctuation
    character (ASCII punctuation or a category P* character) a word of its
    own."""
    words: List[str] = []
    word = ""
    for c in text:
        if c in _WHITESPACE:
            if word:
                words.append(word)
            word = ""
        elif c in string.punctuation or unicodedata.category(c)[0] == "P":
            if word:
                words.append(word)
            words.append(c)
            word = ""
        else:
            word += c
    if word:
        words.append(word)
    return words


def _token_content(tok) -> Optional[str]:
    """A special token of a ``tokenizer_config.json`` / ``special_tokens_map.json``:
    a string, or a dict holding ``content``."""
    return tok.get("content") if isinstance(tok, dict) else tok


class FastTokenizerFile:
    """A ``tokenizer.json`` whose pipeline the SigLIP vocabularies or
    ``bert-base-uncased`` use. Both:

    * special tokens (the file's ``added_tokens`` and ``special``) split out
      of the raw text first, leftmost-longest, as the ``tokenizers``
      library's added vocabulary does;
    * ``TemplateProcessing``'s single-sequence template (its special tokens'
      ids around the sequence).

    SigLIP's (a ``Unigram`` model):

    * no normalizer;
    * ``Metaspace`` with ``prepend_scheme`` ``"always"`` and ``split``:
      spaces become the replacement character, which is prepended where a
      segment does not start with it, and each run of replacements starts a
      new word;
    * ``Unigram``: each word decoded by Viterbi over the piece scores; a
      character no piece covers becomes the unknown piece at the lowest
      score minus ``UNK_PENALTY``, and adjacent unknown pieces fuse into
      one (``fuse_unk``); ties keep the path found first.

    BERT's (a ``WordPiece`` model):

    * the ``BertNormalizer`` (``bert_normalize``) with the file's flags;
    * the ``BertPreTokenizer`` (``bert_pre_tokenize``);
    * ``WordPiece``: a word longer than ``max_input_chars_per_word``
      characters is the unknown token; otherwise the longest vocabulary
      entry at each position, after the first with the continuing prefix
      (``##``), and where none matches the whole word is the unknown token.

    Anything else raises ``NotImplementedError`` naming it. ``encode``
    returns the ids before truncation and padding; ``frame`` truncates and
    pads one row."""

    def __init__(self, path: str, special: Sequence[str] = ()):
        self.path = path
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        model = spec.get("model") or {}
        self.model_type = model.get("type")
        if self.model_type == "WordPiece":
            self._init_wordpiece(spec)
        elif self.model_type == "Unigram":
            self._init_unigram(spec)
        else:
            raise _unsupported_file(path, f"{self.model_type!r} model")
        # special tokens: the file's added ones, and those the caller names
        # (a tokenizer_config's eos, unk, pad, sep), each at its vocabulary id
        self.added: Dict[str, int] = {t["content"]: t["id"] for t in spec.get("added_tokens", [])}
        for tok in special:
            if tok is not None and tok not in self.added:
                if tok not in self.vocab:
                    raise _unsupported_file(path, f"special token {tok!r} outside the vocabulary")
                self.added[tok] = self.vocab[tok]
        self.template = self._template(spec.get("post_processor"))
        self._cache: Dict[str, List[int]] = {}

    def _init_wordpiece(self, spec: dict) -> None:
        norm = spec.get("normalizer") or {}
        if norm.get("type") != "BertNormalizer":
            raise _unsupported_file(self.path, f"normalizer {norm.get('type')!r} with WordPiece")
        self.bert_flags = {k: norm.get(k, d) for k, d in (
            ("clean_text", True), ("handle_chinese_chars", True), ("strip_accents", None),
            ("lowercase", True))}
        pre = spec.get("pre_tokenizer") or {}
        if pre.get("type") != "BertPreTokenizer":
            raise _unsupported_file(self.path, f"pre-tokenizer {pre.get('type')!r} with WordPiece")
        model = spec["model"]
        self.vocab = dict(model["vocab"])
        self.unk_token = model.get("unk_token", "[UNK]")
        if self.unk_token not in self.vocab:
            raise _unsupported_file(self.path,
                                    f"unk_token {self.unk_token!r} outside the vocabulary")
        self.prefix = model.get("continuing_subword_prefix", "##")
        self.max_chars = int(model.get("max_input_chars_per_word", 100))

    def _init_unigram(self, spec: dict) -> None:
        path = self.path
        if spec.get("normalizer") is not None:
            raise _unsupported_file(path, f"normalizer {spec['normalizer'].get('type')!r}")
        pre = spec.get("pre_tokenizer") or {}
        if pre.get("type") != "Metaspace":
            raise _unsupported_file(path, f"pre-tokenizer {pre.get('type')!r}")
        self.replacement = pre.get("replacement", "▁")
        scheme = pre.get("prepend_scheme", "always" if pre.get("add_prefix_space", True)
                         else "never")
        if scheme != "always" or not pre.get("split", True):
            raise _unsupported_file(path, f"Metaspace prepend_scheme {scheme!r}, split "
                                          f"{pre.get('split', True)}")
        model = spec["model"]
        if model.get("byte_fallback"):
            raise _unsupported_file(path, "Unigram byte_fallback")
        self.pieces = [p for p, _ in model["vocab"]]
        self.scores = [float(score) for _, score in model["vocab"]]
        self.vocab = {p: i for i, p in enumerate(self.pieces)}
        self.unk_id = model.get("unk_id")
        self.unk_score = min(self.scores) - UNK_PENALTY
        self.max_piece = max(len(p) for p in self.pieces)

    def _template(self, post) -> List[Union[str, List[int]]]:
        """The single-sequence template: "A" for the sequence, else the ids of
        a special token."""
        if post is None:
            return ["A"]
        if post.get("type") != "TemplateProcessing":
            raise _unsupported_file(self.path, f"post-processor {post.get('type')!r}")
        out: List[Union[str, List[int]]] = []
        for item in post["single"]:
            if "Sequence" in item:
                out.append("A")
            else:
                out.append(list(post["special_tokens"][item["SpecialToken"]["id"]]["ids"]))
        return out

    @property
    def n_special(self) -> int:
        return sum(len(t) for t in self.template if t != "A")

    def token_id(self, token: str) -> int:
        if token in self.added:
            return self.added[token]
        if token not in self.vocab:
            raise KeyError(f"{self.path}: token {token!r} is not in the vocabulary")
        return self.vocab[token]

    def _split_special(self, text: str) -> List[Tuple[str, bool]]:
        """(segment, is a special token) in order, leftmost-longest."""
        if not self.added:
            return [(text, False)]
        out, start, i = [], 0, 0
        longest = sorted(self.added, key=len, reverse=True)
        while i < len(text):
            hit = next((t for t in longest if text.startswith(t, i)), None)
            if hit is None:
                i += 1
                continue
            if i > start:
                out.append((text[start:i], False))
            out.append((hit, True))
            i = start = i + len(hit)
        if start < len(text):
            out.append((text[start:], False))
        return out

    def _words(self, segment: str) -> List[str]:
        """The Metaspace pre-tokenizer over one segment."""
        rep = self.replacement
        s = segment.replace(" ", rep)
        if s and not s.startswith(rep):
            s = rep + s
        words: List[str] = []
        prev_rep = False
        for c in s:  # MergedWithNext: a run of replacements opens a word
            if c == rep and not prev_rep:
                words.append(c)
            elif words:
                words[-1] += c
            else:
                words.append(c)
            prev_rep = c == rep
        return words

    def _viterbi(self, word: str) -> List[int]:
        """The Unigram model's best segmentation of one word, as ids."""
        if word in self._cache:
            return self._cache[word]
        n = len(word)
        best = [0.0] * (n + 1)
        start: List[Optional[int]] = [None] * (n + 1)
        piece_id = [0] * (n + 1)
        for i in range(n):
            here = best[i]
            single = False
            for j in range(i + 1, min(n, i + self.max_piece) + 1):
                pid = self.vocab.get(word[i:j])
                if pid is None:
                    continue
                cand = self.scores[pid] + here
                if start[j] is None or cand > best[j]:
                    best[j], start[j], piece_id[j] = cand, i, pid
                single = single or j == i + 1
            if not single:
                if self.unk_id is None:
                    raise ValueError(f"{self.path}: {word[i]!r} needs the unknown piece, and "
                                     "the model has no unk_id")
                cand = self.unk_score + here
                if start[i + 1] is None or cand > best[i + 1]:
                    best[i + 1], start[i + 1], piece_id[i + 1] = cand, i, self.unk_id
        pieces, unk_run, end = [], [], n
        while end > 0:
            s0 = start[end]
            if piece_id[end] == self.unk_id:  # fuse_unk: adjacent unknowns are one piece
                unk_run.append(word[s0:end])
            else:
                if unk_run:
                    pieces.append("".join(reversed(unk_run)))
                    unk_run = []
                pieces.append(word[s0:end])
            end = s0
        if unk_run:
            pieces.append("".join(reversed(unk_run)))
        ids = [self.vocab.get(p, self.unk_id) for p in reversed(pieces)]
        self._cache[word] = ids
        return ids

    def _wordpiece(self, word: str) -> List[int]:
        """The WordPiece model's ids of one pre-tokenized word."""
        if word in self._cache:
            return self._cache[word]
        unk = [self.vocab[self.unk_token]]
        if len(word) > self.max_chars:
            return unk
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                piece = word[start:end] if start == 0 else self.prefix + word[start:end]
                if piece in self.vocab:
                    ids.append(self.vocab[piece])
                    break
                end -= 1
            if end == start:  # no entry matches: the whole word is unknown
                ids = unk
                break
            start = end
        self._cache[word] = ids
        return ids

    def encode(self, text: str) -> List[int]:
        """The sequence's ids, before the template, truncation and padding."""
        ids: List[int] = []
        for segment, special in self._split_special(text):
            if special:
                ids.append(self.added[segment])
            elif self.model_type == "WordPiece":
                for word in bert_pre_tokenize(bert_normalize(segment, **self.bert_flags)):
                    ids.extend(self._wordpiece(word))
            else:
                for word in self._words(segment):
                    ids.extend(self._viterbi(word))
        return ids

    def frame(self, ids: List[int], context_length: int, pad_id: int) -> List[int]:
        """Truncate the sequence to leave room for the template's tokens, apply
        the template, pad to ``context_length`` (truncation="longest_first",
        padding="max_length", as the JAX package's calls ask)."""
        ids = ids[:max(0, context_length - self.n_special)]
        out: List[int] = []
        for part in self.template:
            out.extend(ids if part == "A" else part)
        out = out[:context_length]
        return out + [pad_id] * (context_length - len(out))


def _read_json(path: str) -> dict:
    if not os.path.isfile(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _snapshot_files(tokenizer_name: str, cache_dir: Optional[str]) -> str:
    """The directory holding ``tokenizer_name``'s ``tokenizer.json``: the name
    itself when it is a directory, else its snapshot in the hub-cache layout
    under ``cache_dir`` (or the default caches). ``FileNotFoundError`` names
    every path looked at; nothing is downloaded."""
    if os.path.isdir(tokenizer_name):
        dirs = [tokenizer_name]
    else:
        from .models.pretrained import CACHE_DIR, _hf_default_cache, hub_snapshot_dirs

        dirs = []
        for cache in ([cache_dir] if cache_dir else [CACHE_DIR, _hf_default_cache()]):
            dirs += hub_snapshot_dirs(tokenizer_name, cache) or [os.path.join(
                cache, "models--" + tokenizer_name.replace("/", "--"), "snapshots", "*")]
    for d in dirs:
        if os.path.isfile(os.path.join(d, "tokenizer.json")):
            return d
    raise FileNotFoundError(
        f"no tokenizer.json of {tokenizer_name!r}: looked in "
        f"{[os.path.join(d, 'tokenizer.json') for d in dirs]}; the port does not download "
        "tokenizers: fill the hub cache (tokenizer.json, tokenizer_config.json, "
        "special_tokens_map.json) on a machine with network and pass --cache-dir")


class HFTokenizer:
    """The JAX package's ``HFTokenizer`` (``tpu/tokenizer.py:499-556``: an
    ``AutoTokenizer`` with CLIP-style framing) over a hub snapshot's
    ``tokenizer.json``, ``tokenizer_config.json`` and
    ``special_tokens_map.json``, without ``transformers``: the eos, unk,
    pad and sep tokens come from those files, or from the defaults of the
    model's tokenizer class (a Unigram file: T5's ``</s>``, ``<unk>``,
    ``<pad>``; a WordPiece file: BERT's ``[UNK]``, ``[PAD]``, ``[SEP]``, no
    eos); the text is cleaned (``clean``), encoded, cut to leave room for
    the template's tokens, framed and padded on the right to the context
    length (another ``padding_side`` raises). ``strip_sep_token`` zeroes
    the separator's id (CLIPA's rule: ``[SEP]`` becomes padding)."""

    def __init__(self, tokenizer_name: str, context_length: Optional[int] = DEFAULT_CONTEXT_LENGTH,
                 clean: str = "whitespace", strip_sep_token: bool = False,
                 language: Optional[str] = None, cache_dir: Optional[str] = None):
        snapshot = _snapshot_files(tokenizer_name, cache_dir)
        config = {**_read_json(os.path.join(snapshot, "tokenizer_config.json")),
                  **_read_json(os.path.join(snapshot, "special_tokens_map.json"))}
        path = os.path.join(snapshot, "tokenizer.json")
        if (_read_json(path).get("model") or {}).get("type") == "WordPiece":
            tokens = {"eos": None, "unk": "[UNK]", "pad": "[PAD]", "sep": "[SEP]"}
        else:
            tokens = {"eos": "</s>", "unk": "<unk>", "pad": "<pad>", "sep": None}
        for key in tokens:
            if config.get(f"{key}_token") is not None:
                tokens[key] = _token_content(config[f"{key}_token"])
        extra = [_token_content(t) for t in config.get("additional_special_tokens") or []]
        self.tokenizer = FastTokenizerFile(path, [t for t in tokens.values() if t] + extra)
        self.pad_token_id = self.tokenizer.token_id(tokens["pad"])
        self.eos_token_id = self.tokenizer.token_id(tokens["eos"]) if tokens["eos"] else None
        self.sep_token_id = self.tokenizer.token_id(tokens["sep"]) if tokens["sep"] else None
        if config.get("padding_side", "right") != "right":
            raise _unsupported_file(snapshot, f"padding_side {config['padding_side']!r}")
        if language is not None:
            self.set_language(language)
        self.context_length = context_length
        self.clean_fn = get_clean_fn(clean)
        self.strip_sep_token = strip_sep_token

    def __call__(self, texts, context_length: Optional[int] = None) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        context_length = context_length or self.context_length
        assert context_length, "Please set a valid context length in class init or call."
        out = np.asarray([self.tokenizer.frame(self.tokenizer.encode(self.clean_fn(t)),
                                               context_length, self.pad_token_id)
                          for t in texts], dtype=np.int32).reshape(len(texts), context_length)
        if self.strip_sep_token and self.sep_token_id is not None:
            out = np.where(out == self.sep_token_id, 0, out).astype(np.int32)
        return out

    def set_language(self, src_lang):
        warnings.warn("Cannot set language for the tokenizer.")


class SigLipTokenizer:
    """The JAX package's ``SigLipTokenizer`` (``tpu/tokenizer.py:558-731``)
    without ``transformers``, resolving ``tokenizer_name`` offline:

    1. an existing path: a fast-tokenizer ``.json``, or a directory holding
       ``tokenizer.json`` (a sentencepiece ``.model`` raises: it needs the
       ``sentencepiece`` package);
    2. a logical vocabulary (``c4-en`` / ``mc4`` / ``gemma``) or a SigLIP
       model name (``ViT-B-16-SigLIP`` -> ``c4-en``, ``*-i18n`` -> ``mc4``,
       ``*SigLIP2*`` -> ``gemma``), looked up as ``VOCAB_FILES[name]`` or its
       ``.json`` sibling in ``$REFINING_CLIP_VOCAB_DIR``;
    3. the hub cache of the public model carrying the same vocabulary
       (``HF_CACHE_EQUIVALENTS``) under ``$REFINING_CLIP_HF_CACHE`` or the
       default caches.

    Text is cleaned and canonicalised, encoded, cut to leave room for the
    end token and padded with id 1 (0 for gemma), the SigLIP convention."""

    VOCAB_FILES = {"c4-en": "c4_en_32000.model", "mc4": "mc4_250000.model",
                   "gemma": "gemma_256000.model"}
    HF_CACHE_EQUIVALENTS = {"c4-en": "t5-base", "mc4": "google/mt5-base",
                            "gemma": "google/gemma-2b"}

    @classmethod
    def _logical_name(cls, tokenizer_name: str) -> Optional[str]:
        if tokenizer_name in cls.VOCAB_FILES:
            return tokenizer_name
        lname = tokenizer_name.lower()
        if "siglip" in lname:
            if "siglip2" in lname or "gemma" in lname:
                return "gemma"
            return "mc4" if "i18n" in lname else "c4-en"
        return None

    def _load(self, path: str) -> None:
        if os.path.isdir(path):
            path = os.path.join(path, "tokenizer.json")
        elif not path.endswith(".json"):
            raise _unsupported_file(path, "a sentencepiece model")
        self.tokenizer = FastTokenizerFile(path, ["</s>", "<unk>", "<pad>"])

    def __init__(self, tokenizer_name: str, context_length: Optional[int] = 64):
        self.context_length = context_length
        exists = os.path.exists(tokenizer_name)
        logical = None if exists else self._logical_name(tokenizer_name)
        probe = (os.path.basename(tokenizer_name.rstrip("/")) if exists
                 else (logical or tokenizer_name))
        self.pad_token_id = 0 if "gemma" in probe.lower() else 1
        if exists:
            self._load(tokenizer_name)
            return
        if logical is None:
            raise FileNotFoundError(
                f"SigLIP tokenizer '{tokenizer_name}' is neither an existing local path nor a "
                f"known logical vocab name ({sorted(self.VOCAB_FILES)}) or SigLIP model name.")
        vocab_dir = os.environ.get("REFINING_CLIP_VOCAB_DIR", "")
        if vocab_dir:
            base = os.path.join(vocab_dir, self.VOCAB_FILES[logical])
            for cand in (base, os.path.splitext(base)[0] + ".json"):
                if os.path.exists(cand):
                    self._load(cand)
                    return
        try:
            self._load(_snapshot_files(self.HF_CACHE_EQUIVALENTS[logical],
                                       os.environ.get("REFINING_CLIP_HF_CACHE") or None))
            return
        except (FileNotFoundError, NotImplementedError) as e:
            reason = e
        raise FileNotFoundError(
            f"SigLIP vocab '{logical}' not found offline. Options: "
            f"(a) pass a local sentencepiece .model / fast-tokenizer .json "
            f"path directly; (b) place {self.VOCAB_FILES[logical]!r} (or its "
            f".json sibling) in $REFINING_CLIP_VOCAB_DIR; (c) populate the "
            f"HF cache with {self.HF_CACHE_EQUIVALENTS[logical]!r} (same "
            f"vocab) on a connected machine; (d) use a config with "
            f"text_cfg.hf_tokenizer_name (HFTokenizer path). ({reason})")

    def __call__(self, texts, context_length: Optional[int] = None) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        context_length = context_length or self.context_length
        assert context_length, "Please set a valid context length in class init or call."
        rows = [self.tokenizer.frame(self.tokenizer.encode(canonicalize_text(basic_clean(t))),
                                     context_length, self.pad_token_id) for t in texts]
        return np.asarray(rows, dtype=np.int32).reshape(len(texts), context_length)
