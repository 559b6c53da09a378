"""Byte-level BPE tokenizer for CLIP.

The port's own copy of the JAX package's ``tokenizer.py`` ``SimpleTokenizer``
with its default ``lower`` cleaning: the same vocabulary file and the same
framing (``<sot> ids <eot>`` zero-padded to the context length, over-long
sequences cut with the last slot forced to EOT), as numpy int32 arrays.

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
import os
import unicodedata
from functools import lru_cache
from typing import List, Optional, Union

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
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
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
    """CLIP byte-BPE tokenizer producing fixed-length int32 id arrays."""

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
