# coding=utf-8
"""CLIP byte-pair-encoding tokenizer (own copy of the JAX package's
`models/tokenizer.py`, reference: modules/simple_tokenizer.py:63-146).

The merges table `assets/bpe_simple_vocab_16e6.txt.gz` is OpenAI's public
CLIP vocabulary.  `regex` and `ftfy` are optional.  A module of either name
that lacks the function used here (`regex.compile`, `ftfy.fix_text`) — an
empty stand-in module left in `sys.modules` — counts as absent, and the
check is made when a tokenizer is built, not when this file is imported.
"""
from __future__ import annotations

import functools
import gzip
import html
import importlib
import os
import re as _stdlib_re
from typing import Dict, List, Sequence, Tuple

import numpy as np

DEFAULT_BPE_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "bpe_simple_vocab_16e6.txt.gz")

SOT_TOKEN = "<|startoftext|>"
EOT_TOKEN = "<|endoftext|>"

_UNICODE_PATTERN = (r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m"""
                    r"""|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""")
_ASCII_PATTERN = (r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m"""
                  r"""|'ll|'d|[A-Za-z]+|[0-9]|[^\sA-Za-z0-9]+""")


def _optional_module(name: str, attr: str):
    """The module `name` if it imports and has `attr`, else None."""
    try:
        mod = importlib.import_module(name)
    except ImportError:
        return None
    return mod if callable(getattr(mod, attr, None)) else None


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (GPT-2/CLIP table)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _get_pairs(word: Tuple[str, ...]) -> set:
    return set(zip(word[:-1], word[1:]))


class SimpleTokenizer:
    """CLIP BPE tokenizer with a 49408-entry vocabulary."""

    def __init__(self, bpe_path: str = DEFAULT_BPE_PATH):
        self._ftfy = _optional_module("ftfy", "fix_text")
        regex = _optional_module("regex", "compile")
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merge_lines = f.read().split("\n")
        merge_lines = merge_lines[1:49152 - 256 - 2 + 1]
        merges = [tuple(line.split()) for line in merge_lines]

        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend([SOT_TOKEN, EOT_TOKEN])
        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {SOT_TOKEN: SOT_TOKEN, EOT_TOKEN: EOT_TOKEN}
        self._re = regex if regex is not None else _stdlib_re
        self.pat = self._re.compile(
            _UNICODE_PATTERN if regex is not None else _ASCII_PATTERN,
            self._re.IGNORECASE)

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def _clean(self, text: str) -> str:
        if self._ftfy is not None:
            text = self._ftfy.fix_text(text)
        text = html.unescape(html.unescape(text)).strip()
        return self._re.sub(r"\s+", " ", text).strip().lower()

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first \
                        and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        result = " ".join(word)
        self.cache[token] = result
        return result

    def tokenize(self, text: str) -> List[str]:
        tokens: List[str] = []
        for token in self.pat.findall(self._clean(text)):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            tokens.extend(self.bpe(token).split(" "))
        return tokens

    def encode(self, text: str) -> List[int]:
        return [self.encoder[t] for t in self.tokenize(text)]

    def decode(self, tokens: Sequence[int]) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return bytearray(self.byte_decoder[c] for c in text).decode(
            "utf-8", errors="replace").replace("</w>", " ")

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        return [self.encoder[t] for t in tokens]

    @property
    def vocab(self) -> Dict[str, int]:
        return self.encoder


def tokenize_batch(tokenizer: SimpleTokenizer, texts: Sequence[str],
                   max_words: int = 32
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """SOT + BPE(<= max_words-2) + EOT, zero-padded, with mask and segment
    arrays (reference: dataloaders/dataloader_msrvtt_retrieval.py:56-89)."""
    sot = tokenizer.encoder[SOT_TOKEN]
    eot = tokenizer.encoder[EOT_TOKEN]
    ids = np.zeros((len(texts), max_words), np.int32)
    mask = np.zeros((len(texts), max_words), np.int32)
    seg = np.zeros((len(texts), max_words), np.int32)
    for i, text in enumerate(texts):
        row = [sot] + tokenizer.encode(text)[: max_words - 2] + [eot]
        ids[i, : len(row)] = row
        mask[i, : len(row)] = 1
    return ids, mask, seg
