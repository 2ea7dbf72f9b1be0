"""CLIP's token ids of a caption of lower-case ASCII words, as the
synthetic captions are (`synth.WORDS`): SOT, each word's byte-pair
encoding, EOT, zeros to `max_words`.  Read from CLIP's public merges
table, the raw file that the program's tokenizer reads too; nothing of
the program is imported."""
from __future__ import annotations

import gzip
import math
import os
from typing import List, Tuple

MERGES = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "centerclip_tpu_torch", "assets",
    "bpe_simple_vocab_16e6.txt.gz")
SOT, EOT = "<|startoftext|>", "<|endoftext|>"


def _byte_chars():
    """CLIP's printable stand-in of each byte, in its vocabulary's order."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return [chr(c) for c in cs]


class Vocab:
    def __init__(self, path: str = MERGES):
        with gzip.open(path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        chars = _byte_chars()
        vocab = (chars + [c + "</w>" for c in chars]
                 + ["".join(m) for m in merges] + [SOT, EOT])
        self.ids = {t: i for i, t in enumerate(vocab)}
        self.rank = {m: i for i, m in enumerate(merges)}

    def word(self, w: str) -> List[int]:
        """Merge the word's adjacent pair of least rank, every occurrence
        of it, until no pair is in the table."""
        parts = list(w[:-1]) + [w[-1] + "</w>"]
        while len(parts) > 1:
            rank, a, b = min((self.rank.get(p, math.inf), *p)
                             for p in zip(parts, parts[1:]))
            if rank == math.inf:
                break
            out, i = [], 0
            while i < len(parts):
                if parts[i:i + 2] == [a, b]:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(parts[i])
                    i += 1
            parts = out
        return [self.ids[p] for p in parts]

    def caption(self, text: str, max_words: int) -> Tuple[int, ...]:
        words = [t for w in text.split() for t in self.word(w)]
        row = [self.ids[SOT]] + words[:max_words - 2] + [self.ids[EOT]]
        return tuple(row + [0] * (max_words - len(row)))
