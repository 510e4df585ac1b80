"""Deterministic hashed tokenizer.

No external vocab files in this container, so token ids come from a
stable blake2 hash of the word — enough for BM25 lexical retrieval and
for feeding the local JAX generation backends.  Ids 0..3 are reserved
(PAD/BOS/EOS/UNK).
"""
from __future__ import annotations

import hashlib
import re
from typing import List

_WORD_RE = re.compile(r"[a-z0-9]+")

PAD, BOS, EOS, UNK = 0, 1, 2, 3
N_RESERVED = 4


def words(text: str) -> List[str]:
    return _WORD_RE.findall(text.lower())


def trim_at_eos(tokens) -> List[int]:
    """Token list truncated at the first EOS (inclusive) — the shared
    definition of a generation's useful tokens (parity tests, serving
    benchmarks)."""
    out: List[int] = []
    for t in tokens:
        out.append(int(t))
        if out[-1] == EOS:
            break
    return out


def _h(word: str, mod: int) -> int:
    d = hashlib.blake2s(word.encode(), digest_size=8).digest()
    return int.from_bytes(d, "little") % mod


class HashTokenizer:
    def __init__(self, vocab_size: int):
        assert vocab_size > N_RESERVED
        self.vocab_size = vocab_size

    def encode_word(self, w: str) -> int:
        return N_RESERVED + _h(w, self.vocab_size - N_RESERVED)

    def encode(self, text: str, *, bos: bool = False, eos: bool = False,
               max_len: int | None = None) -> List[int]:
        ids = [self.encode_word(w) for w in words(text)]
        if bos:
            ids = [BOS] + ids
        if eos:
            ids = ids + [EOS]
        if max_len is not None:
            ids = ids[:max_len] + [PAD] * max(0, max_len - len(ids))
        return ids

    def n_tokens(self, text: str) -> int:
        return len(words(text))
