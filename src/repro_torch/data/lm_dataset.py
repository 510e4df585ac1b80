"""LM training batches from the synthetic corpus (for training loops).

An own copy of the text branch of the reference's
``data/lm_dataset.py``: fixed-shape (tokens, labels) numpy batches drawn
from the hashed-token stream of a ``SyntheticSquad`` corpus, the same
batches as the reference's for the same seed.  The modality stubs
(vision, audio) arrive with their model families (``ROADMAP.md`` queue
1, item 8).
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from repro_torch.core.config import ModelConfig
from repro_torch.data.synthetic_squad import SyntheticSquad
from repro_torch.data.tokenizer import HashTokenizer


class LMDataset:
    def __init__(self, cfg: ModelConfig, seq_len: int, seed: int = 0,
                 n_paragraphs: int = 200):
        if cfg.modality != "text":
            raise NotImplementedError(
                f"{cfg.name}: modality={cfg.modality!r} batches: ROADMAP.md "
                f"queue 1, item 8")
        self.cfg = cfg
        self.seq_len = seq_len
        self.rng = np.random.default_rng(seed)
        tok = HashTokenizer(cfg.vocab_size)
        corpus = SyntheticSquad(n_paragraphs=n_paragraphs, n_questions=10,
                                seed=seed)
        ids = []
        for p in corpus.paragraphs:
            ids.extend(tok.encode(p.text, eos=True))
        self.stream = np.asarray(ids, np.int32)

    def batches(self, batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
        S = self.seq_len
        n = len(self.stream) - S - 1
        while True:
            starts = self.rng.integers(0, n, size=batch_size)
            toks = np.stack([self.stream[s: s + S] for s in starts])
            labs = np.stack([self.stream[s + 1: s + 1 + S] for s in starts])
            yield {"tokens": toks, "labels": labs}
