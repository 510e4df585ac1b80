"""BM25 sparse lexical retrieval over a hashed vocabulary.

The paper's retriever: BM25 bag-of-words scoring over the corpus
paragraphs [Robertson & Zaragoza 2009].  The index is a dense
(docs × hashed vocab) term-frequency matrix built in numpy.  Serving
(``topk``, the router's score statistics) scores one query on the host
in numpy, as the reference does; ``scores_batch`` scores a batch of
queries through ``repro_torch.kernels.bm25``: the plain torch version
on the CPU, the K5 kernel on the card.  Both read the nonzeros of the
matrix (a ``BM25Csr``, about 6 MB at the SQuAD scale against 327.7 MB
dense), compacted once on the host and copied to each device once.

The engine backends reach it through the ``Retriever`` protocol of
``retrieval/hybrid.py`` (``IndexRetriever("bm25", index)``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.config import RetrievalConfig
from repro_torch.core.device import resolve_device
from repro_torch.data.tokenizer import words, _h
from repro_torch.kernels.bm25 import BM25Csr, bm25_scores, compact_tf


def hash_term(w: str, dim: int) -> int:
    return _h(w, dim)


@dataclass
class BM25Index:
    cfg: RetrievalConfig
    tf: np.ndarray          # (D, V) float32 term frequencies
    doc_len: np.ndarray     # (D,)
    idf: np.ndarray         # (V,)
    texts: List[str]
    # the nonzeros of tf, compacted on the host once
    _csr: Optional[BM25Csr] = field(default=None, init=False, repr=False,
                                    compare=False)
    # (csr, doc_len, idf) on each device scores_batch ran on
    _on_device: Dict[torch.device, Tuple[BM25Csr, torch.Tensor,
                                         torch.Tensor]] = field(
        default_factory=dict, init=False, repr=False, compare=False)

    @classmethod
    def build(cls, docs: Sequence[str], cfg: RetrievalConfig = RetrievalConfig()):
        V, D = cfg.vocab_hash_dim, len(docs)
        tf = np.zeros((D, V), np.float32)
        for i, doc in enumerate(docs):
            for w in words(doc):
                tf[i, hash_term(w, V)] += 1.0
        doc_len = tf.sum(axis=1)
        df = (tf > 0).sum(axis=0)
        idf = np.log(1.0 + (D - df + 0.5) / (df + 0.5)).astype(np.float32)
        return cls(cfg, tf, doc_len, idf, list(docs))

    def query_vector(self, query: str) -> np.ndarray:
        v = np.zeros(self.cfg.vocab_hash_dim, np.float32)
        for w in words(query):
            v[hash_term(w, self.cfg.vocab_hash_dim)] += 1.0
        return v

    # ------------------------------------------------------------------
    # scoring
    # ------------------------------------------------------------------
    def scores_np(self, qv: np.ndarray) -> np.ndarray:
        """Reference numpy BM25 for one query vector (V,) -> (D,)."""
        k1, b = self.cfg.k1, self.cfg.b
        avg = self.doc_len.mean() + 1e-6
        norm = k1 * (1 - b + b * self.doc_len[:, None] / avg)
        sat = self.tf * (k1 + 1) / (self.tf + norm)
        return (sat * (self.idf * qv)[None, :]).sum(axis=1)

    def _device_arrays(self, device):
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            # "cuda" and "cuda:0" name one card: one copy, one key
            dev = torch.device("cuda", torch.cuda.current_device())
        arrays = self._on_device.get(dev)
        if arrays is None:
            if self._csr is None:
                self._csr = compact_tf(torch.from_numpy(self.tf))
            arrays = self._on_device[dev] = (
                self._csr.to(dev), torch.from_numpy(self.doc_len).to(dev),
                torch.from_numpy(self.idf).to(dev))
        return arrays

    def device_csr(self, device) -> BM25Csr:
        """The nonzeros of ``tf`` on ``device``, compacted on the host
        once and copied there once (with ``doc_len`` and ``idf``)."""
        return self._device_arrays(device)[0]

    def scores_batch(self, qvs: torch.Tensor) -> torch.Tensor:
        """Batched scoring on ``qvs``'s device: (Q, V) -> (Q, D).

        Goes through ``kernels.bm25.bm25_scores`` with the index's
        :meth:`device_csr`: its plain version on the CPU, the K5 kernel
        on the card (no host sync there).
        """
        csr, doc_len, idf = self._device_arrays(qvs.device)
        return bm25_scores(qvs, csr, doc_len, idf, k1=self.cfg.k1,
                           b=self.cfg.b)

    def topk(self, query: str, k: int):
        """Returns (indices, scores) of the top-k docs for a query."""
        if k <= 0:
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        s = self.scores_np(self.query_vector(query))
        idx = np.argpartition(-s, min(k, len(s) - 1))[:k]
        idx = idx[np.argsort(-s[idx])]
        return idx, s[idx]

    def score_stats(self, query: str, k: int = 5) -> np.ndarray:
        """Uncertainty indicators from retrieval scores (paper §3.3)."""
        s = self.scores_np(self.query_vector(query))
        top = np.sort(s)[::-1][:k]
        gap = top[0] - top[1] if len(top) > 1 else 0.0
        return np.array([top[0], top.mean(), top.std(), gap], np.float32)

    def cooccurrence_stats(self, query: str, k: int = 5) -> np.ndarray:
        """Do the query's two highest-idf terms co-occur in any top doc?

        A cheap evidence-presence indicator (still purely a function of
        retrieval scores/term statistics — no oracle access): SQuAD-style
        unanswerables tend to lack any document containing both the
        entity and the asked attribute.
        """
        qv = self.query_vector(query)
        terms = np.nonzero(qv)[0]
        if len(terms) == 0:
            return np.zeros(4, np.float32)
        by_idf = terms[np.argsort(-self.idf[terms])][:2]
        idx, _ = self.topk(query, k)
        present = (self.tf[idx][:, by_idf] > 0)          # (k, <=2)
        both = present.all(axis=1).astype(np.float32)
        return np.array([
            both.max(initial=0.0),
            both.mean() if len(both) else 0.0,
            present[:, 0].mean() if len(idx) else 0.0,
            present[:, -1].mean() if len(idx) else 0.0,
        ], np.float32)
