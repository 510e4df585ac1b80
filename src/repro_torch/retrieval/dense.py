"""Dense vector retrieval over deterministic hashed n-gram embeddings.

The encoder is a signed feature-hash of word uni+bigrams: each n-gram
adds ±1 (±0.5 for bigrams) to a hashed bucket, with the sign drawn from
an independent hash bit so collisions cancel in expectation
[Weinberger et al. 2009].  Rows are L2-normalized, making the
doc-matrix contraction a cosine similarity.  Bitwise the same embedding
as the reference's ``repro/retrieval/dense.py``.

Scoring paths, as in the reference:

* ``scores_np`` / ``topk`` — numpy on the host, one query at a time:
  the serving path (``IndexRetriever.passages``);
* ``topk_batch`` — a batch of queries through the fused score + top-k
  kernel (:mod:`repro_torch.kernels.dense_topk`, K3), which never
  materializes the ``(Q, D)`` score matrix.  The ``(D, E)`` matrix is
  copied to the device once and kept on the index.

The lexical (BM25) and dense views rank differently: BM25 is driven by
exact-term idf weighting, the dense encoder by signed n-gram overlap
including bigram order, which is what makes retriever choice a routing
action (see ``retrieval/hybrid.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.config import RetrievalConfig
from repro_torch.core.device import resolve_device
from repro_torch.data.tokenizer import words, _h
from repro_torch.kernels.dense_topk import dense_topk


def _signed(token: str, dim: int, v: np.ndarray, weight: float) -> None:
    # independent hash bit for the sign (salted so it does not correlate
    # with the bucket index)
    sign = 1.0 if _h(token + "#sgn", 2) else -1.0
    v[_h(token, dim)] += weight * sign


def embed_text(text: str, dim: int) -> np.ndarray:
    """Deterministic signed hashed uni+bigram embedding, L2-normalized."""
    v = np.zeros(dim, np.float32)
    ws = words(text)
    for i, w in enumerate(ws):
        _signed(w, dim, v, 1.0)
        if i + 1 < len(ws):
            _signed(w + "_" + ws[i + 1], dim, v, 0.5)
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


@dataclass
class DenseIndex:
    cfg: RetrievalConfig
    emb: np.ndarray          # (D, E) float32, rows L2-normalized
    texts: List[str]
    # the (D, E) matrix on each device topk_batch ran on
    _on_device: Dict[torch.device, torch.Tensor] = field(
        default_factory=dict, init=False, repr=False, compare=False)

    @classmethod
    def build(cls, docs: Sequence[str],
              cfg: RetrievalConfig = RetrievalConfig()) -> "DenseIndex":
        E = cfg.dense_embed_dim
        emb = np.stack([embed_text(doc, E) for doc in docs]) if docs \
            else np.zeros((0, E), np.float32)
        return cls(cfg, emb.astype(np.float32), list(docs))

    def encode(self, query: str) -> np.ndarray:
        return embed_text(query, self.cfg.dense_embed_dim)

    # ------------------------------------------------------------------
    # scoring
    # ------------------------------------------------------------------
    def scores_np(self, qe: np.ndarray) -> np.ndarray:
        """Numpy cosine scores for one query (E,) -> (D,)."""
        return self.emb @ qe

    def topk(self, query: str, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(indices, scores) of the top-k docs — numpy on the host.

        ``lax.top_k`` semantics including ties: a full (-score, doc id)
        lexsort, so exact-score ties break toward the lower doc id even
        when they straddle the k boundary.
        """
        if k <= 0:
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        s = self.scores_np(self.encode(query))
        k = min(k, len(s))
        idx = np.lexsort((np.arange(len(s)), -s))[:k]
        return idx, s[idx]

    def device_emb(self, device) -> torch.Tensor:
        """The ``(D, E)`` matrix on ``device``, copied there once."""
        dev = resolve_device(device)
        emb = self._on_device.get(dev)
        if emb is None:
            emb = self._on_device[dev] = torch.from_numpy(self.emb).to(dev)
        return emb

    def topk_batch(self, queries: Sequence[str], k: int, *,
                   device="cuda") -> Tuple[np.ndarray, np.ndarray]:
        """Batched top-k through the fused kernel (K3) on ``device``.

        Returns (ids (Q, k) int64, scores (Q, k) float32) as numpy.
        """
        emb = self.device_emb(device)
        qe = torch.from_numpy(
            np.stack([self.encode(q) for q in queries])).to(emb.device)
        s, i = dense_topk(qe, emb, k=min(k, len(self.texts)))
        return i.cpu().numpy().astype(np.int64), s.cpu().numpy()
