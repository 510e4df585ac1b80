"""State representation s(q) — paper §3.3.

A hashed bag-of-words question embedding plus lightweight metadata
(length and uncertainty indicators computed from retrieval scores).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.config import RouterConfig
from repro_torch.data.tokenizer import words, _h
from repro_torch.retrieval.bm25 import BM25Index

WH_WORDS = ("what", "who", "when", "where", "why", "how", "which")


def question_embedding(text: str, dim: int) -> np.ndarray:
    v = np.zeros(dim, np.float32)
    ws = words(text)
    for i, w in enumerate(ws):
        v[_h(w, dim)] += 1.0
        if i + 1 < len(ws):  # bigram channel
            v[_h(w + "_" + ws[i + 1], dim)] += 0.5
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def metadata_features(text: str, index: BM25Index, n: int) -> np.ndarray:
    ws = words(text)
    stats = index.score_stats(text, k=5)          # max, mean, std, gap
    cooc = index.cooccurrence_stats(text, k=5)
    smax = stats[0] + 1e-6
    feats = [
        len(ws) / 20.0,
        len(text) / 120.0,
        float(any(w in WH_WORDS for w in ws)),
        float(ws[0] in WH_WORDS) if ws else 0.0,
        stats[0] / 10.0,
        stats[1] / 10.0,
        stats[2] / 10.0,
        stats[3] / 10.0,
        stats[3] / smax,                           # relative gap
        stats[1] / smax,                           # flatness
        float(len(set(ws)) / max(len(ws), 1)),
        float(sum(1 for w in ws if any(c.isdigit() for c in w))) / 5.0,
        float(cooc[0]), float(cooc[1]), float(cooc[2]), float(cooc[3]),
    ]
    feats = feats[:n] + [0.0] * max(0, n - len(feats))
    return np.asarray(feats, np.float32)


def state_vector(text: str, index: BM25Index, cfg: RouterConfig) -> np.ndarray:
    emb = question_embedding(text, cfg.embed_dim)
    meta = metadata_features(text, index, cfg.n_meta_features)
    return np.concatenate([emb, meta])
