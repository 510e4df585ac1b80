"""Sequence packing: fill fixed-length rows with multiple documents.

Padding wastes FLOPs ∝ (1 − occupancy); packing concatenates documents
(EOS-separated) into full rows and emits a segment-id mask so attention
can optionally be restricted per document.  The LM loss masks the token
after each EOS boundary (no cross-document prediction).  Numpy only: an
own copy of the reference's ``data/packing.py``, rows and masks identical.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Sequence

import numpy as np

from repro_torch.data.tokenizer import EOS, PAD


@dataclass
class PackedBatch:
    tokens: np.ndarray      # (B, S) int32
    labels: np.ndarray      # (B, S) int32, -1 where masked
    segments: np.ndarray    # (B, S) int32 document id per position

    @property
    def occupancy(self) -> float:
        return float((self.tokens != PAD).mean())


def pack_documents(docs: Sequence[List[int]], seq_len: int,
                   batch_size: int) -> Iterator[PackedBatch]:
    """Greedy first-fit packing of token lists into (B, S) rows."""
    rows: List[List[int]] = []
    segs: List[List[int]] = []
    cur: List[int] = []
    cur_seg: List[int] = []
    doc_id = 0
    for doc in docs:
        doc = list(doc) + [EOS]
        while doc:
            space = seq_len - len(cur)
            take, doc = doc[:space], doc[space:]
            cur.extend(take)
            cur_seg.extend([doc_id] * len(take))
            if len(cur) == seq_len:
                rows.append(cur)
                segs.append(cur_seg)
                cur, cur_seg = [], []
        doc_id += 1
    if cur:
        pad = seq_len - len(cur)
        rows.append(cur + [PAD] * pad)
        segs.append(cur_seg + [-1] * pad)

    for s0 in range(0, len(rows) - batch_size + 1, batch_size):
        toks = np.asarray(rows[s0: s0 + batch_size], np.int32)
        seg = np.asarray(segs[s0: s0 + batch_size], np.int32)
        labels = np.full_like(toks, -1)
        labels[:, :-1] = toks[:, 1:]
        # mask: no prediction across document boundaries or into padding
        same_doc = seg[:, :-1] == seg[:, 1:]
        valid = (toks[:, 1:] != PAD) & same_doc
        labels[:, :-1] = np.where(valid, labels[:, :-1], -1)
        labels[:, -1] = -1
        yield PackedBatch(toks, labels, seg)
