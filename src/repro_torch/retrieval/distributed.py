"""Distributed retrieval: the corpus sharded over a mesh's data axis.

An own copy of the reference's ``retrieval/distributed.py`` for SPMD
serving (one process per card, :mod:`repro_torch.launch.mesh`): every
rank holds the whole corpus on the host and puts its block of documents
on its device — shard ``r`` of ``n`` holds documents ``[r * D / n, (r +
1) * D / n)``.  Each shard scores its block and keeps a local top-k; the
candidates, their ids made global, are all-gathered over the axis in
shard order and merged.  The dense shard runs K3 (the fused score +
top-k of :func:`repro_torch.kernels.dense_topk.dense_topk`), the BM25
shard K5 (:func:`repro_torch.kernels.bm25.bm25_scores` over the shard's
nonzeros, normalized by the whole corpus's mean length); on CPU tensors
their plain versions.  Communication per query is O(shards x k) scores
and ids, whatever the corpus size.

Ties: the merge is a stable descending sort of the gathered candidates,
not ``torch.topk`` (whose order among equal scores CUDA does not fix),
so an exact tie goes to the lower global doc id, as ``lax.top_k`` over
the unsharded row gives it; a local top-k breaks ties the same way.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels.bm25 import bm25_scores, compact_tf
from repro_torch.kernels.dense_topk import dense_topk


def _stable_topk(scores: torch.Tensor, k: int):
    """The ``k`` largest of each row, ties to the lower column."""
    s, i = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :k], i[:, :k]


def _axis_size(mesh, axis: str) -> int:
    return dict(zip(mesh.axis_names, mesh.devices.shape))[axis]


def _shard(mesh, axis: str, D: int) -> Tuple[int, int]:
    """``(this rank's first doc, docs a shard)`` of ``D`` docs on
    ``axis``; ``D`` must divide evenly."""
    n = _axis_size(mesh, axis)
    if D % n != 0:
        raise ValueError(f"{D} documents do not split evenly over the "
                         f"{n} shards of mesh axis {axis!r}")
    d_local = D // n
    return mesh.coord(axis) * d_local, d_local


def _merge_local_topk(top_s, top_i, *, k: int, mesh, axis: str,
                      first: int):
    """Local candidates -> global ids -> all-gather -> final top-k.

    The shared merge tail of every sharded retriever: ``top_s`` /
    ``top_i`` (Q, k_local) are this shard's candidates, ``first`` its
    first global doc id.  Candidates gather in shard order, so an exact
    tie resolves to the lowest global doc id."""
    n = _axis_size(mesh, axis)
    group = mesh.group(axis)
    top_i = top_i.to(torch.int64) + first
    all_s = [torch.empty_like(top_s) for _ in range(n)]
    all_i = [torch.empty_like(top_i) for _ in range(n)]
    dist.all_gather(all_s, top_s.contiguous(), group=group)
    dist.all_gather(all_i, top_i.contiguous(), group=group)
    best_s, pos = _stable_topk(torch.cat(all_s, dim=1), k)
    return best_s, torch.gather(torch.cat(all_i, dim=1), 1, pos)


def _scored_topk(scores, *, k: int, mesh, axis: str, first: int):
    """The top-k over every shard from this shard's (Q, D_loc) scores."""
    top_s, top_i = _stable_topk(scores, min(k, scores.shape[1]))
    return _merge_local_topk(top_s, top_i, k=k, mesh=mesh, axis=axis,
                             first=first)


def _dense_topk(emb_loc, qe, *, k: int, mesh, axis: str, first: int):
    """The top-k over every shard from this shard's embeddings: its
    scores and local top-k in one ``dense_topk``."""
    top_s, top_i = dense_topk(qe, emb_loc, k=min(k, emb_loc.shape[0]))
    return _merge_local_topk(top_s, top_i, k=k, mesh=mesh, axis=axis,
                             first=first)


def distributed_topk(mesh, score_fn: Callable, doc_arrays: Sequence,
                     qv: torch.Tensor, *, k: int = 10, axis: str = "data"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a corpus sharded on ``axis`` — any scoring function.

    ``doc_arrays`` are doc-major tensors (leading dim D, the whole
    corpus: each rank takes its block); ``qv`` is the (Q, F) query
    matrix, the same on every rank; ``score_fn(*doc_arrays_local, qv) ->
    (Q, D_loc)`` scores one local shard.  Returns (scores (Q, k), global
    doc ids (Q, k) int64).
    """
    first, d_local = _shard(mesh, axis, doc_arrays[0].shape[0])
    docs = [a[first:first + d_local] for a in doc_arrays]
    return _scored_topk(score_fn(*docs, qv), k=k, mesh=mesh, axis=axis,
                        first=first)


# ---------------------------------------------------------------------------
# BM25
# ---------------------------------------------------------------------------


def distributed_bm25_topk(mesh, tf: torch.Tensor, doc_len: torch.Tensor,
                          qv: torch.Tensor, *, k: int = 10, k1: float = 1.2,
                          b: float = 0.75, axis: str = "data"
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """BM25 top-k over a corpus sharded on ``axis``.

    tf: (D, V) the whole TF matrix; qv: (Q, V) idf-weighted query
    vectors.  Each shard scores its rows through ``bm25_scores`` (K5 on
    the card, which compacts the rows to their nonzeros first) with the
    whole corpus's mean length.  Returns (scores (Q, k), doc_ids (Q, k)).
    """
    avg_len = float(doc_len.float().mean()) + 1e-6
    ones = torch.ones(qv.shape[1], dtype=torch.float32, device=qv.device)
    return distributed_topk(
        mesh, lambda tf_loc, dl_loc, q: bm25_scores(
            q, tf_loc, dl_loc, ones, k1=k1, b=b, avg_len=avg_len),
        (tf, doc_len), qv, k=k, axis=axis)


def distributed_dense_topk(mesh, emb: torch.Tensor, qe: torch.Tensor, *,
                           k: int = 10, axis: str = "data"
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense top-k over a doc-embedding matrix sharded on ``axis``.

    emb: (D, E) doc embeddings, the whole matrix; qe: (Q, E) query
    embeddings.  Each shard's scores and top-k come from one
    ``dense_topk`` (K3 on the card).  Returns (scores (Q, k), doc_ids
    (Q, k)).
    """
    first, d_local = _shard(mesh, axis, emb.shape[0])
    return _dense_topk(emb[first:first + d_local], qe, k=k, mesh=mesh,
                       axis=axis, first=first)


class DistributedBM25:
    """Drop-in scorer over a sharded corpus for the serving pipeline.

    Holds this rank's shard on ``mesh.device``: the nonzeros of its TF
    rows (a :class:`~repro_torch.kernels.bm25.BM25Csr`, compacted once)
    and their lengths, beside the idf and the whole corpus's mean
    length.  ``topk`` takes (Q, V) raw query term counts and returns
    ``(ids, scores)`` — the same order as every other scorer in the
    package (``BM25Index.topk``, ``DenseIndex.topk``, the
    :class:`~repro_torch.retrieval.hybrid.Retriever` protocol).
    """

    def __init__(self, mesh, tf: np.ndarray, doc_len: np.ndarray,
                 idf: np.ndarray, axis: str = "data"):
        self.mesh = mesh
        self.axis = axis
        dev = mesh.device
        self.first, d_local = _shard(mesh, axis, tf.shape[0])
        rows = slice(self.first, self.first + d_local)
        self.tf = compact_tf(torch.from_numpy(
            np.ascontiguousarray(tf[rows], np.float32))).to(dev)
        self.doc_len = torch.from_numpy(
            np.ascontiguousarray(doc_len[rows], np.float32)).to(dev)
        self.avg_len = float(np.float32(np.mean(doc_len, dtype=np.float32))
                             ) + 1e-6
        self.idf = torch.from_numpy(np.asarray(idf, np.float32)).to(dev)

    def topk(self, query_tf: np.ndarray, k: int = 10):
        """query_tf: (Q, V) query term counts -> (global ids, scores)."""
        q = torch.from_numpy(np.asarray(query_tf, np.float32)).to(
            self.mesh.device)
        scores = bm25_scores(q, self.tf, self.doc_len, self.idf,
                             avg_len=self.avg_len)
        s, i = _scored_topk(scores, k=k, mesh=self.mesh, axis=self.axis,
                            first=self.first)
        return i.cpu().numpy(), s.cpu().numpy()


class DistributedDenseIndex:
    """Sharded dense retrieval: this rank's block of doc embeddings on
    ``mesh.device``.

    ``topk`` takes pre-encoded (Q, E) query embeddings and returns
    ``(ids, scores)``, the package-wide scorer order (see
    :class:`DistributedBM25`).
    """

    def __init__(self, mesh, emb: np.ndarray, axis: str = "data"):
        self.mesh = mesh
        self.axis = axis
        self.first, d_local = _shard(mesh, axis, emb.shape[0])
        self.emb = torch.from_numpy(np.ascontiguousarray(
            emb[self.first:self.first + d_local], np.float32)).to(
                mesh.device)

    def topk(self, query_emb: np.ndarray, k: int = 10):
        """query_emb: (Q, E) encoded queries -> (global ids, scores)."""
        q = torch.from_numpy(np.asarray(query_emb, np.float32)).to(
            self.mesh.device)
        s, i = _dense_topk(self.emb, q, k=k, mesh=self.mesh, axis=self.axis,
                           first=self.first)
        return i.cpu().numpy(), s.cpu().numpy()
