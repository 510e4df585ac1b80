"""BM25 scoring of a query batch against the term frequencies of a corpus.

Replaces the TPU kernel ``repro/kernels/bm25.py::bm25_pallas`` (body
``_bm25_kernel``, wrapper ``repro/kernels/ops.py::bm25_scores``).  The
reference reads the dense ``(D, V)`` term-frequency matrix; on the card
the hand-written CUDA kernel in ``csrc/bm25.cu`` reads only its
nonzeros, held in a :class:`BM25Csr` (the reference's own note: "on GPU
this is typically a sparse gather over an inverted index").  The design
notes are at the top of that file.

* :func:`compact_tf` — the dense ``(D, V)`` matrix to a :class:`BM25Csr`
  (only the zeros are dropped: the raw counts stay, and the saturation
  stays in the scored function).
* :func:`bm25_scores` — the wrapper.  CPU tensors take the plain
  version; CUDA tensors launch the kernel or raise (there is no
  fallback).  ``bm25_scores.launches`` counts kernel launches.
* :func:`bm25_scores_torch` — the plain PyTorch version, with the
  semantics of the reference's ``kernels/ref.py::bm25_ref``, for either
  form of ``tf``.

Contract (that of the reference's ``ops.bm25_scores``): query_tf
``(Q, V)`` term counts, tf ``(D, V)`` (dense, or a :class:`BM25Csr` of
that shape), doc_len ``(D,)``, idf ``(V,)``.  The prep stays in torch,
outside the kernel, as the reference's wrapper does it:
``avg = doc_len.mean() + 1e-6``, ``norm = k1 * (1 - b + b * doc_len /
avg)`` and ``wq = query_tf * idf``.  A shard of a corpus passes the
whole corpus's ``avg_len=`` (the reference's distributed BM25 does: its
``retrieval/distributed.py`` normalizes every shard by the global mean
plus 1e-6).  Returns ``(Q, D)`` float32 scores.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels import build


@dataclass(frozen=True)
class BM25Csr:
    """The nonzeros of a ``(D, V)`` term-frequency matrix, row by row:
    row ``d`` holds ``cols[row_ptr[d]:row_ptr[d + 1]]`` (ascending) with
    the raw counts ``vals`` at the same positions."""
    row_ptr: torch.Tensor   # (D + 1,) int32
    cols: torch.Tensor      # (nnz,) int32
    vals: torch.Tensor      # (nnz,) float32
    shape: Tuple[int, int]  # (D, V)

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def to(self, device) -> "BM25Csr":
        return BM25Csr(self.row_ptr.to(device), self.cols.to(device),
                       self.vals.to(device), self.shape)


def compact_tf(tf: torch.Tensor) -> BM25Csr:
    """The nonzeros of a dense ``(D, V)`` ``tf``, on its device.  Sizing
    the result reads the nonzero count back to the host: on the card
    this syncs once."""
    if tf.dim() != 2:
        raise ValueError(f"compact_tf: tf {tuple(tf.shape)}, want (D, V)")
    D, V = tf.shape
    if tf.numel() >= 2 ** 31:
        raise ValueError(f"compact_tf: tf {tuple(tf.shape)} exceeds the "
                         f"int32 indices")
    mask = tf != 0
    row_ptr = torch.zeros(D + 1, dtype=torch.int32, device=tf.device)
    row_ptr[1:] = mask.sum(1).cumsum(0)
    # nonzero() walks in row-major order: rows ascending, then columns
    cols = mask.nonzero()[:, 1].to(torch.int32)
    return BM25Csr(row_ptr, cols, tf[mask].float(), (D, V))


def _norm(doc_len, k1: float, b: float, avg_len=None):
    """``norm (D,)`` in float32, over ``avg_len`` (default: the mean of
    ``doc_len`` + 1e-6)."""
    avg = doc_len.mean() + 1e-6 if avg_len is None else avg_len
    return (k1 * (1 - b + b * doc_len / avg)).float()


def _prep(query_tf, doc_len, idf, k1: float, b: float, avg_len=None):
    """``(wq (Q, V), norm (D,))`` in float32."""
    return ((query_tf * idf[None, :]).float(),
            _norm(doc_len, k1, b, avg_len))


def _kernel_prep(query_tf, doc_len, idf, k1: float, b: float,
                 avg_len=None):
    """The kernel's inputs beside the index: ``wqT (V, Q)``, so that a
    term's weights for every query lie together, the ``(V,)`` byte flag
    ``used[v] = any_q wq[q, v] != 0`` (bool, one byte) and ``norm (D,)``.
    ``wqT`` is the product of ``_prep``'s ``wq``, written transposed in
    one pass, and ``used`` one reduction of it.  Tensor ops only: no read
    back to the host."""
    wqT = torch.empty((query_tf.shape[1], query_tf.shape[0]),
                      dtype=torch.float32, device=query_tf.device)
    torch.mul(query_tf.t(), idf[:, None], out=wqT)
    return wqT, torch.any(wqT, 1), _norm(doc_len, k1, b,
                                         avg_len).contiguous()


def _csr_rows(csr: BM25Csr) -> torch.Tensor:
    """The row of every nonzero, ``(nnz,)`` int64, with no host sync."""
    D = csr.shape[0]
    return torch.repeat_interleave(
        torch.arange(D, device=csr.device), csr.row_ptr.diff(),
        output_size=csr.vals.numel())


def bm25_scores_torch(query_tf, tf, doc_len, idf, *, k1: float = 1.2,
                      b: float = 0.75, avg_len=None):
    """Plain PyTorch version.  Dense ``tf``: the saturated ``(D, V)``
    matrix, then one float32 product.  :class:`BM25Csr`: the saturation
    of each nonzero, times the queries' weights of its term, summed into
    its document with ``index_add_`` in the order of the nonzeros."""
    wq, norm = _prep(query_tf, doc_len, idf, k1, b, avg_len)
    if isinstance(tf, BM25Csr):
        rows = _csr_rows(tf)
        vals = tf.vals.float()
        sat = vals * (k1 + 1.0) / (vals + norm[rows])
        out = torch.zeros((wq.shape[0], tf.shape[0]), dtype=torch.float32,
                          device=wq.device)
        return out.index_add_(1, rows, wq[:, tf.cols.long()] * sat)
    tf = tf.float()
    sat = tf * (k1 + 1.0) / (tf + norm[:, None])
    return wq @ sat.T


def bm25_scores(query_tf, tf, doc_len, idf, *, k1: float = 1.2,
                b: float = 0.75, avg_len=None):
    """BM25 scores ``(Q, D)``: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors.  ``tf`` is a dense ``(D, V)`` tensor or
    a :class:`BM25Csr`.  On the card a :class:`BM25Csr` is scored with
    no host sync; a dense ``tf`` is compacted first (:func:`compact_tf`),
    which syncs once to size the index."""
    if tf.device.type == "cpu":
        return bm25_scores_torch(query_tf, tf, doc_len, idf, k1=k1, b=b,
                                 avg_len=avg_len)
    if tf.device.type != "cuda":
        raise ValueError(f"bm25_scores: unsupported device {tf.device}")
    _check(query_tf, tf, doc_len, idf)
    kernel = _kernel()
    if not isinstance(tf, BM25Csr):
        tf = compact_tf(tf)
    wqT, used, norm = _kernel_prep(query_tf, doc_len, idf, k1, b, avg_len)
    return _launch(kernel, wqT, used, tf, norm, k1)


bm25_scores.launches = 0


def _check(query_tf, tf, doc_len, idf) -> None:
    D, V = tf.shape if len(tf.shape) == 2 else (-1, -1)
    if (query_tf.dim() != 2 or D < 0 or query_tf.shape[1] != V
            or tuple(doc_len.shape) != (D,) or tuple(idf.shape) != (V,)):
        raise ValueError(f"bm25_scores: query_tf {tuple(query_tf.shape)}, "
                         f"tf {tuple(tf.shape)}, doc_len "
                         f"{tuple(doc_len.shape)}, idf {tuple(idf.shape)}: "
                         f"want (Q, V), (D, V), (D,), (V,)")
    tensors = [("query_tf", query_tf), ("doc_len", doc_len), ("idf", idf)]
    if isinstance(tf, BM25Csr):
        if (tf.row_ptr.dtype != torch.int32 or tf.cols.dtype != torch.int32
                or tf.vals.dtype != torch.float32
                or tuple(tf.row_ptr.shape) != (D + 1,)
                or tf.cols.shape != tf.vals.shape or tf.vals.dim() != 1):
            raise ValueError("bm25_scores: BM25Csr wants int32 row_ptr "
                             "(D + 1,), int32 cols and float32 vals (nnz,)")
        tensors += [("row_ptr", tf.row_ptr), ("cols", tf.cols)]
    for name, t in tensors:
        if t.device != tf.device:
            raise ValueError(f"bm25_scores: {name} on {t.device}, tf on "
                             f"{tf.device}")


def _kernel():
    fn = build.load("bm25").bm25_csr_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(kernel, wqT, used, csr: BM25Csr, norm, k1: float):
    V, Q = wqT.shape
    D = csr.shape[0]
    out = torch.empty((Q, D), dtype=torch.float32, device=csr.device)
    if Q == 0 or D == 0:
        return out
    row_ptr, cols, vals = (t.contiguous() for t in
                           (csr.row_ptr, csr.cols, csr.vals))
    stream = torch.cuda.current_stream(csr.device).cuda_stream
    rc = kernel(row_ptr.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                norm.data_ptr(), wqT.data_ptr(), used.data_ptr(),
                out.data_ptr(), Q, D, k1 + 1.0, stream)
    if rc != 0:
        raise RuntimeError(f"bm25 kernel launch failed: CUDA error {rc}")
    bm25_scores.launches += 1
    return out
