"""BM25 scoring of a query batch against the dense term-frequency matrix.

Replaces the TPU kernel ``repro/kernels/bm25.py::bm25_pallas`` (body
``_bm25_kernel``, wrapper ``repro/kernels/ops.py::bm25_scores``).  On
the card the contraction runs in the hand-written CUDA kernel in
``csrc/bm25.cu``; the design notes are at the top of that file.  In
short: a tiled float32 product on CUDA cores with the BM25 saturation
applied as each ``tf`` tile is staged into shared memory.

* :func:`bm25_scores` — the wrapper.  CPU tensors take the plain
  version; CUDA tensors launch the kernel or raise (there is no
  fallback).  ``bm25_scores.launches`` counts kernel launches.
* :func:`bm25_scores_torch` — the plain PyTorch version, with the
  semantics of the reference's ``kernels/ref.py::bm25_ref``.

Contract (that of the reference's ``ops.bm25_scores``): query_tf
``(Q, V)`` term counts, tf ``(D, V)``, doc_len ``(D,)``, idf ``(V,)``.
The prep stays in torch, outside the kernel, as the reference's wrapper
does it: ``avg = doc_len.mean() + 1e-6``,
``norm = k1 * (1 - b + b * doc_len / avg)`` and ``wq = query_tf * idf``.
Returns ``(Q, D)`` float32 scores.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


def _prep(query_tf, doc_len, idf, k1: float, b: float):
    """``(wq (Q, V), norm (D,))`` in float32."""
    avg = doc_len.mean() + 1e-6
    norm = (k1 * (1 - b + b * doc_len / avg)).float()
    wq = (query_tf * idf[None, :]).float()
    return wq, norm


def bm25_scores_torch(query_tf, tf, doc_len, idf, *, k1: float = 1.2,
                      b: float = 0.75):
    """Plain PyTorch version: the saturated ``(D, V)`` matrix, then one
    float32 product."""
    wq, norm = _prep(query_tf, doc_len, idf, k1, b)
    tf = tf.float()
    sat = tf * (k1 + 1.0) / (tf + norm[:, None])
    return wq @ sat.T


def bm25_scores(query_tf, tf, doc_len, idf, *, k1: float = 1.2,
                b: float = 0.75):
    """BM25 scores ``(Q, D)``: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors."""
    if tf.device.type == "cpu":
        return bm25_scores_torch(query_tf, tf, doc_len, idf, k1=k1, b=b)
    if tf.device.type != "cuda":
        raise ValueError(f"bm25_scores: unsupported device {tf.device}")
    _check(query_tf, tf, doc_len, idf)
    kernel = _kernel()
    wq, norm = _prep(query_tf, doc_len, idf, k1, b)
    return _launch(kernel, wq.contiguous(), tf.float().contiguous(),
                   norm.contiguous(), k1)


bm25_scores.launches = 0


def _check(query_tf, tf, doc_len, idf) -> None:
    if (query_tf.dim() != 2 or tf.dim() != 2
            or query_tf.shape[1] != tf.shape[1]
            or doc_len.shape != (tf.shape[0],)
            or idf.shape != (tf.shape[1],)):
        raise ValueError(f"bm25_scores: query_tf {tuple(query_tf.shape)}, "
                         f"tf {tuple(tf.shape)}, doc_len "
                         f"{tuple(doc_len.shape)}, idf {tuple(idf.shape)}: "
                         f"want (Q, V), (D, V), (D,), (V,)")
    for name, t in (("query_tf", query_tf), ("doc_len", doc_len),
                    ("idf", idf)):
        if t.device != tf.device:
            raise ValueError(f"bm25_scores: {name} on {t.device}, tf on "
                             f"{tf.device}")


def _kernel():
    fn = build.load("bm25").bm25_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(kernel, wq, tf, norm, k1: float):
    Q, V = wq.shape
    D = tf.shape[0]
    out = torch.empty((Q, D), dtype=torch.float32, device=tf.device)
    if Q == 0 or D == 0:
        return out
    if V == 0:
        return out.zero_()
    stream = torch.cuda.current_stream(tf.device).cuda_stream
    rc = kernel(wq.data_ptr(), tf.data_ptr(), norm.data_ptr(),
                out.data_ptr(), Q, D, V, k1 + 1.0, stream)
    if rc != 0:
        raise RuntimeError(f"bm25 kernel launch failed: CUDA error {rc}")
    bm25_scores.launches += 1
    return out
