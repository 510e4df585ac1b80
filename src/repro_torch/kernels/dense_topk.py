"""Fused dense retrieval: score + top-k without the (Q, D) matrix.

Replaces the TPU kernel ``repro/kernels/dense_topk.py::
_dense_topk_padded`` (body ``_dense_topk_kernel``, merge ``_merge_topk``,
wrapper ``repro/kernels/ops.py::dense_topk``).  On the card it runs the
hand-written CUDA kernel in ``csrc/dense_topk.cu``; the design notes are
at the top of that file.  In short: a block holds 64 queries in shared
memory and streams its split of the corpus past them, folding each
score tile into a running top-k per query; a second pass merges the
splits' partial top-k lists.

* :func:`dense_topk` — the wrapper.  CPU tensors take the plain version;
  CUDA tensors launch the kernel or raise (there is no fallback).
  ``dense_topk.launches`` counts kernel launches.
* :func:`dense_topk_torch` — the plain PyTorch version, with the
  semantics of the reference's ``kernels/ref.py::dense_topk_ref``.

Contract: q ``(Q, E)``, docs ``(D, E)``, cast to float32.  ``k <= 0`` or
``D == 0`` gives empty ``(Q, 0)`` outputs; ``k`` clamps to ``D``; any
``Q`` and ``D``.  Returns ``(scores (Q, k) float32 descending, ids (Q, k)
int32)``; exact score ties go to the lower doc id (``lax.top_k`` order).
The plain version takes any ``k`` and ``E``, as the reference's
``ops.dense_topk`` does; the CUDA kernel is narrower: ``k <= 32``
(``MAX_K``) and ``E`` a multiple of 4 up to 768 (``MAX_E``), and the
wrapper raises on a CUDA tensor outside that.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_K = 32             # one warp holds a running top-k, one entry a lane
MAX_E = 768            # the query tile, E * 256 bytes, in shared memory
TILE = 64              # docs per tile (csrc/fp32_tile.cuh kTile)
BLOCKS_PER_SM = 2      # splits of the doc axis aim at this many blocks


def _empty(q, k):
    return (torch.empty((q.shape[0], k), dtype=torch.float32,
                        device=q.device),
            torch.empty((q.shape[0], k), dtype=torch.int32,
                        device=q.device))


def dense_topk_torch(q, docs, *, k: int):
    """Plain PyTorch version: the full float32 ``q @ docs.T``, then a
    stable descending sort (the lower id first on a tie, which
    ``torch.topk`` does not promise)."""
    if k <= 0 or docs.shape[0] == 0:
        return _empty(q, 0)
    k = min(k, docs.shape[0])
    s = q.float() @ docs.float().T
    vals, idx = torch.sort(s, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32)


def dense_topk(q, docs, *, k: int):
    """Dense top-k: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors."""
    if q.device.type == "cpu":
        return dense_topk_torch(q, docs, k=k)
    if q.device.type != "cuda":
        raise ValueError(f"dense_topk: unsupported device {q.device}")
    if k <= 0 or docs.shape[0] == 0:
        return _empty(q, 0)
    return _launch(q, docs, min(k, docs.shape[0]))


dense_topk.launches = 0


def _check(q, docs, k: int) -> None:
    if q.dim() != 2 or docs.dim() != 2 or q.shape[1] != docs.shape[1]:
        raise ValueError(f"dense_topk: q {tuple(q.shape)}, docs "
                         f"{tuple(docs.shape)}: want (Q, E) and (D, E)")
    if docs.device != q.device:
        raise ValueError(f"dense_topk: docs on {docs.device}, q on "
                         f"{q.device}")
    if k > MAX_K:
        raise ValueError(f"dense_topk: k={k}; the kernel takes k <= {MAX_K}")
    if q.shape[1] % 4 or not 0 < q.shape[1] <= MAX_E:
        raise ValueError(f"dense_topk: embedding width {q.shape[1]}; the "
                         f"kernel takes a multiple of 4 (16-byte row loads) "
                         f"up to {MAX_E}")


def _kernel():
    lib = build.load("dense_topk")
    fn = lib.dense_topk_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def splits(n_docs: int, n_queries: int, n_sms: int):
    """``(tiles_per_split, S)``: the doc axis cut into 64-doc tiles,
    grouped into S splits so that about ``BLOCKS_PER_SM`` blocks of
    (query tile, split) run on each SM."""
    n_tiles = -(-n_docs // TILE)
    q_tiles = -(-n_queries // TILE)
    want = max(1, BLOCKS_PER_SM * n_sms // q_tiles)
    per = -(-n_tiles // min(want, n_tiles))
    return per, -(-n_tiles // per)


def _launch(q, docs, k: int):
    _check(q, docs, k)
    kernel = _kernel()
    q = q.float().contiguous()
    docs = docs.float().contiguous()
    Q, E = q.shape
    D = docs.shape[0]
    if Q == 0:
        return _empty(q, k)
    if q.data_ptr() % 16 or docs.data_ptr() % 16:
        raise ValueError("dense_topk: q and docs must start 16-byte aligned")
    per, S = splits(D, Q, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    part_s = torch.empty((Q, S, k), dtype=torch.float32, device=q.device)
    part_i = torch.empty((Q, S, k), dtype=torch.int32, device=q.device)
    out_s, out_i = _empty(q, k)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = kernel(q.data_ptr(), docs.data_ptr(), part_s.data_ptr(),
                part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), Q, D,
                E, k, per, S, stream)
    if rc != 0:
        raise RuntimeError(f"dense_topk kernel launch failed: CUDA error {rc}")
    dense_topk.launches += 1
    return out_s, out_i
