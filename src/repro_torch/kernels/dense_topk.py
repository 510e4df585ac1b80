"""Fused dense retrieval: score + top-k without the (Q, D) matrix.

Replaces the TPU kernel ``repro/kernels/dense_topk.py::
_dense_topk_padded`` (body ``_dense_topk_kernel``, merge ``_merge_topk``,
wrapper ``repro/kernels/ops.py::dense_topk``).  On the card it runs the
hand-written CUDA kernel in ``csrc/dense_topk.cu``; the design notes are
at the top of that file.  In short: one launch; a block holds 64 queries
in shared memory and streams its slice of the corpus past them
(:func:`plan`), the score tiles on the tensor cores (wgmma) with
float32 accuracy (three TF32 products per float32 product), each tile
folded into a running top-k per query in registers; after a grid
barrier each query's lists are merged by one block, in the same launch.

* :func:`dense_topk` — the wrapper.  CPU tensors take the plain version;
  CUDA tensors launch the kernel or raise (there is no fallback).
  ``dense_topk.launches`` counts kernel launches (one a call).  The merge
  lists and the barrier's counters live in a per-(device, stream)
  scratch the module keeps (:func:`_scratch`); the kernel leaves the
  counters at zero.
* :func:`dense_topk_torch` — the plain PyTorch version, with the
  semantics of the reference's ``kernels/ref.py::dense_topk_ref``.

Contract: q ``(Q, E)``, docs ``(D, E)``, cast to float32.  ``k <= 0`` or
``D == 0`` gives empty ``(Q, 0)`` outputs; ``k`` clamps to ``D``; any
``Q`` and ``D``.  Returns ``(scores (Q, k) float32 descending, ids (Q, k)
int32)``; exact score ties go to the lower doc id (``lax.top_k`` order).
The plain version takes any ``k`` and ``E``, as the reference's
``ops.dense_topk`` does; the CUDA kernel takes ``k <= 64`` (``MAX_K``,
the reference's deployed bound) and ``E`` a multiple of 4 (16-byte row
copies) up to 768 (``MAX_E``), and the wrapper raises on a CUDA tensor
outside that.  Its scores are within 1e-5 of the plain version's on unit
rows (the same sums, in another order and through TF32 parts).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

MAX_K = 64         # a running top-k of up to 64 entries, 16 a quad lane
MAX_E = 768        # the 64-query tile, 256 E bytes, in shared memory
TILE = 64          # docs per tile (csrc/dense_topk.cu kDT)
QUERY_TILE = 64    # queries per block (kQT)


class Plan(NamedTuple):
    """How one launch cuts the work: ``q_tiles`` tiles of 64 queries,
    each streamed against ``slices`` slices of the doc axis, one block
    per (query tile, slice), all resident at once; after the grid
    barrier query j of a query tile is merged by slice j % slices."""
    q_tiles: int
    slices: int


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


def list_slots(k: int) -> int:
    """Entries of a running list in the kernel: 16, 32 or 64."""
    return 16 if k <= 16 else 32 if k <= 32 else 64


def plan(n_docs: int, n_queries: int, n_sms: int) -> Plan:
    """One block per (query tile, slice), at most one per SM so that the
    grid is resident at once; every slice at least one 64-doc tile."""
    n_tiles = -(-n_docs // TILE)
    q_tiles = -(-n_queries // QUERY_TILE)
    return Plan(q_tiles, max(1, min(n_tiles, n_sms // q_tiles)))


def tile_range(slice_: int, slices: int, n_tiles: int) -> range:
    """The 64-doc tiles of one slice (the kernel's t0, t1)."""
    return range(slice_ * n_tiles // slices,
                 (slice_ + 1) * n_tiles // slices)


def merged_queries(slice_: int, slices: int) -> range:
    """The queries of a query tile whose lists the block of ``slice_``
    merges after the grid barrier (one list from every slice each)."""
    return range(slice_, QUERY_TILE, slices)


def scratch_sizes(p: Plan, k: int) -> int:
    """Entries of the merge lists a launch needs (none for one slice):
    every block's list of each of its 64 queries, ``list_slots(k) + 4``
    entries a row (padded)."""
    if p.slices == 1:
        return 0
    return p.q_tiles * p.slices * QUERY_TILE * (list_slots(k) + 4)


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
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


_num_sms: dict = {}
_scratches: dict = {}


def _scratch(device, stream: int, n_entries: int):
    """The merge's (barrier, list scores, list ids) for launches on
    ``stream``: two int32 counters that every launch leaves zero, and
    lists that every launch writes before it reads them.  Kept per
    (device, stream) -- launches on one stream run in order -- and grown
    when a call needs more."""
    key = (device, stream)
    bar, ls, li = _scratches.get(key, (None, None, None))
    if bar is None:
        bar = torch.zeros(2, dtype=torch.int32, device=device)
    if ls is None or ls.numel() < n_entries:
        ls = torch.empty(n_entries, dtype=torch.float32, device=device)
        li = torch.empty(n_entries, dtype=torch.int32, device=device)
    _scratches[key] = bar, ls, li
    return bar, ls, li


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
    dev = q.device
    if dev not in _num_sms:
        _num_sms[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    p = plan(D, Q, _num_sms[dev])
    out_s, out_i = _empty(q, k)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (None, None, None)
    if p.slices > 1:
        bar, ls, li = _scratch(dev, stream, scratch_sizes(p, k))
        ptrs = (ls.data_ptr(), li.data_ptr(), bar.data_ptr())
    rc = kernel(q.data_ptr(), docs.data_ptr(), *ptrs, out_s.data_ptr(),
                out_i.data_ptr(), Q, D, E, k, p.slices, stream)
    if rc != 0:
        raise RuntimeError(f"dense_topk kernel launch failed: CUDA error {rc}")
    dense_topk.launches += 1
    return out_s, out_i
