"""Paged flash-decode: single-query GQA attention through a block table.

Replaces the TPU kernel ``repro/kernels/flash_decode.py::
paged_flash_decode_pallas`` (body ``_paged_flash_decode_kernel``, wrapper
``repro/kernels/ops.py::paged_flash_decode``).  On the card it runs the
hand-written CUDA kernel in ``csrc/paged_flash_decode.cu``; the design
notes are at the top of that file.  Bound by the K/V bytes of the valid
rows, like the dense kernel; so the kernel keeps several pages in
flight per block (a ``cp.async`` ring in shared memory, with the block's
table entries staged there once), hands its blocks the longest slots
first, and splits each (slot, kv head) into :func:`partitions`, one
block each, merged in the same launch by the last block to finish.  The
count depends on shapes alone, never on ``lengths``, so the decode path
stays free of host syncs.

* :func:`paged_flash_decode` — the wrapper.  CPU tensors take the plain
  version; CUDA tensors launch the kernel or raise (there is no
  fallback).  ``paged_flash_decode.launches`` counts kernel launches
  (one a call).  The partials and tickets of the merge live in a
  per-(device, stream) scratch the module keeps (:func:`_scratch`); the
  kernel leaves the tickets at zero.
* :func:`paged_flash_decode_torch` — the plain PyTorch version, with the
  semantics of the reference's ``kernels/ref.py::paged_flash_decode_ref``
  plus the clamps of its ``ops.paged_flash_decode``.

Contract: q ``(B, H, D)``; k/v pages ``(num_pages, page_size, Hkv, D)``,
the executor's pool layout, read in place; table ``(B, max_blocks)``
int32, entries clamped into ``[0, num_pages - 1]``; lengths ``(B,)``
int32, clamped to ``[1, max_blocks * page_size]`` (an idle slot parks
one past that).  Returns ``(B, H, D)`` in q's dtype.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode import (HEAD_DIMS, MAX_GROUP,
                                              flash_decode_torch)

BLOCKS_PER_SM = 2          # split until the card has this many blocks an SM
MAX_PARTITION_ROWS = 512   # and until no block can walk more rows than this
MIN_PARTITION_ROWS = 64    # but no partition shorter (the merge has a cost)
MAX_PARTITIONS = 256       # the kernel's bound (its merge weights)


def partitions(max_blocks: int, page_size: int, B: int, Hkv: int,
               num_sms: int) -> tuple:
    """``(parts, part_pages)``: each (slot, kv head) is cut into ``parts``
    runs of ``part_pages`` table entries, one block each.  A function of
    shapes only -- never of the lengths, which live on the card -- so the
    decode path picks it without a host sync.  Splits until the grid has
    ``BLOCKS_PER_SM * num_sms`` blocks and no run is longer than
    ``MAX_PARTITION_ROWS`` rows (a slot may be as long as the table), with
    no run shorter than ``MIN_PARTITION_ROWS`` rows (unless the table is)
    and none empty of table entries.  Each split past one adds the
    merge's few microseconds, so a grid that already fills the card with
    tables of at most ``MAX_PARTITION_ROWS`` rows is not split."""
    want = max(-(-BLOCKS_PER_SM * num_sms // (B * Hkv)),
               -(-max_blocks * page_size // MAX_PARTITION_ROWS))
    most = max(1, min(max_blocks * page_size // MIN_PARTITION_ROWS,
                      MAX_PARTITIONS))
    part_pages = -(-max_blocks // max(1, min(want, most, max_blocks)))
    return -(-max_blocks // part_pages), part_pages


def paged_flash_decode_torch(q, k_pages, v_pages, table, lengths):
    """Plain PyTorch version: gather the table's pages into a contiguous
    row, then the dense plain version over it."""
    NP, ps = k_pages.shape[:2]
    B, MB = table.shape
    tab = table.long().clamp(0, NP - 1)
    k = k_pages[tab].reshape(B, MB * ps, *k_pages.shape[2:])
    v = v_pages[tab].reshape(B, MB * ps, *v_pages.shape[2:])
    return flash_decode_torch(q, k, v, lengths.clamp(max=MB * ps))


def paged_flash_decode(q, k_pages, v_pages, table, lengths):
    """Paged decode attention: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return paged_flash_decode_torch(q, k_pages, v_pages, table, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode: unsupported device {q.device}")
    return _launch(q, k_pages, v_pages, table, lengths)


paged_flash_decode.launches = 0


def _check(q, kp, vp, table, lengths) -> None:
    B, H, D = q.shape
    if kp.dim() != 4 or kp.shape != vp.shape or kp.shape[3] != D:
        raise ValueError(f"paged_flash_decode: q {tuple(q.shape)}, k_pages "
                         f"{tuple(kp.shape)}, v_pages {tuple(vp.shape)}: want "
                         f"q (B, H, D) and pools (num_pages, ps, Hkv, D)")
    Hkv = kp.shape[2]
    if H % Hkv or H // Hkv > MAX_GROUP:
        raise ValueError(f"paged_flash_decode: H={H}, Hkv={Hkv}: the kernel "
                         f"takes H = G * Hkv with G <= {MAX_GROUP}")
    if D not in HEAD_DIMS:
        raise ValueError(f"paged_flash_decode: head_dim {D} not in "
                         f"{HEAD_DIMS}")
    for name, t in (("q", q), ("k_pages", kp), ("v_pages", vp)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"paged_flash_decode: {name} is {t.dtype}; the "
                            f"kernel takes bfloat16")
        if t.device != q.device:
            raise ValueError(f"paged_flash_decode: {name} on {t.device}, q "
                             f"on {q.device}")
        # 16-byte vector loads: unit last stride, rows 8-element aligned
        if (t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1])
                or t.data_ptr() % 16):
            raise ValueError(f"paged_flash_decode: {name} strides "
                             f"{t.stride()} / alignment do not allow "
                             f"16-byte row loads")
    if (table.dtype != torch.int32 or table.dim() != 2
            or table.shape[0] != B or table.device != q.device
            or table.stride(1) != 1):
        raise ValueError("paged_flash_decode: table must be a (B, max_blocks) "
                         "int32 tensor on q's device with unit stride along "
                         "blocks")
    if (lengths.dtype != torch.int32 or lengths.shape != (B,)
            or lengths.device != q.device or not lengths.is_contiguous()):
        raise ValueError("paged_flash_decode: lengths must be a contiguous "
                         "(B,) int32 tensor on q's device")


def _kernel():
    fn = build.load("paged_flash_decode").paged_flash_decode_bf16
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                       + [ctypes.c_longlong] * 11
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


_num_sms: dict = {}
_scratches: dict = {}


def _scratch(device, stream: int, n_tickets: int, n_floats: int):
    """The merge's (tickets, partials) for launches on ``stream``: int32
    zeros that every launch leaves zero, and float32 partials that every
    launch writes before it reads them.  Kept per (device, stream) --
    launches on one stream run in order -- and grown when a call needs
    more."""
    key = (device, stream)
    tickets, part = _scratches.get(key, (None, None))
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=device)
    if part is None or part.numel() < n_floats:
        part = torch.empty(n_floats, dtype=torch.float32, device=device)
    _scratches[key] = tickets, part
    return tickets, part


def _launch(q, kp, vp, table, lengths):
    _check(q, kp, vp, table, lengths)
    kernel = _kernel()
    B, H, D = q.shape
    NP, ps, Hkv = kp.shape[:3]
    MB = table.shape[1]
    dev = q.device
    if dev not in _num_sms:
        _num_sms[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    parts, part_pages = partitions(MB, ps, B, Hkv, _num_sms[dev])
    out = torch.empty((B, H, D), dtype=q.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    part_ptr = tickets_ptr = None
    if parts > 1:
        tickets, part = _scratch(dev, stream, B * Hkv,
                                 B * H * parts * (D + 2))
        part_ptr, tickets_ptr = part.data_ptr(), tickets.data_ptr()
    rc = kernel(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), part_ptr, tickets_ptr,
                B, H, Hkv, NP, ps, MB, D, parts, part_pages, q.stride(0),
                q.stride(1), kp.stride(0), kp.stride(1), kp.stride(2),
                vp.stride(0), vp.stride(1), vp.stride(2), table.stride(0),
                out.stride(0), out.stride(1),
                1.0 / D ** 0.5, stream)
    if rc != 0:
        raise RuntimeError(f"paged_flash_decode kernel launch failed: CUDA "
                           f"error {rc}")
    paged_flash_decode.launches += 1
    return out
