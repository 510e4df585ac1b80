"""Flash-decode: single-query GQA attention over the dense slot cache.

Replaces the TPU kernel ``repro/kernels/flash_decode.py::
flash_decode_pallas`` (body ``_flash_decode_kernel``, wrapper
``repro/kernels/ops.py::flash_decode``).  On the card it runs the
hand-written CUDA kernel in ``csrc/flash_decode.cu``; the design notes
are at the top of that file.  In short: the kernel is bound by the K/V
bytes, ``sum_b lengths[b] * Hkv * D * 2 (K and V) * 2 B / 3.35 TB/s``,
so it reads K/V once, in place in the executor's ``(B, L, Hkv, D)``
layout, never reads the masked tail, serves all G query heads of a kv
head from one fetch of each row (on the tensor cores), keeps tiles in
flight through a ``cp.async`` ring a warp, and splits a slot longer
than ``MAX_PARTITION_ROWS`` into :func:`partitions`, one block each,
merged in the same launch by the last block to finish; blocks are wide
or narrow by :func:`wide_blocks`.  Both depend on shapes alone, never on
``lengths``, so the decode path stays free of host syncs.  The choices
and their times on the card: ``scripts/flash_decode_sweep.py``.

* :func:`flash_decode` — the wrapper.  CPU tensors take the plain
  version; CUDA tensors launch the kernel or raise (there is no
  fallback).  ``flash_decode.launches`` counts kernel launches (one a
  call).  The partials and tickets of the merge live in a per-(device,
  stream) scratch the module keeps (:func:`_scratch`, shared with the
  paged kernel); the kernel leaves the tickets at zero.
* :func:`flash_decode_torch` — the plain PyTorch version, with the
  semantics of the reference's ``kernels/ref.py::flash_decode_ref``.

Contract (that of the reference's ``ops.flash_decode``): q ``(B, H, D)``;
k/v ``(B, L, Hkv, D)``; lengths ``(B,)`` int32 valid kv entries per
slot, clamped to ``[1, L]``.  Returns ``(B, H, D)`` in q's dtype.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (64, 96, 128, 256)
MAX_GROUP = 8          # query heads per kv head the kernel takes
TILE_ROWS = 16         # rows of a tensor-core tile; runs are whole tiles
MAX_PARTITION_ROWS = 512  # split until no block walks more rows than this
MAX_PARTITIONS = 256   # the kernel's bound (its merge walks them all)


def partitions(L: int) -> tuple:
    """``(parts, part_rows)`` of the dense kernel: each (slot, kv head) is
    cut into ``min(ceil(L / MAX_PARTITION_ROWS), MAX_PARTITIONS)`` runs
    of whole tiles, one block each; ``(parts - 1) * part_rows < L <=
    parts * part_rows``.  A function of the cache's length alone --
    never of ``lengths``, which live on the card -- so a decode step
    picks it without a host sync.  Slots are not split to fill idle
    SMs: at the served lengths the merge costs more than the shorter
    walk saves.  A run that starts past a slot's length costs the card
    an empty block."""
    tiles = -(-L // TILE_ROWS)
    per = -(-tiles // min(-(-L // MAX_PARTITION_ROWS), MAX_PARTITIONS))
    return -(-tiles // per), per * TILE_ROWS


def wide_blocks(B: int, Hkv: int, parts: int, num_sms: int, D: int) -> bool:
    """Whether the kernel's blocks take 8 warps (else 4): where the grid
    has a block an SM or fewer, or a block walks a split run
    (``MAX_PARTITION_ROWS`` rows), more warps share a block's tiles; a
    larger grid takes narrow blocks, so that three fit an SM at once.
    At head dim 256 every block is narrow: 8 warps' rings of two 16-row
    K + V tiles would take 256 KB of shared memory, over a block's 227."""
    return D <= 128 and (parts > 1 or B * Hkv <= num_sms)


def flash_decode_torch(q, k, v, lengths):
    """Plain PyTorch version: float32 masked softmax over the whole row."""
    B, H, D = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bjgd,bljd->bjgl", qg, k.float()) / (D ** 0.5)
    n = lengths.clamp(min=1)
    valid = torch.arange(L, device=q.device)[None, :] < n[:, None]  # (B, L)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bjgl,bljd->bjgd", p, v.float())
    return out.reshape(B, H, v.shape[-1]).to(q.dtype)


def flash_decode(q, k, v, lengths):
    """Decode attention: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return flash_decode_torch(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    return _launch(q, k, v, lengths)


flash_decode.launches = 0


def _check(q, k, v, lengths) -> None:
    B, H, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: want q "
                         f"(B, H, D) and k, v (B, L, Hkv, D)")
    Hkv = k.shape[2]
    if H % Hkv or H // Hkv > MAX_GROUP:
        raise ValueError(f"flash_decode: H={H}, Hkv={Hkv}: the kernel takes "
                         f"H = G * Hkv with G <= {MAX_GROUP}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head_dim {D} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_decode: {name} is {t.dtype}; the kernel "
                            f"takes bfloat16")
        if t.device != q.device:
            raise ValueError(f"flash_decode: {name} on {t.device}, q on "
                             f"{q.device}")
        # 16-byte vector loads: unit last stride, rows 8-element aligned
        if (t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1])
                or t.data_ptr() % 16):
            raise ValueError(f"flash_decode: {name} strides {t.stride()} / "
                             f"alignment do not allow 16-byte row loads")
    if (lengths.dtype != torch.int32 or lengths.shape != (B,)
            or lengths.device != q.device or not lengths.is_contiguous()):
        raise ValueError("flash_decode: lengths must be a contiguous (B,) "
                         "int32 tensor on q's device")


def _kernel():
    fn = build.load("flash_decode").flash_decode_bf16
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_longlong] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


_num_sms: dict = {}
_scratches: dict = {}


def _sm_count(dev) -> int:
    if dev not in _num_sms:
        _num_sms[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _num_sms[dev]


def _scratch(device, stream: int, n_tickets: int, n_floats: int):
    """The merge's (tickets, partials) for launches on ``stream``: int32
    zeros that every launch leaves zero, and float32 partials that every
    launch writes before it reads them.  Kept per (device, stream) --
    launches on one stream run in order, K1's and K2's alike -- and
    grown when a call needs more."""
    key = (device, stream)
    tickets, part = _scratches.get(key, (None, None))
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=device)
    if part is None or part.numel() < n_floats:
        part = torch.empty(n_floats, dtype=torch.float32, device=device)
    _scratches[key] = tickets, part
    return tickets, part


def _launch(q, k, v, lengths):
    _check(q, k, v, lengths)
    B, H, D = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    dev = q.device
    sms = _sm_count(dev)
    parts, part_rows = partitions(L)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = (_scratch(dev, stream, B * Hkv, B * H * parts * (D + 2))
               if parts > 1 else None)
    out = torch.empty((B, H, D), dtype=q.dtype, device=dev)
    kernel = _kernel()
    tickets_ptr, part_ptr = ((scratch[0].data_ptr(), scratch[1].data_ptr())
                             if scratch else (None, None))
    rc = kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), part_ptr, tickets_ptr, B, H, Hkv, L, D,
                parts, part_rows, wide_blocks(B, Hkv, parts, sms, D),
                q.stride(0), q.stride(1), k.stride(0),
                k.stride(1), k.stride(2), v.stride(0), v.stride(1),
                v.stride(2), out.stride(0), out.stride(1), 1.0 / D ** 0.5,
                stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{rc}")
    flash_decode.launches += 1
    return out
