"""Flash-decode: single-query GQA attention over the dense slot cache.

Replaces the TPU kernel ``repro/kernels/flash_decode.py::
flash_decode_pallas`` (body ``_flash_decode_kernel``, wrapper
``repro/kernels/ops.py::flash_decode``).  On the card it runs the
hand-written CUDA kernel in ``csrc/flash_decode.cu``; the design notes
are at the top of that file.  In short: the kernel is bound by the K/V
bytes, ``sum_b lengths[b] * Hkv * D * 2 (K and V) * 2 B / 3.35 TB/s``,
so it reads K/V once, in place in the executor's ``(B, L, Hkv, D)``
layout, never reads the masked tail, and serves all G query heads of a
kv head from one fetch of each row.

* :func:`flash_decode` — the wrapper.  CPU tensors take the plain
  version; CUDA tensors launch the kernel or raise (there is no
  fallback).  ``flash_decode.launches`` counts kernel launches.
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
HEAD_DIMS = (64, 128)
MAX_GROUP = 8          # query heads per kv head the kernel instantiates


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
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, lengths):
    _check(q, k, v, lengths)
    kernel = _kernel()
    B, H, D = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), B, H, Hkv, L, D, q.stride(0), q.stride(1),
                k.stride(0), k.stride(1), k.stride(2), v.stride(0),
                v.stride(1), v.stride(2), out.stride(0), out.stride(1),
                1.0 / D ** 0.5, stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{rc}")
    flash_decode.launches += 1
    return out
