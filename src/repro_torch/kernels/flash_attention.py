"""Flash attention: blocked online-softmax GQA attention over a whole
sequence, causal or not (the no-cache forward of a layer).

Replaces the TPU kernel ``repro/kernels/flash_attention.py::
flash_attention_pallas`` (body ``_flash_kernel``, wrapper
``repro/kernels/ops.py::flash_attention``).  On the card it runs the
hand-written CUDA kernel in ``csrc/flash_attention.cu``; the design notes
are at the top of that file.  In short: Q, K and V are read in place in
the model's ``(B, S, H, D)`` layout through TMA tensor maps (no
transpose, no GQA copy) by a producer warpgroup, and two consumer
warpgroups run both products by ``wgmma`` with the softmax in registers;
a persistent grid walks the (q tile, head) items head by head; under
``causal`` the kv loop stops at the diagonal tile.  Head dims 64, 96
(a zero-padded 128-column tile), 128 and 256 (64-row kv tiles).

* :func:`flash_attention` — the wrapper.  CPU tensors take the plain
  version; CUDA tensors launch the kernel or raise (there is no
  fallback).  ``flash_attention.launches`` counts kernel launches.
* :func:`flash_attention_torch` — the plain PyTorch version, with the
  semantics of the reference's ``kernels/ref.py::flash_attention_ref``.

Contract (that of the reference's ``ops.flash_attention``): q
``(B, Sq, H, D)``, k/v ``(B, Skv, Hkv, D[v])``, query head ``h`` reading
kv head ``h // (H // Hkv)``; returns ``(B, Sq, H, Dv)`` in q's dtype.

Neither has a gradient, as the reference's Pallas kernel has none: the
wrapper raises when autograd would need one, so it can never cut the
graph silently (training would then see a zero gradient for the
attention weights) and the plain version never becomes a trainable
path the reference lacks.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (64, 96, 128, 256)


def flash_attention_torch(q, k, v, *, causal: bool = True):
    """Plain PyTorch version: float32 scores scaled by ``1/sqrt(D)``, the
    causal mask by index (``NEG_INF``), softmax, then PV in float32."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.float().reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqjgd,bkjd->bjgqk", qg, k.float()) * (1.0 / D ** 0.5)
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Skv, device=q.device)[None, :])
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bjgqk,bkjd->bqjgd", p, v.float())
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True):
    """Attention without a cache: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors.  Raises if a gradient would be needed."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no gradient (neither has the reference's "
            "Pallas kernel): call it under torch.no_grad(), or train with "
            "use_pallas_attention=False")
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(q, k, v, causal)


flash_attention.launches = 0


def _check(q, k, v) -> None:
    B, Sq, H, D = q.shape
    if (k.dim() != 4 or k.shape != v.shape or k.shape[0] != B
            or k.shape[3] != D):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: want q "
                         f"(B, Sq, H, D) and k, v (B, Skv, Hkv, D)")
    Hkv = k.shape[2]
    if H % Hkv:
        raise ValueError(f"flash_attention: H={H} is not a multiple of "
                         f"Hkv={Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in "
                         f"{HEAD_DIMS}")
    if Sq == 0 or k.shape[1] == 0:
        raise ValueError("flash_attention: empty sequence")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention: {name} is {t.dtype}; the "
                            f"kernel takes bfloat16")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        # TMA: unit last stride, the other strides and the base 16-byte
        # aligned
        if (t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1])
                or t.data_ptr() % 16):
            raise ValueError(f"flash_attention: {name} strides {t.stride()} "
                             f"/ alignment do not allow TMA copies (16-byte "
                             f"aligned base and strides)")


def _kernel():
    fn = build.load("flash_attention").flash_attention_bf16
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _args(q, k, v, out, causal: bool) -> tuple:
    """The C function's arguments after the four pointers and before
    the stream: ``B, H, Hkv, Sq, Skv, D, causal``, the (batch, seq, head)
    strides in elements of q, k, v and out, and the softmax scale."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    return (B, H, Hkv, Sq, Skv, D, int(causal), *strides,
            1.0 / math.sqrt(D))


def _launch(q, k, v, causal: bool):
    _check(q, k, v)
    kernel = _kernel()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *_args(q, k, v, out, causal), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention.launches += 1
    return out
