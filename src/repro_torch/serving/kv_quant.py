"""Int8 KV-cache quantization.

Keys/values are stored int8 with per-(row, position, head) float16
scales (absmax symmetric): half the decode cache's bytes of bf16.  The
port keeps the reference's scheme exactly (``serving/kv_quant.py``):
the same float32 arithmetic, the same ``+ 1e-8`` before the float16
cast, and round-half-to-even (``torch.round``, as ``jnp.round``), so
the same input gives the same codes and scales.

Attention reads the dequantized views (:func:`read`) through the
decode kernels; no kernel of its own.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.schema import ParamSpec


def quantize(x: torch.Tensor, dim: int = -1
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """absmax-symmetric int8 quantization along ``dim``.

    Returns (q int8, scale float16) with x ≈ q * scale."""
    xf = x.float()
    amax = xf.abs().amax(dim=dim, keepdim=True)
    scale = (amax / 127.0 + 1e-8).to(torch.float16)
    q = torch.clamp(torch.round(xf / scale.float()), -127, 127)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale.float()).to(dtype)


def quant_kv_cache_schema(batch: int, max_len: int, n_kv: int,
                          head_dim: int) -> Dict[str, ParamSpec]:
    """Schema for one layer's quantized KV cache."""
    axes = ("batch", "seq", "kv_heads", "head_dim")
    saxes = ("batch", "seq", "kv_heads", "")
    return {
        "k_q": ParamSpec((batch, max_len, n_kv, head_dim), axes, "int8",
                         "zeros"),
        "v_q": ParamSpec((batch, max_len, n_kv, head_dim), axes, "int8",
                         "zeros"),
        "k_s": ParamSpec((batch, max_len, n_kv, 1), saxes, "float16",
                         "zeros"),
        "v_s": ParamSpec((batch, max_len, n_kv, 1), saxes, "float16",
                         "zeros"),
    }


def insert_step(cache: Dict[str, torch.Tensor], k: torch.Tensor,
                v: torch.Tensor, pos: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Insert one decode step's (B, 1, Hkv, Dh) k/v at per-row ``pos``,
    in place; positions past the row are dropped, as the reference's
    scatter drops them."""
    from repro_torch.models.layers import _write_step
    kq, ks = quantize(k[:, 0])
    vq, vs = quantize(v[:, 0])
    for name, rows in (("k_q", kq), ("v_q", vq), ("k_s", ks), ("v_s", vs)):
        _write_step(cache[name], rows, pos)
    return cache


def read(cache: Dict[str, torch.Tensor], dtype=torch.bfloat16):
    """Dequantized (k, v) views for attention."""
    return (dequantize(cache["k_q"], cache["k_s"], dtype),
            dequantize(cache["v_q"], cache["v_s"], dtype))


def cache_bytes(batch: int, max_len: int, n_kv: int, head_dim: int,
                quantized: bool) -> int:
    if quantized:
        return batch * max_len * n_kv * (2 * head_dim + 2 * 2)
    return batch * max_len * n_kv * head_dim * 2 * 2
