"""Mamba2 (SSD — state-space duality) layer.

The counterpart of the reference's ``models/ssm.py`` [arXiv:2405.21060]:
the sequence is split into chunks; within a chunk a quadratic
(attention-like) form runs, across chunks a recurrent state
(B, H, head_dim, d_state) is carried.  Decode is a single-token state
update, O(1) in the sequence length.

The chunked scan itself (``ssd_chunked``) lives beside its kernel in
:mod:`repro_torch.kernels.ssd_scan`, as that kernel's plain version; the
no-cache forward takes the kernel (K6) under the reference's condition
(``use_pallas_ssd``, no cache, ``S % 128 == 0``).

With a cache, the layer writes the new state and conv tails INTO the
cache's tensors (``copy_``): the caller hands it views of the stacked
cache, so rebinding a dict entry would lose the write.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.config import ModelConfig, SSMConfig
from repro_torch.kernels.ssd_scan import (expand_groups, ssd_chunk_scan,
                                          ssd_chunked)
from repro_torch.models.layers import rmsnorm
from repro_torch.models.schema import ParamSpec

__all__ = ["ssm_dims", "ssm_schema", "ssd_chunked", "ssm_apply",
           "ssm_cache_schema"]


def ssm_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    return d_inner, nheads


def ssm_schema(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    s: SSMConfig = cfg.ssm
    d_inner, H = ssm_dims(cfg)
    gn = s.n_groups * s.d_state
    return {
        "w_z": ParamSpec((d, d_inner), ("d_model", "d_inner")),
        "w_x": ParamSpec((d, d_inner), ("d_model", "d_inner")),
        "w_B": ParamSpec((d, gn), ("d_model", "")),
        "w_C": ParamSpec((d, gn), ("d_model", "")),
        "w_dt": ParamSpec((d, H), ("d_model", "")),
        "dt_bias": ParamSpec((H,), ("",), init="zeros"),
        "A_log": ParamSpec((H,), ("",), init="zeros"),
        "D": ParamSpec((H,), ("",), init="ones"),
        "conv_x": ParamSpec((s.d_conv, d_inner), ("", "d_inner"),
                            init="small"),
        "conv_B": ParamSpec((s.d_conv, gn), ("", ""), init="small"),
        "conv_C": ParamSpec((s.d_conv, gn), ("", ""), init="small"),
        "norm": ParamSpec((d_inner,), ("d_inner",), init="ones"),
        "w_out": ParamSpec((d_inner, d), ("d_inner", "d_model")),
    }


def _softplus(x):
    # the reference's jax.nn.softplus, logaddexp(x, 0): F.softplus
    # switches to x above its threshold of 20
    return torch.logaddexp(x, x.new_zeros(()))


def _causal_conv(x, w, state=None):
    """Depthwise causal conv.  x: (B, S, C), w: (K, C).

    With ``state`` (B, K-1, C) the conv consumes it as left context.
    Returns (silu(out), the last K-1 input rows: the new state).  The
    taps are summed in the reference's order, in x's dtype.
    """
    K = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = sum(xp[:, i:i + S] * w[i] for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else pad
    return F.silu(out), new_state


def ssm_apply(p, x, cfg: ModelConfig, *, cache=None) -> Tuple[torch.Tensor,
                                                              dict]:
    """Mamba2 block.  x: (B, S, d).  Returns (out, cache).

    cache: None (train / eval) or {"state": (B, H, hd, N) float32,
    "conv_x": (B, K-1, d_inner), "conv_B" / "conv_C": (B, K-1, G*N)},
    written in place and returned.
    """
    B, S, d = x.shape
    s = cfg.ssm
    d_inner, H = ssm_dims(cfg)
    hd, N, G = s.head_dim, s.d_state, s.n_groups

    z = x @ p["w_z"]
    xs = x @ p["w_x"]
    Bm = x @ p["w_B"]
    Cm = x @ p["w_C"]
    dt = _softplus(x @ p["w_dt"] + p["dt_bias"])      # (B, S, H)

    # the reference's condition: a one-token prompt with a cache takes
    # the decode branch and reads the cache's old state (its quirk too)
    if cache is None or S > 1:
        # train (no cache) or prefill (fill conv + ssm state from zero)
        xs, cx = _causal_conv(xs, p["conv_x"])
        Bm, cb = _causal_conv(Bm, p["conv_B"])
        Cm, cc = _causal_conv(Cm, p["conv_C"])
        xh = xs.reshape(B, S, H, hd)
        c = min(s.chunk_size, S)
        while S % c != 0:
            c -= 1
        if cfg.use_pallas_ssd and cache is None and S % 128 == 0:
            y = ssd_chunk_scan(xh, Bm.reshape(B, S, G, N),
                               Cm.reshape(B, S, G, N), dt, p["A_log"],
                               chunk=c)
            final = None  # train path: no state carry needed
        else:
            y, final = ssd_chunked(xh, Bm.reshape(B, S, G, N),
                                   Cm.reshape(B, S, G, N), dt, p["A_log"], c)
        if cache is not None:
            cache["state"].copy_(final)
            cache["conv_x"].copy_(cx)
            cache["conv_B"].copy_(cb)
            cache["conv_C"].copy_(cc)
    else:
        xs, cx = _causal_conv(xs, p["conv_x"], cache["conv_x"])
        Bm, cb = _causal_conv(Bm, p["conv_B"], cache["conv_B"])
        Cm, cc = _causal_conv(Cm, p["conv_C"], cache["conv_C"])
        xh = xs.reshape(B, H, hd).float()
        Bt = expand_groups(Bm.reshape(B, G, N).float(), H)
        Ct = expand_groups(Cm.reshape(B, G, N).float(), H)
        dtt = dt.reshape(B, H).float()
        a = -torch.exp(p["A_log"].float())
        decay = torch.exp(dtt * a)                     # (B, H)
        state = (cache["state"] * decay[:, :, None, None]
                 + (xh * dtt[:, :, None])[..., None] * Bt[:, :, None, :])
        y = torch.einsum("bhn,bhdn->bhd", Ct, state)[:, None].to(x.dtype)
        cache["state"].copy_(state)
        cache["conv_x"].copy_(cx)
        cache["conv_B"].copy_(cb)
        cache["conv_C"].copy_(cc)
        y = y.reshape(B, S, H, hd)

    y = y + p["D"].to(y.dtype)[:, None] * xs.reshape(B, S, H, hd)
    y = y.reshape(B, S, d_inner)
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return y @ p["w_out"], cache


def ssm_cache_schema(cfg: ModelConfig, batch: int) -> Dict[str, ParamSpec]:
    s = cfg.ssm
    d_inner, H = ssm_dims(cfg)
    gn = s.n_groups * s.d_state
    K = s.d_conv
    return {
        "state": ParamSpec((batch, H, s.head_dim, s.d_state),
                           ("batch", "", "", ""), "float32", "zeros"),
        "conv_x": ParamSpec((batch, K - 1, d_inner),
                            ("batch", "", "d_inner"), cfg.dtype, "zeros"),
        "conv_B": ParamSpec((batch, K - 1, gn), ("batch", "", ""), cfg.dtype,
                            "zeros"),
        "conv_C": ParamSpec((batch, K - 1, gn), ("batch", "", ""), cfg.dtype,
                            "zeros"),
    }
