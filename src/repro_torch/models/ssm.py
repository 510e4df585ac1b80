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

Under tensor parallelism (``tp``) each rank holds its columns of
``d_inner`` and computes exactly those channels, as sub-heads
(:func:`sub_heads`); see :func:`ssm_apply`.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.config import ModelConfig, SSMConfig
from repro_torch.kernels.ssd_scan import (expand_groups, ssd_chunk_scan,
                                          ssd_chunked)
from repro_torch.models.collectives import copy_to_split, group_of
from repro_torch.models.layers import all_reduce, rmsnorm
from repro_torch.models.schema import ParamSpec

__all__ = ["ssm_dims", "ssm_schema", "ssd_chunked", "ssm_apply",
           "ssm_cache_schema", "sub_heads"]


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


def sub_heads(cfg: ModelConfig, mp: int, r: int):
    """Rank ``r``'s columns of ``d_inner`` split over ``mp`` ranks, as
    sub-heads.  Returns ``(lo, c, g, heads)``: the columns ``[lo, lo +
    c)`` with ``c = d_inner / mp``, seen as ``c / g`` sub-heads of width
    ``g = gcd(c, head_dim)`` (each inside one head), and the head of each
    sub-head.  At mamba2-130m's
    mp = 16 a rank holds 96 columns, 1.5 heads: three sub-heads of 32,
    heads (0, 0, 1) on rank 0 and (1, 2, 2) on rank 1; at jamba's, 16
    whole heads of 64."""
    d_inner, _ = ssm_dims(cfg)
    hd = cfg.ssm.head_dim
    if d_inner % mp:
        raise ValueError(f"ssm: mp={mp} does not divide d_inner={d_inner}")
    c = d_inner // mp
    g = math.gcd(c, hd)
    lo = r * c
    return lo, c, g, tuple((lo + j * g) // hd for j in range(c // g))


def _repeated(t, first: int, n: int, k: int, dim: int):
    """Entries ``[first, first + n)`` of ``t`` with each entry of ``dim``
    repeated ``k`` times: sub-head ``j``'s head is entry ``j // k`` where
    a head holds ``k`` sub-heads.  Slices and a repeat, no index tensor:
    nothing is copied from the host, and a whole head range (k = 1) is a
    view."""
    h0 = first // k
    t = t.narrow(dim, h0, (first + n - 1) // k + 1 - h0)
    if k > 1:
        t = t.repeat_interleave(k, dim)
    return t.narrow(dim, first - h0 * k, n)


def ssm_apply(p, x, cfg: ModelConfig, *, cache=None,
              tp=None) -> Tuple[torch.Tensor, dict]:
    """Mamba2 block.  x: (B, S, d).  Returns (out, cache).

    cache: None (train / eval) or {"state": (B, H, hd, N) float32,
    "conv_x": (B, K-1, d_inner), "conv_B" / "conv_C": (B, K-1, G*N)},
    written in place and returned.

    ``tp``: the model axis's group (``None``, or a group of one rank:
    the single-device code, unchanged).  Over ``mp > 1`` ranks ``w_z``
    / ``w_x`` hold this rank's columns of ``d_inner``, ``conv_x`` and
    ``norm`` the same columns, ``w_out`` the same rows, and the cache's
    ``conv_x`` the same columns; ``w_B``, ``w_C``, ``w_dt``, ``dt_bias``,
    ``A_log``, ``D``, ``conv_B``, ``conv_C`` and the cache's ``state``
    are whole.  The scan is separable per channel: every output channel
    ``(h, d)`` and every state row ``(h, d, :)`` depends only on ``x[...,
    h, d]`` and its head's ``dt``, ``A_log``, ``D``, ``B`` and ``C``.  So
    the rank computes exactly its columns, as the sub-heads of
    :func:`sub_heads`, with no collective in the scan, the conv or the
    decode update; K6 takes them as its heads (``(B, S, c / g, g)``).
    Two collectives make the whole function: the gated norm's sum of
    squares over ``d_inner`` (float32, 4 bytes a token) and ``w_out``'s
    output (one ``d_model`` row a token), each an all-reduce over
    ``tp``.  A group norm per rank, as some Mamba tensor-parallel codes
    use, would change the numbers.

    Training passes ``tp`` as a :class:`GradGroup`: x enters the
    column-split ``w_z`` / ``w_x`` through ``f`` (``copy_to_split``),
    and so do the whole conv'd ``B`` / ``C``, ``dt``, ``A_log`` and
    ``D``, which each rank uses only on its own channels: their
    gradients are each rank's part, summed over ``tp``, so ``w_B``,
    ``w_C``, ``w_dt``, ``dt_bias``, ``conv_B``, ``conv_C`` and the x
    that feeds them get the whole gradient on every rank.  The backward
    all-reduces, a token a layer in the activations' dtype (bf16 at
    mamba2-130m): x's ``d_model`` (1536 B), B's and C's ``G * N`` (256 B
    each), dt's ``H`` (48 B), the norm's sum of squares (4 B, float32);
    ``A_log`` and ``D`` once a layer (``H`` each).
    """
    B, S, d = x.shape
    s = cfg.ssm
    d_inner, H = ssm_dims(cfg)
    hd, N, G = s.head_dim, s.d_state, s.n_groups
    group = group_of(tp)
    mp = 1 if group is None else dist.get_world_size(group)
    span, xin, per_group = None, x, H // G
    if mp > 1:
        lo, cols, g, _ = sub_heads(cfg, mp, dist.get_rank(group))
        span, first, per_head = (lo, cols, g), lo // g, hd // g
        H, hd = cols // g, g
        xin = copy_to_split(x, tp)

    def own(t, dim=-1, k=1):
        # a whole tensor of heads (or of groups, a group holding k heads)
        # this rank uses on its own channels only: f, then the entry of
        # each of its sub-heads
        if span is None:
            return t
        return _repeated(copy_to_split(t, tp), first, H, per_head * k, dim)

    def own_groups(t):
        # B / C (..., G, N): as they are where G = 1 (every sub-head
        # reads group 0; K6 reads them in place), else a row a sub-head
        if span is None or G > 1:
            return own(t, -2, per_group)
        return copy_to_split(t, tp)

    z = xin @ p["w_z"]
    xs = xin @ p["w_x"]
    Bm = x @ p["w_B"]
    Cm = x @ p["w_C"]
    dt = own(_softplus(x @ p["w_dt"] + p["dt_bias"]))  # (B, S, H)
    A_log, D = own(p["A_log"]), own(p["D"])

    # the reference's condition: a one-token prompt with a cache takes
    # the decode branch and reads the cache's old state (its quirk too)
    if cache is None or S > 1:
        # train (no cache) or prefill (fill conv + ssm state from zero)
        xs, cx = _causal_conv(xs, p["conv_x"])
        Bm, cb = _causal_conv(Bm, p["conv_B"])
        Cm, cc = _causal_conv(Cm, p["conv_C"])
        xh = xs.reshape(B, S, H, hd)
        Bg = own_groups(Bm.reshape(B, S, G, N))
        Cg = own_groups(Cm.reshape(B, S, G, N))
        c = min(s.chunk_size, S)
        while S % c != 0:
            c -= 1
        if cfg.use_pallas_ssd and cache is None and S % 128 == 0:
            y = ssd_chunk_scan(xh, Bg, Cg, dt, A_log, chunk=c)
            final = None  # train path: no state carry needed
        else:
            y, final = ssd_chunked(xh, Bg, Cg, dt, A_log, c)
        if cache is not None:
            _state_rows(cache, span).copy_(final)
            cache["conv_x"].copy_(cx)
            cache["conv_B"].copy_(cb)
            cache["conv_C"].copy_(cc)
    else:
        xs, cx = _causal_conv(xs, p["conv_x"], cache["conv_x"])
        Bm, cb = _causal_conv(Bm, p["conv_B"], cache["conv_B"])
        Cm, cc = _causal_conv(Cm, p["conv_C"], cache["conv_C"])
        xh = xs.reshape(B, H, hd).float()
        Bt = expand_groups(own_groups(Bm.reshape(B, G, N)).float(), H)
        Ct = expand_groups(own_groups(Cm.reshape(B, G, N)).float(), H)
        dtt = dt.reshape(B, H).float()
        a = -torch.exp(A_log.float())
        decay = torch.exp(dtt * a)                     # (B, H)
        # over tp the resolver keeps ``state`` whole on every rank, and
        # the rank reads and writes only the rows of its channels
        # (1 / mp of it): at decode_32k's 8 rows a rank on the 16 x 16
        # layout, 9 of 144 MiB at mamba2-130m (24 layers) and 31.5 of
        # 504 MiB at jamba (63 Mamba layers); the other rows stay zero.
        # Keeping the whole state current on every rank, as XLA's
        # replicated placement would, needs the whole conv output
        # gathered first: 2 GiB a layer at jamba's prefill_32k.
        rows = _state_rows(cache, span)
        state = (rows * decay[:, :, None, None]
                 + (xh * dtt[:, :, None])[..., None] * Bt[:, :, None, :])
        y = torch.einsum("bhn,bhdn->bhd", Ct, state)[:, None].to(x.dtype)
        rows.copy_(state)
        cache["conv_x"].copy_(cx)
        cache["conv_B"].copy_(cb)
        cache["conv_C"].copy_(cc)
        y = y.reshape(B, S, H, hd)

    y = y + D.to(y.dtype)[:, None] * xs.reshape(B, S, H, hd)
    y = y.reshape(B, S, H * hd)
    if mp == 1:
        y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
        return y @ p["w_out"], cache
    # the gated norm over the whole d_inner: this rank's float32 sum of
    # squares, summed over tp.  Each rank uses the sum on its own
    # columns, so under a GradGroup its backward sums the ranks' parts
    # too: the composition g then f (all_reduce's sum_shared, then
    # copy_to_split) rather than a collective of its own, 4 bytes a
    # token each way; serving's plain group sums in place
    v = y * F.silu(z)
    vf = v.float()
    ss = copy_to_split(all_reduce((vf * vf).sum(-1, keepdim=True), tp), tp)
    v = (vf * torch.rsqrt(ss / d_inner + cfg.norm_eps)
         * p["norm"].float()).to(v.dtype)
    # w_out's rows: the output summed over tp (its backward, g's, passes
    # the gradient through)
    return all_reduce(v @ p["w_out"], tp), cache


def _state_rows(cache, span):
    """The cache's ``state`` (B, H, hd, N) rows this rank owns, a view:
    all of them without ``span``, else the channels ``[lo, lo + c)`` of
    ``span = (lo, c, g)`` (one contiguous slice of each batch row) as
    (B, c / g, g, N)."""
    st = cache["state"]
    if span is None:
        return st
    lo, c, g = span
    Bsz, H, hd, N = st.shape
    return st.view(Bsz, H * hd, N)[:, lo:lo + c].unflatten(1, (c // g, g))


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
