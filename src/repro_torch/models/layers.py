"""Core layer primitives: norms, rope, GQA attention, MLA, MLP.

Plain functions over explicit parameter dicts, mirroring the reference's
``models/layers.py`` leaf for leaf.  The GQA path is ported with every
cache layout the serving engine has: no cache, the dense slot cache and
the paged pool, each in the config's dtype or int8, and the ring cache
of a sliding-window layer; with the window and the logit softcap; and
Whisper's cross-attention (``cross_kv``): the query alone, no rope,
the plain non-causal :func:`attention` over every encoder row, as in
the reference, which has no kernel for it.

Cached decode attention goes through a kernel wrapper under the
reference's gate (causal, no window, no softcap):
:func:`repro_torch.kernels.flash_decode.flash_decode` over the dense
slot cache, :func:`repro_torch.kernels.paged_flash_decode.
paged_flash_decode` through the block table — the hand-written CUDA
kernels on the card, their plain PyTorch versions for CPU tensors.  A
windowed or softcapped layer, and a ring, decode through the plain
:func:`attention`, the reference's own route for them.
The no-cache branch takes :func:`repro_torch.kernels.flash_attention.
flash_attention` under the reference's condition
(``cfg.use_pallas_attention``, causal, no window or softcap, Sq == Skv,
Sq % 128 == 0); it has no gradient, as the reference's kernel has none.

Tensor parallel (``tp``, a model-axis process group, or ``None``): the
attention layer gets its local heads and kv heads (every head count
here comes from a weight's or a tensor's shape, so G = H / Hkv is
mp-invariant), the MLP its local ``d_ff`` columns; each all-reduces its
partial output projection over ``tp`` before any output bias.  With
``None`` nothing changes.  Training passes ``tp`` as a
:class:`~repro_torch.models.collectives.GradGroup`: the all-reduce is
then the Megatron ``g`` (gradient passed through) and each sublayer's
input enters its column-split products through ``f`` (gradient summed
over ``tp``); serving's plain group keeps the in-place all-reduce.
Where mp does not divide the kv heads (qwen1.5-32b's 40, command-r's,
dbrx's and gemma3's 8 at mp = 16), the resolver splits the attention's
leaves on ``head_dim`` and the layer takes that placement's own route
(:func:`_gqa_head_dim`: the step's rows gathered for rope, decode's
partial scores summed over ``tp``, whole heads at S > 1); Whisper's
cross-attention takes the same placements and routes, with no rope
and nothing written.

Multi-head latent attention (:func:`mla_apply`) reaches no kernel, as in
the reference: its naive decode runs the plain :func:`attention`, its
absorbed decode plain float32 products.  Under ``tp`` its up-projections
split on heads or ``head_dim`` and its cached latent on ``kv_lora``
(:func:`_mla_split`: whole heads over the whole latent on every rank).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.core.config import MLAConfig, ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.paged_flash_decode import paged_flash_decode
from repro_torch.models.collectives import (GradGroup, all_to_all,
                                            copy_to_split, gather_split,
                                            group_of, sum_shared)
from repro_torch.models.schema import ParamSpec
from repro_torch.serving import kv_quant as KQ

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_schema(d: int) -> ParamSpec:
    return ParamSpec((d,), ("d_model",), init="ones")


def rmsnorm(w, x, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_angles(head_dim: int, theta: float, positions):
    """positions (..., S) -> cos/sin (..., S, head_dim//2)."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    # theta stays a Python scalar: a tensor made of it on the card would
    # be a copy from the host that waits for the stream, in every layer
    freqs = theta ** exps
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D), positions: (B, S) or (S,).  Half-split layout:
    the first and second halves of the head dim rotate as pairs."""
    d = x.shape[-1]
    cos, sin = rope_angles(d, theta, positions)
    if cos.dim() == 2:  # (S, half) -> broadcast over batch
        cos, sin = cos[None], sin[None]
    cos = cos[..., None, :]  # (B, S, 1, half)
    sin = sin[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (chunked, GQA)
# ---------------------------------------------------------------------------


def _attn_block(q, k, v, q_pos, kv_pos, kv_len, *, causal, window, softcap,
                head_dim=None, reduce=None):
    """One query block against full kv.

    q: (B, Sq, Hkv, G, Dh)  k/v: (B, Skv, Hkv, Dh)
    q_pos: (B, Sq)  kv_pos: (Skv,)  kv_len: (B,) or None
    """
    scale = 1.0 / math.sqrt(head_dim or q.shape[-1])
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())
    if reduce is not None:
        scores = reduce(scores)
    scores = scores * scale
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    qp = q_pos[:, :, None]          # (B, Sq, 1)
    kp = kv_pos[None, None, :]      # (1, 1, Skv)
    mask = torch.ones(scores.shape[-2:], dtype=torch.bool,
                      device=scores.device)[None]   # (1, Sq, Skv)
    if causal:
        mask = mask & (kp <= qp)
    if window:
        mask = mask & (kp > qp - window)
    if kv_len is not None:
        mask = mask & (kp < kv_len[:, None, None])
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.to(v.dtype)


def attention(q, k, v, *, q_pos, kv_len=None, causal=True, window=0,
              softcap=0.0, q_chunk=1024, head_dim=None, reduce=None):
    """Grouped-query attention with query chunking.

    q: (B, Sq, H, Dh), k/v: (B, Skv, Hkv, Dh).
    q_pos: (B, Sq) absolute positions of queries.
    kv_len: (B,) valid cache length (None = all Skv valid).

    With ``reduce``, q, k and v hold one rank's slice of the head dims
    (``head_dim`` is the whole width, which sets the scale): each query
    block's float32 partial scores go through ``reduce`` (the sum over
    the ranks' slices, an all-reduce) before the scale, the softcap, the
    masks and the softmax, and the result is this rank's slice of P V.
    """
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, Dh)
    kv_pos = torch.arange(Skv, dtype=torch.int32, device=q.device)
    kw = dict(causal=causal, window=window, softcap=softcap,
              head_dim=head_dim, reduce=reduce)

    if Sq <= q_chunk or Sq % q_chunk != 0:
        out = _attn_block(qg, k, v, q_pos, kv_pos, kv_len, **kw)
        return out.reshape(B, Sq, H, Dv)

    outs = [_attn_block(qg[:, i:i + q_chunk], k, v, q_pos[:, i:i + q_chunk],
                        kv_pos, kv_len, **kw)
            for i in range(0, Sq, q_chunk)]
    return torch.cat(outs, dim=1).reshape(B, Sq, H, Dv)


# ---------------------------------------------------------------------------
# GQA attention layer (projections + rope + cache plumbing)
# ---------------------------------------------------------------------------


def gqa_schema(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = {
        "wq": ParamSpec((d, H, Dh), ("d_model", "heads", "head_dim")),
        "wk": ParamSpec((d, Hkv, Dh), ("d_model", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, Hkv, Dh), ("d_model", "kv_heads", "head_dim")),
        "wo": ParamSpec((H, Dh, d), ("heads", "head_dim", "d_model")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((H, Dh), ("heads", "head_dim"), init="zeros")
        s["bk"] = ParamSpec((Hkv, Dh), ("kv_heads", "head_dim"), init="zeros")
        s["bv"] = ParamSpec((Hkv, Dh), ("kv_heads", "head_dim"), init="zeros")
    return s


def proj_heads(x, w):
    """(B, S, d) @ (d, H, Dh) -> (B, S, H, Dh) as one matrix product."""
    d, H, Dh = w.shape
    return (x @ w.reshape(d, H * Dh)).reshape(*x.shape[:-1], H, Dh)


def _write_step(cache, rows, pos):
    """cache (B, L, ...) <- rows (B, ...) at per-row position ``pos``,
    in place.  Positions ``>= L`` are dropped, as the reference's
    out-of-bounds scatter drops them: an idle slot's held position may
    sit one past the end of its row."""
    B, L = cache.shape[:2]
    bidx = torch.arange(B, device=cache.device)
    idx = pos.clamp(max=L - 1).long()
    keep = (pos < L).reshape(B, *([1] * (rows.dim() - 1)))
    cache[bidx, idx] = torch.where(keep, rows.to(cache.dtype),
                                   cache[bidx, idx])


def _write_page_step(pool, rows, page, off, keep):
    """pool (NP, ps, ...) <- rows (B, ...) at (page[b], off[b]) where
    ``keep[b]``, in place and with no host sync (the reference scatters
    to the out-of-range page ``NP`` with ``mode="drop"``).  A dropped
    row's table entry may be stale and name a page another slot now
    writes, so a dropped row does not write back its own target: it
    repeats the first kept row's write (or, when no row is kept, row
    0's old value).  Every duplicate index then carries one value, and
    the scatter's order cannot matter."""
    # a one-element index tensor: indexing with a 0-dim tensor would
    # read it back to the host
    first = keep.to(torch.int32).argmax().reshape(1)
    keep_rows = keep.reshape(-1, *([1] * (rows.dim() - 1)))
    vals = torch.where(keep_rows, rows.to(pool.dtype), pool[page, off])
    vals = torch.where(keep_rows, vals, vals.index_select(0, first))
    page = torch.where(keep, page, page.index_select(0, first))
    off = torch.where(keep, off, off.index_select(0, first))
    pool[page, off] = vals


def _page_targets(page_table, pos, pool):
    """(page, offset, keep) of each slot's write at ``pos`` into ``pool``
    (num_pages, page_size, ...) through ``page_table``; a position past
    the table (an idle slot parked at ``max_blocks * page_size``) is not
    kept."""
    NP, ps = pool.shape[:2]
    MB = page_table.shape[1]
    blk = pos // ps
    page = page_table[torch.arange(pos.shape[0], device=pos.device),
                      blk.clamp(max=MB - 1)].long().clamp(0, NP - 1)
    return page, (pos % ps).long(), blk < MB


def _paged_rows(pk, pv, page_table):
    """The reference's plain read of the pools: every block but the last
    (the executor's write-overflow block) gathered into a contiguous
    row, so the softmax runs over the dense path's length."""
    B, MB = page_table.shape
    tbl = (page_table[:, :MB - 1] if MB > 1
           else page_table).long().clamp(0, pk.shape[0] - 1)
    return (pk[tbl].reshape(B, -1, *pk.shape[2:]),
            pv[tbl].reshape(B, -1, *pv.shape[2:]))


def all_reduce(x, tp):
    """Sum ``x`` over the model-axis group ``tp`` in place (``tp=None``:
    ``x`` as it is); a :class:`GradGroup` sums out of place with a
    gradient (the Megatron ``g``)."""
    if isinstance(tp, GradGroup):
        return sum_shared(x, tp.group)
    if tp is not None:
        dist.all_reduce(x, group=tp)
    return x


def gqa_apply(p, x, cfg: ModelConfig, *, positions, cache=None, window=0,
              causal=True, cross_kv=None, ring=False, page_table=None,
              tp=None):
    """x: (B, S, d).  cache: None, a dense slot cache {"k", "v"} or its
    int8 form {"k_q", "v_q", "k_s", "v_s"}; with ``page_table`` the
    same leaves are page pools (num_pages, page_size, Hkv, Dh).
    positions: (B, S) absolute positions.  Returns (out, cache).

    With a cache, this step's k/v are written into it IN PLACE (the
    slot cache is the largest buffer the server holds, so it is never
    copied) and the same dict is returned.

    * Prefill (S > 1) writes rows at ``positions`` — a suffix prefill
      starts past 0 when a shared prefix is already resident — and
      attends over ``[0, positions[:, -1] + 1)`` with the causal mask by
      absolute position.
    * Dense decode (S == 1) writes each row's k/v at its own position
      and attends over [0, position] through the flash-decode kernel.
    * Paged decode (``page_table`` (B, max_blocks) int32) writes into
      the page that holds the position and attends through the paged
      kernel; a position past the table (an idle slot parked at
      ``max_blocks * page_size``) drops its write.
    * int8 leaves: the step's k/v are quantized on the way in and the
      kernels read the dequantized views.
    * ``ring=True`` with ``window > 0``: the cache holds a ring of W =
      min(max_len, window) rows; position p lives in row p % W.  Keys
      carry their absolute-position rope phases, so every resident row
      lies in the window and decode masks only the rows not yet filled.

    Decode takes K1 / K2 only where the reference takes its kernels:
    causal, no window, no softcap.  Otherwise it runs the plain
    :func:`attention` with the window and the softcap — the reference's
    own route (its windowed decode has no kernel), not a fallback.  The
    port ignores ``cfg.use_flash_decode``: on the card the kernels run
    wherever this gate lets them.

    ``cross_kv=(k, v)`` (B, T, Hkv, Dh) makes this Whisper's
    cross-attention: only the query is projected (with its bias), no
    rope on either side, no mask, and the cache is returned untouched.
    Under ``tp`` k and v hold the kv heads, or the ``head_dim``
    columns, of ``cross/wk`` / ``cross/wv`` on this rank, and the
    layer takes the same routes as the self-attention's.

    With ``tp`` the weights, biases and cache hold this rank's heads and
    kv heads, and the output projection is all-reduced over ``tp``.
    Where mp does not divide the kv heads, the kv weights and the cache
    hold this rank's ``head_dim`` columns instead (and so do the query's
    where mp does not divide the heads): :func:`_gqa_head_dim`, told
    apart by the local head_dim, as every head count here comes from a
    shape.
    """
    B, S, d = x.shape
    x = copy_to_split(x, tp)
    q = proj_heads(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    if cross_kv is not None:
        k, v = cross_kv
        if k.shape[-1] < cfg.head_dim:
            # the cross k / v split on head_dim over tp: the head_dim
            # route without rope or a cache write
            out = _gqa_head_dim(q, k, v, cfg, positions=positions,
                                cache=None, window=0, causal=False,
                                ring=False, page_table=None, tp=tp,
                                cross=True)
        else:
            # whole heads: one device, or the heads placement, where q
            # and the cross k / v hold this rank's heads and kv heads and
            # _out_proj's all-reduce sums the ranks' heads
            out = attention(q, k, v, q_pos=positions, causal=False)
        return _out_proj(p, out, tp), cache

    softcap = cfg.attn_logit_softcap
    # the reference's kernel gate; past it, the plain attention below is
    # the reference's own route (its windowed decode has no kernel)
    kernel = causal and not window and not softcap
    k = proj_heads(x, p["wk"])
    v = proj_heads(x, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    if k.shape[-1] < cfg.head_dim:
        # the kv heads split on head_dim over tp: that placement's route
        out = _gqa_head_dim(q, k, v, cfg, positions=positions, cache=cache,
                            window=window, causal=causal, ring=ring,
                            page_table=page_table, tp=tp)
        return _out_proj(p, out, tp), cache
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        if (cfg.use_pallas_attention and causal and not window
                and not cfg.attn_logit_softcap and q.shape[1] == k.shape[1]
                and q.shape[1] % 128 == 0):
            out = flash_attention(q, k, v, causal=True)
        else:
            out = attention(q, k, v, q_pos=positions, causal=causal,
                            window=window, softcap=softcap,
                            q_chunk=cfg.attn_q_chunk)
    elif ring and window:
        ck, cv = cache["k"], cache["v"]            # (B, W, Hkv, Dh)
        W = ck.shape[1]
        bidx = torch.arange(B, device=x.device)
        if S == 1:
            # an idle slot's held position wraps into its ring exactly as
            # in the reference: the row is replaced at its next commit
            slot = (positions[:, 0] % W).long()
            ck[bidx, slot] = k[:, 0].to(ck.dtype)
            cv[bidx, slot] = v[:, 0].to(cv.dtype)
            # every resident row is within the window and <= the query's
            # position: only the rows not yet filled (pos < W) are masked
            kv_len = (positions[:, -1] + 1).clamp(max=W)
            out = attention(q, ck, cv, q_pos=positions, kv_len=kv_len,
                            causal=False, window=0, softcap=softcap,
                            q_chunk=cfg.attn_q_chunk)
        else:
            # prefill attends over the fresh k/v, windowed and causal; the
            # ring receives only the trailing min(S, W) keys
            out = attention(q, k, v, q_pos=positions, causal=causal,
                            window=window, softcap=softcap,
                            q_chunk=cfg.attn_q_chunk)
            span = min(S, W)
            slots = (positions[:, -span:] % W).long()
            ck[bidx[:, None], slots] = k[:, -span:].to(ck.dtype)
            cv[bidx[:, None], slots] = v[:, -span:].to(cv.dtype)
    elif S == 1 and page_table is not None:
        # paged decode: write this step's k/v into the page holding
        # `pos`, read back through the block table
        quant = "k_q" in cache
        pos = positions[:, 0]
        page, off, keep = _page_targets(page_table, pos,
                                        cache["k_q"] if quant else cache["k"])
        if quant:
            kq, ks = KQ.quantize(k[:, 0])
            vq, vs = KQ.quantize(v[:, 0])
            for name, rows in (("k_q", kq), ("v_q", vq), ("k_s", ks),
                               ("v_s", vs)):
                _write_page_step(cache[name], rows, page, off, keep)
            pk, pv = KQ.read(cache, dtype=v.dtype)
        else:
            _write_page_step(cache["k"], k[:, 0], page, off, keep)
            _write_page_step(cache["v"], v[:, 0], page, off, keep)
            pk, pv = cache["k"], cache["v"]
        if kernel:
            out = paged_flash_decode(q[:, 0], pk, pv, page_table, pos + 1)
            out = out[:, None].to(v.dtype)
        else:
            ck, cv = _paged_rows(pk, pv, page_table)
            out = attention(q, ck, cv, q_pos=positions, kv_len=pos + 1,
                            causal=causal, window=window, softcap=softcap,
                            q_chunk=cfg.attn_q_chunk)
    else:
        quant = "k_q" in cache
        if S == 1:
            pos = positions[:, 0]
            if quant:
                KQ.insert_step(cache, k, v, pos)
            else:
                _write_step(cache["k"], k[:, 0], pos)
                _write_step(cache["v"], v[:, 0], pos)
        else:
            bidx = torch.arange(B, device=x.device)[:, None]
            idx = positions.long()
            if quant:
                kq, ks = KQ.quantize(k)
                vq, vs = KQ.quantize(v)
                for name, rows in (("k_q", kq), ("v_q", vq), ("k_s", ks),
                                   ("v_s", vs)):
                    cache[name][bidx, idx] = rows
            else:
                cache["k"][bidx, idx] = k.to(cache["k"].dtype)
                cache["v"][bidx, idx] = v.to(cache["v"].dtype)
        ck, cv = (KQ.read(cache, dtype=v.dtype) if quant
                  else (cache["k"], cache["v"]))
        kv_len = positions[:, -1] + 1
        if S == 1 and kernel:
            # kv_len masking subsumes the causal mask at decode
            out = flash_decode(q[:, 0], ck, cv, kv_len)[:, None]
            out = out.to(v.dtype)
        else:
            out = attention(q, ck, cv, q_pos=positions, kv_len=kv_len,
                            causal=causal, window=window, softcap=softcap,
                            q_chunk=cfg.attn_q_chunk)
    return _out_proj(p, out, tp), cache


def _heads_of(H: int, n: int, r: int):
    """Rank ``r``'s block of ``H`` heads over ``n`` ranks, the first
    ``H % n`` ranks one head more: (first head, count a rank)."""
    counts = [H // n + (i < H % n) for i in range(n)]
    return sum(counts[:r]), counts


def _kv_of(k, v, start: int, count: int, G: int):
    """The kv heads that query heads [start, start + count) read (kv
    head h // G), as a GQA block for :func:`attention`: a slice where
    the heads cover whole groups or sit in one, else one kv head a query
    head."""
    lo, hi = start // G, (start + count - 1) // G + 1
    if (start % G == 0 and count % G == 0) or hi - lo == 1:
        return k[:, :, lo:hi], v[:, :, lo:hi]
    idx = torch.div(torch.arange(start, start + count, device=k.device), G,
                    rounding_mode="floor")
    return k.index_select(2, idx), v.index_select(2, idx)


def _cache_rows(k, v, quant: bool, dims):
    """The cache leaves' rows of whole k / v rows (..., Hkv, Dh): this
    rank's ``dims``, and with ``quant`` the int8 codes of the whole rows.
    The reference keeps one scale a (position, kv head) over the whole
    head_dim, so a slice's own absmax would give other codes: the rows
    are quantized whole, then sliced, and the scales stay whole."""
    if not quant:
        return {"k": k[..., dims], "v": v[..., dims]}
    kq, ks = KQ.quantize(k)
    vq, vs = KQ.quantize(v)
    return {"k_q": kq[..., dims], "v_q": vq[..., dims], "k_s": ks,
            "v_s": vs}


def _gather_heads(parts, group):
    """``parts`` (B, S_i, H_i, Dl), this rank's ``head_dim`` columns of
    each, whole (B, S_i, H_i, Dl x n) in one all-gather over ``group``:
    each part flattened to (B, S_i H_i, Dl) and joined on that, so parts
    of other lengths (the cross-attention's q beside the encoder's rows)
    go in the same gather as the self-attention's q, k and v."""
    B, Dl = parts[0].shape[0], parts[0].shape[-1]
    whole = gather_split(torch.cat([t.reshape(B, -1, Dl) for t in parts], 1),
                         group, 2)
    return [w.reshape(*t.shape[:3], -1) for w, t in zip(
        whole.split([t.shape[1] * t.shape[2] for t in parts], 1), parts)]


def _gqa_head_dim(q, k, v, cfg: ModelConfig, *, positions, cache, window,
                  causal, ring, page_table, tp, cross=False):
    """The attention of a layer whose kv heads split on ``head_dim`` over
    ``tp`` (the resolver's fallback where mp does not divide them): k, v
    (B, S, Hkv, Dh / n) and the cache leaves hold this rank's columns;
    q holds either its heads, whole (mp divides the heads: the "mixed"
    placement), or its columns of every head.  Returns the attention's
    output as ``wo`` holds it here: this rank's heads, or this rank's
    columns of every head.  The reference leaves these collectives to
    XLA; the port writes them out:

    * Rope rotates dim j with j + Dh / 2, which another rank holds, so
      the step's rows are all-gathered whole on head_dim before rope
      (one gather of q, k and v, or of k and v where q splits on heads;
      a few KB at decode).
    * Decode (S == 1) keeps the cache's split: rank r's columns of q
      against its cache columns give partial scores, all-reduced in
      float32 over ``tp`` (:func:`attention` with ``reduce``), then the
      softmax and this rank's columns of P V.  Gathering the cache
      instead would move every layer's K and V (64 MiB each a sequence
      at command-r's decode_32k) where the summed scores are B x H x L
      x 4 bytes (8 MiB a sequence): the dry run counts 2.69e9 bytes of
      all-reduces for rank 0's decode_32k step on the 16 x 16 layout,
      against 4.3e10 to gather its 40 layers' caches.  In the mixed placement q is gathered over its
      heads first (every head's scores are summed) and P V over
      head_dim after, before ``wo``'s heads: two gathers of B x H x Dh
      rows, where a reduce-scatter of the scores to this rank's heads
      would leave it without the other ranks' V columns.  No kernel
      takes a slice of a head's dims, so this is the placement's own
      route, on the plain attention, not a fallback from K1 / K2.
    * S > 1 (prefill, training, evaluation) would sum S x S scores
      (275 GB a sequence a layer for command-r at prefill_32k), so the
      k / v rows are gathered (with a cache, the cache's rows after this
      step's are written: the prompt's), each rank attends its own
      heads whole (K4 under the no-cache gate), and only this rank's
      columns are written to the cache.  In the mixed placement those
      are its own q heads; where the heads split on head_dim too
      (qwen1.5-32b's 40 heads at mp = 16), rank r takes an uneven block
      of the heads (:func:`_heads_of`: 3 or 2 of 40) and an all-to-all
      returns each head's columns to the rank ``wo`` holds them on.  By
      the dry run's count for rank 0 of the 16 x 16 layout, every rank
      attending every head instead would take 3.09e15 FLOP at
      prefill_32k against 4.87e14 (2.46e15 against 1.16e15 at train_4k
      in one microbatch) and a peak of 40.1 GB against 17.9, to save an
      all-to-all of 2.7 GB (8.6 GB): under 1.5 % of either step's
      collective bytes.
    * int8 caches quantize the whole rows (:func:`_cache_rows`).

    ``cross=True`` is Whisper's cross-attention (``gqa_apply``'s
    ``cross_kv``): k, v (B, T, Hkv, Dh / n) are this rank's columns of
    the encoder's rows (projected from it, or read from the cross
    cache), nothing is rotated, masked or written, and the rest is the
    route above.  By the shapes of rank 0 of whisper-large-v3 on the
    16 x 16 layout (20 heads, 20 kv heads, 1500 encoder rows, bf16):

    * Decode (S == 1) keeps the cross cache's split and sums the float32
      partial scores over ``tp``: 8 rows x 20 heads x 1500 x 4 B = 0.96
      MB a layer at decode_32k, where gathering the cross cache would
      move 8 x 1500 x 20 x 64 x 2 B x 2 = 61 MB a layer.
    * S > 1 (prefill, training, evaluation) gathers q, k and v whole on
      head_dim in one all-gather (:func:`_gather_heads`; the k / v rows
      are 2 x 1500 x 20 x 64 x 2 B x 2 = 15 MB at prefill_32k's 2 rows a
      rank) and each rank attends its own block of heads, where summed
      scores would be 2 x 20 x 32768 x 1500 x 4 B = 7.9 GB a layer.
    * The mixed placement (q on heads, the cross k / v on head_dim)
      would need H != Hkv, which Whisper does not have: it raises.

    Training runs it under a :class:`GradGroup`: each gather's backward
    reduce-scatters the gradient (every rank uses the gathered rows for
    its own heads) and the all-to-all sends it back.  The decode route
    takes a cache (or cross rows), which training never has at S == 1."""
    group = group_of(tp)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    Dh, Hkv = cfg.head_dim, k.shape[2]
    Dl = k.shape[-1]
    dims = slice(r * Dl, (r + 1) * Dl)
    split_q = q.shape[-1] < Dh
    H = q.shape[2] if split_q else q.shape[2] * n
    B, S = q.shape[:2]
    if cross and not split_q:
        raise ValueError(
            f"{cfg.name}: cross-attention with q on heads and the cross "
            f"k / v on head_dim (H={H}, Hkv={Hkv} over {n} ranks) has no "
            f"route")
    if cross and S == 1:
        return attention(q, k, v, q_pos=positions, causal=False,
                         head_dim=Dh, reduce=lambda s: all_reduce(s, group))
    if split_q:
        q, k, v = _gather_heads([q, k, v], group)
    else:
        k, v = _gather_heads([k, v], group)
    if not cross:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    quant = cache is not None and "k_q" in cache
    softcap = cfg.attn_logit_softcap
    # the cross-attention's plain call is the one-device call's, with
    # attention's own softcap and q_chunk
    plain = {} if cross else {"softcap": softcap, "q_chunk": cfg.attn_q_chunk}
    bidx = torch.arange(B, device=q.device)

    if cache is not None and S == 1:
        if not split_q:
            q = gather_split(q, group, 2)
        rows = {name: t[:, 0] for name, t in
                _cache_rows(k, v, quant, dims).items()}
        pos = positions[:, 0]
        kv_len = pos + 1
        if ring and window:
            ck, cv = cache["k"], cache["v"]
            W = ck.shape[1]
            slot = (pos % W).long()
            ck[bidx, slot] = rows["k"].to(ck.dtype)
            cv[bidx, slot] = rows["v"].to(cv.dtype)
            kv_len, causal, window = kv_len.clamp(max=W), False, 0
        elif page_table is not None:
            page, off, keep = _page_targets(
                page_table, pos, cache["k_q"] if quant else cache["k"])
            for name, t in rows.items():
                _write_page_step(cache[name], t, page, off, keep)
            ck, cv = _paged_rows(*(KQ.read(cache, dtype=v.dtype) if quant
                                   else (cache["k"], cache["v"])),
                                 page_table)
        else:
            for name, t in rows.items():
                _write_step(cache[name], t, pos)
            ck, cv = (KQ.read(cache, dtype=v.dtype) if quant
                      else (cache["k"], cache["v"]))
        out = attention(q[..., dims], ck, cv, q_pos=positions,
                        kv_len=kv_len, causal=causal, window=window,
                        head_dim=Dh, reduce=lambda s: all_reduce(s, group),
                        **plain)
        if split_q:
            return out
        Hl = H // n
        return gather_split(out, group, 3)[:, :, r * Hl:(r + 1) * Hl]

    kv_len = None
    if cache is not None and ring and window:
        # the ring receives the trailing min(S, W) keys; prefill attends
        # over the fresh rows, as on one device
        ck, cv = cache["k"], cache["v"]
        span = min(S, ck.shape[1])
        slots = (positions[:, -span:] % ck.shape[1]).long()
        ck[bidx[:, None], slots] = k[:, -span:, :, dims].to(ck.dtype)
        cv[bidx[:, None], slots] = v[:, -span:, :, dims].to(cv.dtype)
    elif cache is not None:
        idx = positions.long()
        for name, t in _cache_rows(k, v, quant, dims).items():
            cache[name][bidx[:, None], idx] = t.to(cache[name].dtype)
        # attend over the cache as on one device (a suffix prefill's
        # shared prefix is there): its rows gathered whole
        names = ("k_q", "v_q") if quant else ("k", "v")
        k, v = gather_split(torch.cat([cache[c] for c in names], 2), group,
                            3).split([Hkv, Hkv], 2)
        if quant:
            k = KQ.dequantize(k, cache["k_s"], q.dtype)
            v = KQ.dequantize(v, cache["v_s"], q.dtype)
        kv_len = positions[:, -1] + 1
    if split_q:
        start, counts = _heads_of(H, n, r)
        count = counts[r]
        q = q[:, :, start:start + count]
    else:
        start, count = r * q.shape[2], q.shape[2]
    k, v = _kv_of(k, v, start, count, H // Hkv)
    if (cache is None and cfg.use_pallas_attention and causal and not window
            and not softcap and S == k.shape[1] and S % 128 == 0):
        out = flash_attention(q, k, v, causal=True)
    else:
        out = attention(q, k, v, q_pos=positions, kv_len=kv_len,
                        causal=causal, window=window, **plain)
    return _to_columns(out, group, counts) if split_q else out


def _to_columns(out, group, counts):
    """(B, S, counts[r], D): this rank's block of heads (:func:`_heads_of`)
    with every column -> (B, S, sum(counts), D / n): every head, this
    rank's columns, in one all-to-all over ``group``."""
    n = len(counts)
    B, S, count, D = out.shape
    Dl = D // n
    send = out.reshape(B, S, count, n, Dl).permute(3, 0, 1, 2, 4)
    got = all_to_all(send.reshape(-1), group, [B * S * count * Dl] * n,
                     [B * S * c * Dl for c in counts])
    return torch.cat([t.reshape(B, S, c, Dl) for t, c in
                      zip(got.split([B * S * c * Dl for c in counts]),
                          counts)], 2)


def _out_proj(p, out, tp=None):
    """(B, S, H, Dh) @ wo (H, Dh, d) -> (B, S, d) as one matrix product,
    summed over the heads of every rank of ``tp``."""
    B, S, H, Dh = out.shape
    wo = p["wo"]
    return all_reduce(out.reshape(B, S, H * Dh)
                      @ wo.reshape(H * Dh, wo.shape[-1]), tp)


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention): DeepSeek-V2/V3, MiniCPM3
# ---------------------------------------------------------------------------


def mla_schema(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, H = cfg.d_model, cfg.n_heads
    m: MLAConfig = cfg.mla
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    s = {}
    if m.q_lora_rank:
        s["wq_a"] = ParamSpec((d, m.q_lora_rank), ("d_model", ""))
        s["q_norm"] = ParamSpec((m.q_lora_rank,), ("",), init="ones")
        s["wq_b"] = ParamSpec((m.q_lora_rank, H, qd), ("", "heads", "head_dim"))
    else:
        s["wq_b"] = ParamSpec((d, H, qd), ("d_model", "heads", "head_dim"))
    s["wkv_a"] = ParamSpec((d, m.kv_lora_rank + m.qk_rope_head_dim),
                           ("d_model", ""))
    s["kv_norm"] = ParamSpec((m.kv_lora_rank,), ("",), init="ones")
    s["wk_b"] = ParamSpec((m.kv_lora_rank, H, m.qk_nope_head_dim),
                          ("", "heads", "head_dim"))
    s["wv_b"] = ParamSpec((m.kv_lora_rank, H, m.v_head_dim),
                          ("", "heads", "head_dim"))
    s["wo"] = ParamSpec((H, m.v_head_dim, d), ("heads", "head_dim", "d_model"))
    return s


def mla_apply(p, x, cfg: ModelConfig, *, positions, cache=None, causal=True,
              absorb: bool = False, tp=None):
    """MLA forward.  x: (B, S, d), positions: (B, S).  The cache holds
    the *compressed* pair: ``c_kv`` (B, L, kv_lora_rank) and ``k_rope``
    (B, L, qk_rope_head_dim), written IN PLACE; returns (out, cache).

    * Prefill (S > 1) writes rows ``[0, S)``, as the reference's
      ``dynamic_update_slice`` at (0, 0, 0) does (MLA does not page, so
      no suffix prefill starts past 0), and attends over the cache with
      the causal mask and ``kv_len = positions[:, -1] + 1``.
    * Decode (S == 1) writes each row at its own position.

    ``absorb=False`` (the reference's default) expands the latent into
    per-head keys and values through ``wk_b`` / ``wv_b`` and runs the
    plain :func:`attention`; ``absorb=True`` folds ``wk_b`` into the
    queries and ``wv_b`` into the output and attends in the latent
    space, in float32 throughout as the reference computes it.  Neither
    reaches a kernel: the reference's MLA has no kernel branch.

    With ``tp`` the up-projections ``wq_b`` / ``wk_b`` / ``wv_b`` and
    ``wo`` hold this rank's heads (or, where mp does not divide the
    heads, its ``head_dim`` columns of every head) and the cache's
    ``c_kv`` this rank's ``kv_lora`` columns: :func:`_mla_split`.
    """
    m: MLAConfig = cfg.mla

    # --- the query's latent, and the compressed kv: the rope part is one
    # head shared by all H
    cq = rmsnorm(p["q_norm"], x @ p["wq_a"], cfg.norm_eps) \
        if m.q_lora_rank else x
    ckv_full = x @ p["wkv_a"]
    c_kv = rmsnorm(p["kv_norm"], ckv_full[..., :m.kv_lora_rank],
                   cfg.norm_eps)
    k_rope = apply_rope(ckv_full[..., m.kv_lora_rank:][:, :, None, :],
                        positions, cfg.rope_theta)[:, :, 0]
    if tp is not None:
        out = _mla_split(p, cq, c_kv, k_rope, cfg, positions=positions,
                         cache=cache, causal=causal, absorb=absorb, tp=tp)
        return _out_proj(p, out, tp), cache

    S = x.shape[1]
    if cache is not None:
        cc, cr = cache["c_kv"], cache["k_rope"]
        if S == 1:
            # leaves (B, L, r) and (B, L, dr): the GQA step write serves
            # them, and drops a held position at L as the reference's
            # out-of-bounds scatter does (torch indexing would raise)
            _write_step(cc, c_kv[:, 0], positions[:, 0])
            _write_step(cr, k_rope[:, 0], positions[:, 0])
        else:
            cc[:, :S] = c_kv.to(cc.dtype)
            cr[:, :S] = k_rope.to(cr.dtype)
        kv_src, kr_src, kv_len = cc, cr, positions[:, -1] + 1
    else:
        kv_src, kr_src, kv_len = c_kv, k_rope, None
    out = _mla_heads(p, proj_heads(cq, p["wq_b"]), kv_src, kr_src, cfg,
                     positions=positions, kv_len=kv_len, causal=causal,
                     absorb=absorb)
    return _out_proj(p, out.to(x.dtype)), cache


def _mla_heads(p, q, kv_src, kr_src, cfg: ModelConfig, *, positions,
               kv_len, causal, absorb):
    """The attention of the heads ``q`` (B, S, H, dn + dr) holds, before
    its rope, over the latent rows ``kv_src`` (B, Skv, r) and ``kr_src``
    (B, Skv, dr); ``p["wk_b"]`` / ``p["wv_b"]`` hold the same heads.
    Returns (B, S, H, dv): float32 absorbed, the latent's dtype naive."""
    m: MLAConfig = cfg.mla
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    q_nope = q[..., :dn]
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    if absorb:
        return _mla_absorbed(p, q_nope, q_rope, kv_src, kr_src, positions,
                             kv_len, causal, 1.0 / math.sqrt(dn + dr))
    # naive: expand the latent into per-head k/v, then plain MHA
    # (its 1 / sqrt(dn + dr) scale is the query's own width)
    B, Skv = kv_src.shape[:2]
    k_nope = proj_heads(kv_src, p["wk_b"])
    v = proj_heads(kv_src, p["wv_b"])
    k = torch.cat([k_nope, kr_src[:, :, None, :].expand(
        B, Skv, q.shape[2], dr).to(k_nope.dtype)], dim=-1)
    qq = torch.cat([q_nope, q_rope], dim=-1)
    return attention(qq, k, v, q_pos=positions, kv_len=kv_len,
                     causal=causal)


def _mla_split(p, cq, c_kv, k_rope, cfg: ModelConfig, *, positions, cache,
               causal, absorb, tp):
    """The attention of an MLA layer over ``tp``: ``cq`` (the query's
    latent, or x without a q-LoRA), ``c_kv`` and ``k_rope`` are whole on
    every rank (``wq_a``, ``wkv_a`` and the norms stay whole); the
    up-projections hold this rank's heads (mp divides them: deepseek-v3's
    128 at mp = 16) or its ``head_dim`` columns of every head (minicpm3's
    40: ``wq_b`` 6 of 96 columns a rank, ``wk_b`` / ``wv_b`` 4 of 64);
    the cache's ``c_kv`` holds this rank's ``kv_lora`` columns (32 of
    512, 16 of 256) and ``k_rope`` is whole.  Returns the attention's
    output, in the activations' dtype, as ``wo`` holds it here: this
    rank's heads, or this rank's ``dv`` columns of every head.  The
    reference leaves these
    collectives to XLA; the port writes them out:

    * Every rank attends whole heads over the whole latent, with the
      single-device code (:func:`_mla_heads`, naive or absorbed), so a
      one-rank group gives the single-device numbers bit for bit.
    * The latent is whole at S > 1 (prefill, training, evaluation): the
      fresh rows, since MLA's prefill starts at row 0.  Only this rank's
      columns are written to the cache; ``k_rope`` is written whole.
    * Decode (S == 1) writes its row's columns, then all-gathers the
      cache's ``c_kv`` over ``tp`` (one gather a layer, freed before the
      next).  By the dry run's count for rank 0 of the 16 x 16 layout at
      decode_32k (8 sequences a rank, L = 32768, bf16), that is 256 MiB
      a layer at deepseek-v3 (15.25 GiB over its 61 layers) and 128 MiB
      at minicpm3 (7.75 GiB over 62).  Summing float32 partial scores
      over ``kv_lora`` instead would all-reduce B x H x L x 4 bytes a
      layer, 128 MiB and 40 MiB, plus q_lat's and the latent output's
      exchanges; but a ring all-reduce puts twice its bytes on the
      links, so at deepseek-v3 both put 240 MiB a layer on each rank's
      links (120 against 75 MiB at minicpm3); the naive route could not
      use it at all (its keys expand the whole latent: partial sums of
      ``k_nope`` would be B x L x H x dn); and every rank would run the
      softmax of every head.  The gather keeps one route for both.
    * Where the up-projections split on head_dim, the query's 6 columns
      a rank and the key's 4 do not line up (rank 10's straddle the
      nope / rope boundary at 64), so the three are all-gathered whole
      over head_dim (5.6 + 1.25 + 1.25 MiB a layer at minicpm3, bf16),
      rank r attends an uneven block of whole heads
      (:func:`_heads_of`: 3 or 2 of 40), and an all-to-all returns each
      head's ``dv`` columns to the rank ``wo`` holds them on
      (:func:`_to_columns`).  Gathering the activations instead would
      move the whole query: B x S x H x 96 x 2 bytes, gigabytes at
      prefill_32k.
    * Training runs it under a :class:`GradGroup`: the whole tensors
      enter the split products through ``f`` (``copy_to_split``: their
      gradients, each rank's heads' part, summed over ``tp``), so
      ``wq_a``, ``wkv_a`` and the norms get the whole gradient on every
      rank; each gather's backward reduce-scatters its gradient and the
      all-to-all sends it back.  The decode route takes a cache, which
      training never does."""
    group = group_of(tp)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    m: MLAConfig = cfg.mla
    cq, c_kv, k_rope = (copy_to_split(t, tp) for t in (cq, c_kv, k_rope))
    w = {k: p[k] for k in ("wq_b", "wk_b", "wv_b")}
    split_dim = w["wk_b"].shape[-1] < m.qk_nope_head_dim
    if split_dim:
        start, counts = _heads_of(cfg.n_heads, n, r)
        w = {k: gather_split(t, group, 2)[:, start:start + counts[r]]
             for k, t in w.items()}
    S = cq.shape[1]
    kv_src, kr_src, kv_len = c_kv, k_rope, None
    if cache is not None:
        cc, cr = cache["c_kv"], cache["k_rope"]
        rl = cc.shape[-1]
        cols = slice(r * rl, (r + 1) * rl)
        if S == 1:
            pos = positions[:, 0]
            _write_step(cc, c_kv[:, 0, cols], pos)
            _write_step(cr, k_rope[:, 0], pos)
            kv_src = gather_split(cc, group, 2) if rl < m.kv_lora_rank \
                else cc
            kr_src, kv_len = cr, pos + 1
        else:
            cc[:, :S] = c_kv[..., cols].to(cc.dtype)
            cr[:, :S] = k_rope.to(cr.dtype)
    # in the activations' dtype before the all-to-all (the absorbed
    # route's is float32), as on one device before wo
    out = _mla_heads(w, proj_heads(cq, w["wq_b"]), kv_src, kr_src, cfg,
                     positions=positions, kv_len=kv_len, causal=causal,
                     absorb=absorb).to(cq.dtype)
    return _to_columns(out, group, counts) if split_dim else out


def _mla_absorbed(p, q_nope, q_rope, kv_src, kr_src, positions, kv_len,
                  causal, scale):
    """Latent-space attention, float32: scores against the latent rows
    through ``wk_b`` folded into the queries, the latent output through
    ``wv_b``.  Returns (B, S, H, dv) float32."""
    f = torch.float32
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope.to(f), p["wk_b"].to(f))
    kv = kv_src.to(f)
    scores = (torch.einsum("bshr,btr->bhst", q_lat, kv)
              + torch.einsum("bshk,btk->bhst", q_rope.to(f),
                             kr_src.to(f))) * scale
    S, Skv = scores.shape[-2:]
    kv_pos = torch.arange(Skv, dtype=torch.int32, device=kv.device)
    mask = torch.ones((S, Skv), dtype=torch.bool, device=kv.device)[None]
    if causal:
        mask = mask & (kv_pos[None, None, :] <= positions[:, :, None])
    if kv_len is not None:
        mask = mask & (kv_pos[None, None, :] < kv_len[:, None, None])
    scores = scores.masked_fill(~mask[:, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhst,btr->bshr", probs, kv)
    return torch.einsum("bshr,rhv->bshv", o_lat, p["wv_b"].to(f))


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------


def mlp_schema(cfg: ModelConfig, d_ff: Optional[int] = None
               ) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    s = {
        "w_gate": ParamSpec((d, f), ("d_model", "d_ff")),
        "w_up": ParamSpec((d, f), ("d_model", "d_ff")),
        "w_down": ParamSpec((f, d), ("d_ff", "d_model")),
    }
    if cfg.use_bias:
        s["b_ff"] = ParamSpec((f,), ("d_ff",), init="zeros")
        s["b_out"] = ParamSpec((d,), ("d_model",), init="zeros")
    return s


def mlp_apply(p, x, tp=None):
    """SwiGLU; with ``tp`` over this rank's ``d_ff`` columns, the down
    projection summed over ``tp`` before ``b_out``."""
    x = copy_to_split(x, tp)
    h = torch.nn.functional.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    if "b_ff" in p:
        h = h + p["b_ff"]
    out = all_reduce(h @ p["w_down"], tp)
    if "b_out" in p:
        out = out + p["b_out"]
    return out
