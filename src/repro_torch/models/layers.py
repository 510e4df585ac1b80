"""Core layer primitives: norms, rope, GQA attention, MLP.

Plain functions over explicit parameter dicts, mirroring the reference's
``models/layers.py`` leaf for leaf.  The GQA path is ported with every
cache layout the serving engine has: no cache, the dense slot cache and
the paged pool, each in the config's dtype or int8.  The reference's
ring-buffer and cross-attention branches raise ``NotImplementedError``
naming the ``ROADMAP.md`` item that ports them.

Cached decode attention always goes through a kernel wrapper:
:func:`repro_torch.kernels.flash_decode.flash_decode` over the dense
slot cache, :func:`repro_torch.kernels.paged_flash_decode.
paged_flash_decode` through the block table — the hand-written CUDA
kernels on the card, their plain PyTorch versions for CPU tensors.
The no-cache branch takes :func:`repro_torch.kernels.flash_attention.
flash_attention` under the reference's condition
(``cfg.use_pallas_attention``, causal, no window or softcap, Sq == Skv,
Sq % 128 == 0); it has no gradient, as the reference's kernel has none.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.core.config import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.paged_flash_decode import paged_flash_decode
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
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
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


def _attn_block(q, k, v, q_pos, kv_pos, kv_len, *, causal, window, softcap):
    """One query block against full kv.

    q: (B, Sq, Hkv, G, Dh)  k/v: (B, Skv, Hkv, Dh)
    q_pos: (B, Sq)  kv_pos: (Skv,)  kv_len: (B,) or None
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
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
              softcap=0.0, q_chunk=1024):
    """Grouped-query attention with query chunking.

    q: (B, Sq, H, Dh), k/v: (B, Skv, Hkv, Dh).
    q_pos: (B, Sq) absolute positions of queries.
    kv_len: (B,) valid cache length (None = all Skv valid).
    """
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, Dh)
    kv_pos = torch.arange(Skv, dtype=torch.int32, device=q.device)

    if Sq <= q_chunk or Sq % q_chunk != 0:
        out = _attn_block(qg, k, v, q_pos, kv_pos, kv_len,
                          causal=causal, window=window, softcap=softcap)
        return out.reshape(B, Sq, H, Dv)

    outs = [_attn_block(qg[:, i:i + q_chunk], k, v, q_pos[:, i:i + q_chunk],
                        kv_pos, kv_len, causal=causal, window=window,
                        softcap=softcap)
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


def _proj_heads(x, w):
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


def gqa_apply(p, x, cfg: ModelConfig, *, positions, cache=None, window=0,
              causal=True, cross_kv=None, ring=False, page_table=None):
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
    """
    if cross_kv is not None:
        raise NotImplementedError(
            "cross-attention: ROADMAP.md queue 1, item 8 (Whisper)")
    if ring and window:
        raise NotImplementedError(
            "ring-buffer sliding-window cache: ROADMAP.md queue 1, item 8")

    B, S, d = x.shape
    q = _proj_heads(x, p["wq"])
    k = _proj_heads(x, p["wk"])
    v = _proj_heads(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k, v = k + p["bk"], v + p["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        if (cfg.use_pallas_attention and causal and not window
                and not cfg.attn_logit_softcap and q.shape[1] == k.shape[1]
                and q.shape[1] % 128 == 0):
            out = flash_attention(q, k, v, causal=True)
        else:
            out = attention(q, k, v, q_pos=positions, causal=causal,
                            window=window, softcap=cfg.attn_logit_softcap,
                            q_chunk=cfg.attn_q_chunk)
    elif S == 1 and page_table is not None:
        # paged decode: write this step's k/v into the page holding
        # `pos`, read back through the block table
        quant = "k_q" in cache
        pool = cache["k_q"] if quant else cache["k"]
        NP, ps = pool.shape[:2]
        MB = page_table.shape[1]
        pos = positions[:, 0]
        blk = pos // ps
        keep = blk < MB
        page = page_table[torch.arange(B, device=x.device),
                          blk.clamp(max=MB - 1)].long().clamp(0, NP - 1)
        off = (pos % ps).long()
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
        out = paged_flash_decode(q[:, 0], pk, pv, page_table, pos + 1)
        out = out[:, None].to(v.dtype)
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
        if S == 1:
            # kv_len masking subsumes the causal mask at decode
            out = flash_decode(q[:, 0], ck, cv, kv_len)[:, None]
            out = out.to(v.dtype)
        else:
            out = attention(q, ck, cv, q_pos=positions, kv_len=kv_len,
                            causal=causal, window=window,
                            softcap=cfg.attn_logit_softcap,
                            q_chunk=cfg.attn_q_chunk)
    H, Dh = out.shape[-2:]
    wo = p["wo"]
    out = out.reshape(B, S, H * Dh) @ wo.reshape(H * Dh, wo.shape[-1])
    return out, cache


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------


def mlp_schema(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    s = {
        "w_gate": ParamSpec((d, f), ("d_model", "d_ff")),
        "w_up": ParamSpec((d, f), ("d_model", "d_ff")),
        "w_down": ParamSpec((f, d), ("d_ff", "d_model")),
    }
    if cfg.use_bias:
        s["b_ff"] = ParamSpec((f,), ("d_ff",), init="zeros")
        s["b_out"] = ParamSpec((d,), ("d_model",), init="zeros")
    return s


def mlp_apply(p, x):
    h = torch.nn.functional.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    if "b_ff" in p:
        h = h + p["b_ff"]
    out = h @ p["w_down"]
    if "b_out" in p:
        out = out + p["b_out"]
    return out
