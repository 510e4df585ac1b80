"""Model assembly for the dense GQA, multi-head latent attention,
mixture-of-experts, Mamba2, vision-language and encoder-decoder
families.

Mirrors the reference's ``models/transformer.py``: layers are grouped
into an optional unrolled prefix followed by ``n_blocks`` repeats of a
block of ``P`` layers, and the parameters and caches of the repeats are
stacked on a leading ``n_blocks`` dim — the same tree, so parameters
carry across from the reference leaf for leaf.  Where the reference
scans over the stack, the port loops over it and takes a view of each
slice.

Scope: dense GQA decoders (the ``qwen1.5-32b`` and ``command-r-35b``
families, and ``gemma3-12b``'s sliding-window local layers beside its
global ones, with the reference's ring cache under
``window_ring_cache`` and its logit softcap), with the dense slot cache
or the paged pool, each in the config's dtype or int8
(``kv_quant_int8``; a ring layer keeps the config's dtype);
multi-head latent attention (``attn_type="mla"``: the ``minicpm3-4b``
and ``deepseek-v3-671b`` families) with its compressed dense slot cache
(``c_kv``, ``k_rope``; never paged or quantized, as in the reference) and
the reference's naive and absorbed (``mla_absorb``) decode;
mixture-of-experts FFNs (``cfg.moe``: :mod:`repro_torch.models.moe`,
the ``dbrx-132b`` family) with the reference's ``first_k_dense`` prefix
and ``moe_period``; Mamba2 stacks (``"M"`` layers, the ``mamba2-130m``
family: :mod:`repro_torch.models.ssm`) and their mixes with attention
and MoE (``jamba-1.5-large-398b``) with the dense slot cache of conv
tails and SSM states (the paged pool raises for them, as the
reference's does); and the no-cache training forward with its losses
for all of them, the MoE load-balance loss summed over the layers as
the reference sums it, and DeepSeek-V3's multi-token prediction
(``mtp_depth``: one extra dense layer on the final stream and the next
token's embedding, its logits in ``forward_train`` and its loss term in
``forward_train_loss`` / ``loss_fn``); Phi-3-vision's patch projector
(``modality="vision"``: ``gelu(image_emb @ w1) @ w2``, tanh gelu as
``jax.nn.gelu``'s default, prepended to the token embeddings, in the
no-cache forward and at prefill, so positions and the cache count the
576 image positions; the losses keep the last ``S_txt`` positions);
Whisper's encoder-decoder (``is_encoder_decoder``: ``_encode`` runs
``n_encoder_layers`` non-causal layers over the stub frame embeddings
plus ``enc_pos``; each decoder layer has a cross-attention sublayer
whose keys and values are projected from the encoder's output, or,
without ``audio_emb``, read from the cache's ``cross_k`` / ``cross_v``,
as the reference's served decode reads them).  The stub embeddings are
cast to the weights' dtype on the way in (the reference casts the
image's, and promotes a float32 frame embedding's sums past bf16
weights; the port's matrix products take one dtype).  ``moe_fn``, as in
the reference, replaces :func:`~repro_torch.models.moe.moe_apply_ragged`
in every MoE layer of every forward (the expert-parallel block of
:func:`repro_torch.launch.moe_parallel.make_ep_moe_fn`); ``None``
changes nothing.

Tensor-parallel serving: the cached forward takes ``tp``, the model
axis's process group (``None``: one device, unchanged), and threads it
through :func:`apply_layer` as the reference threads ``moe_fn``.  Each
rank holds the shards :data:`TP_AXES` names — the vocab rows of the
embedding, its heads and kv heads (or, where mp does not divide them,
its ``head_dim`` columns; MLA's cached latent's ``kv_lora`` columns),
its ``d_ff`` / ``d_ff_expert`` columns — and four collectives make the
whole function: the embedding lookup masks the ids outside the rank's
rows and all-reduces, the attention and FFN output projections
all-reduce, and the logits are all-gathered over the vocab in rank
order (so argmax ties resolve as on one device); an attention layer
split on ``head_dim`` adds its own (see
:func:`repro_torch.models.layers.gqa_apply`), and an MLA layer its
decode's gather of the latent (:func:`repro_torch.models.layers.
mla_apply`).
:func:`check_tensor_parallel` refuses any other placement.

Training: gradients reach the stacked ``blocks`` leaves through the
per-slice views, so ``.grad`` (or ``torch.autograd.grad``) of a stacked
leaf holds every block's gradient, as JAX's scan gives it.  ``cfg.remat``
rematerializes each block in the backward pass: ``"full"`` keeps only
the block's input, ``"dots"`` also keeps the outputs of the weight
products (``aten.mm`` / ``aten.addmm``: the counterpart of
``dots_with_no_batch_dims_saveable``), ``"none"`` keeps everything.

Sharded training (:mod:`repro_torch.training.sharded`) passes the
training forward two more hooks: ``tp``, the model axis as a
:class:`~repro_torch.models.collectives.GradGroup` (the serving apply's
collectives with gradients, the logits gathered over the vocab with
this rank's slice of their gradient), and ``gather(tree, path)``, the
FSDP gather of the weights at ``path`` (``("blocks", i)`` is block i's
slice of the stack).  Each layer's weights are gathered inside the
layer's rematerialized body, so the backward pass gathers them again and
no gathered layer outlives its use; with ``gather`` every layer is
rematerialized, under ``remat="none"`` too.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.collectives import (GradGroup, copy_to_split,
                                            gather_shared, group_of)
from repro_torch.models.moe import moe_apply_ragged, moe_schema
from repro_torch.models.schema import ParamSpec, stack_specs, tree_map
from repro_torch.models.ssm import ssm_apply, ssm_cache_schema, ssm_schema
from repro_torch.serving import kv_quant as KQ


@dataclass(frozen=True)
class LayerSig:
    kind: str          # "A" | "M"
    window: int        # 0 = full attention
    is_moe: bool
    cross: bool        # enc-dec decoder cross-attention sublayer
    causal: bool = True


# the multi-token-prediction layer: dense attention with an MLP of d_ff
MTP_SIG = LayerSig("A", 0, False, False)
# a Whisper encoder layer: non-causal self-attention, no cross sublayer
ENC_SIG = LayerSig("A", 0, False, False, causal=False)
# weight of the MTP cross-entropy in both losses (the reference's default
# for forward_train_loss and loss_fn, src/repro/models/transformer.py:519,
# :580, which no caller changes)
MTP_WEIGHT = 0.3


def _lcm(a, b):
    return a * b // math.gcd(a, b)


def _check_supported(cfg: ModelConfig) -> None:
    """Raise for a config the layers cannot build."""
    kinds = {cfg.layer_kind(i) for i in range(cfg.n_layers)}
    if "M" in kinds and cfg.ssm is None:
        raise ValueError(f"{cfg.name}: Mamba layers need cfg.ssm")
    if cfg.attn_type == "mla" and cfg.mla is None:
        raise ValueError(f"{cfg.name}: attn_type='mla' needs cfg.mla")
    if "A" in kinds and cfg.attn_type not in ("gqa", "mla"):
        raise ValueError(f"{cfg.name}: attention layers with "
                         f"attn_type={cfg.attn_type!r}; gqa or mla")


def layer_structure(cfg: ModelConfig) -> Tuple[List[LayerSig], List[LayerSig], int]:
    """Returns (prefix_sigs, block_sigs, n_blocks)."""
    _check_supported(cfg)

    def sig(i: int) -> LayerSig:
        kind = cfg.layer_kind(i)
        window = 0
        if kind == "A" and cfg.sliding_window and cfg.attn_kind(i) == "L":
            window = cfg.sliding_window
        return LayerSig(kind, window, cfg.is_moe_layer(i),
                        cfg.is_encoder_decoder)

    prefix_n = cfg.moe.first_k_dense if cfg.moe else 0
    P = _lcm(_lcm(len(cfg.layer_pattern) or 1, len(cfg.attn_pattern) or 1),
             cfg.moe.moe_period if cfg.moe else 1)
    rest = cfg.n_layers - prefix_n
    if rest % P:
        raise ValueError(f"{cfg.name}: {rest} layers not divisible by "
                         f"period {P}")
    prefix = [sig(i) for i in range(prefix_n)]
    block = [sig(prefix_n + j) for j in range(P)]
    for b in range(rest // P):
        for j in range(P):
            if sig(prefix_n + b * P + j) != block[j]:
                raise ValueError(f"{cfg.name}: layer {prefix_n + b * P + j} "
                                 f"breaks the period of {P}")
    return prefix, block, rest // P


def _layer_schema(cfg: ModelConfig, s: LayerSig) -> Dict[str, Any]:
    d = cfg.d_model
    out: Dict[str, Any] = {"ln1": L.rmsnorm_schema(d)}
    if s.kind == "M":
        out["ssm"] = ssm_schema(cfg)
    elif cfg.attn_type == "mla":
        out["attn"] = L.mla_schema(cfg)
    else:
        out["attn"] = L.gqa_schema(cfg)
    if s.cross and s.kind == "A":
        out["ln_cross"] = L.rmsnorm_schema(d)
        out["cross"] = L.gqa_schema(cfg)
    # ln2 stays without an MLP (Mamba2: d_ff = 0), as in the reference
    out["ln2"] = L.rmsnorm_schema(d)
    if s.is_moe:
        out["moe"] = moe_schema(cfg)
    elif s.kind == "A" or cfg.d_ff:
        out["mlp"] = L.mlp_schema(cfg)
    return out


def apply_layer(p, x, cfg: ModelConfig, s: LayerSig, *, positions,
                cache=None, page_table=None, mla_absorb: bool = False,
                enc_out=None, tp=None, moe_fn=None):
    """One residual block.  Returns (x, cache, aux): the cache is updated
    in place (see :func:`repro_torch.models.layers.gqa_apply`,
    :func:`repro_torch.models.layers.mla_apply` and
    :func:`repro_torch.models.ssm.ssm_apply`), aux is the MoE layer's
    load-balance loss (0.0 for any other layer).

    A decoder layer of an encoder-decoder (``s.cross``) adds the
    cross-attention sublayer after the self-attention: with ``enc_out``
    (B, T, d) its keys and values are projected from it, and written
    over the cache's ``cross_k`` / ``cross_v`` when there is a cache;
    without, they are read from the cache.

    ``tp``: the tensor-parallel group of the GQA, MLA and FFN sublayers
    (see the module docstring); Mamba2 layers take none
    (:func:`check_tensor_parallel` keeps them whole on every rank).
    ``moe_fn(p, x, cfg) -> (y, aux)`` replaces ``moe_apply_ragged`` in
    an MoE layer and brings its own collectives."""
    aux = 0.0
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if s.kind == "M":
        out, cache = ssm_apply(p["ssm"], h, cfg, cache=cache)
    elif cfg.attn_type == "mla":
        out, cache = L.mla_apply(p["attn"], h, cfg, positions=positions,
                                 cache=cache, absorb=mla_absorb, tp=tp)
    else:
        out, cache = L.gqa_apply(p["attn"], h, cfg, positions=positions,
                                 cache=cache, window=s.window,
                                 causal=s.causal,
                                 ring=bool(cfg.window_ring_cache
                                           and s.window),
                                 page_table=page_table, tp=tp)
    x = x + out
    if s.cross and s.kind == "A":
        hc = L.rmsnorm(p["ln_cross"], x, cfg.norm_eps)
        if enc_out is not None:
            ck = L.proj_heads(enc_out, p["cross"]["wk"])
            cv = L.proj_heads(enc_out, p["cross"]["wv"])
            if cache is not None:
                cache["cross_k"].copy_(ck)
                cache["cross_v"].copy_(cv)
        else:
            ck, cv = cache["cross_k"], cache["cross_v"]
        out, _ = L.gqa_apply(p["cross"], hc, cfg, positions=positions,
                             cross_kv=(ck, cv), tp=tp)
        x = x + out
    if s.is_moe:
        h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
        ff, aux = (moe_apply_ragged(p["moe"], h, cfg, tp=tp)
                   if moe_fn is None else moe_fn(p["moe"], h, cfg))
        x = x + ff
    elif "mlp" in p:
        # the reference adds an FFN term of 0.0 when there is no MLP
        x = x + L.mlp_apply(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps),
                            tp)
    return x, cache, aux


# The leaves the tensor-parallel apply splits over the model axis, by
# the end of their path, with the logical axes each one may split on
# there (``None``: whole): the weights of the GQA, MLA and FFN
# sublayers and the attention caches (the dense slot cache or page pool,
# int8 or not; MLA's latent pair).  The attention's leaves split on
# their heads, or, where the resolver falls back because the mesh's mp
# does not divide the head count, on ``head_dim``
# (:func:`repro_torch.models.layers.gqa_apply`'s head_dim route,
# :func:`repro_torch.models.layers._mla_split`); the int8 scales have no
# head_dim and stay whole then.  MLA's cached latent ``c_kv`` splits on
# ``kv_lora``, its ``k_rope`` stays whole.  Every other leaf stays whole
# on each rank.
TP_AXES = {
    "embed": ("vocab",), "lm_head": ("vocab",),
    **{f"attn/{w}": ("heads", "head_dim")
       for w in ("wq", "bq", "wo", "wq_b", "wk_b", "wv_b")},
    **{f"attn/{w}": ("kv_heads", "head_dim")
       for w in ("wk", "wv", "bk", "bv")},
    **{f"{m}/{w}": ("d_ff",) for m in ("mlp", "shared")
       for w in ("w_gate", "w_up", "w_down", "b_ff")},
    **{f"moe/{w}": ("d_ff_expert",) for w in ("w_gate", "w_up", "w_down")},
    **{c: ("kv_heads", "head_dim") for c in ("k", "v", "k_q", "v_q")},
    **{c: ("kv_heads", None) for c in ("k_s", "v_s")},
    "c_kv": ("kv_lora",), "k_rope": (None,),
}


def check_tensor_parallel(named, mp: int) -> None:
    """Refuse a placement the tensor-parallel apply (serving's, and the
    sharded train step's) has no collective for.  ``named`` holds
    ``(leaf name, ParamSpec, spec)`` of every parameter and cache leaf;
    at ``mp > 1`` each leaf of :data:`TP_AXES` must split on one of its
    axes there, and no other leaf may split over ``model``: Mamba2's
    ``d_inner``, Whisper's cross layers, and Whisper's encoder, which
    runs without ``tp``.  The MTP layer's leaves (``mtp/...``) split as
    a block's do."""
    if mp <= 1:
        return
    for name, ps, spec in named:
        whole = name.startswith("encoder/")
        want = (None,) if whole else next(
            (axes for key, axes in TP_AXES.items()
             if name == key or name.endswith("/" + key)), (None,))
        got = next((ps.axes[i] for i, e in enumerate(spec)
                    if e == "model"), None)
        if got not in want:
            names = " or ".join(a or "no axis" for a in want)
            raise ValueError(
                f"tensor parallelism at mp={mp} has no collective "
                f"for {name} {ps.shape} {ps.axes} resolved to {spec} "
                f"(the apply splits it on {names}): serving "
                f"or training this family at mp > 1 is ROADMAP.md queue "
                f"1, item 9, next 2")


def _layer_cache_schema(cfg: ModelConfig, s: LayerSig, batch: int,
                        max_len: int) -> Dict[str, ParamSpec]:
    out = _self_cache_schema(cfg, s, batch, max_len)
    if s.cross and s.kind == "A":
        # the encoder's keys and values, written at prefill with
        # audio_emb (zeros until then), in the config's dtype
        ckv = (batch, cfg.encoder_seq_len, cfg.n_kv_heads, cfg.head_dim)
        axes = ("batch", "", "kv_heads", "head_dim")
        out["cross_k"] = ParamSpec(ckv, axes, cfg.dtype, "zeros")
        out["cross_v"] = ParamSpec(ckv, axes, cfg.dtype, "zeros")
    return out


def _self_cache_schema(cfg: ModelConfig, s: LayerSig, batch: int,
                       max_len: int) -> Dict[str, ParamSpec]:
    if s.kind == "M":
        return ssm_cache_schema(cfg, batch)
    if cfg.attn_type == "mla":
        # the compressed pair, in the config's dtype: kv_quant_int8 does
        # not reach it, as in the reference
        m = cfg.mla
        return {"c_kv": ParamSpec((batch, max_len, m.kv_lora_rank),
                                  ("batch", "seq", "kv_lora"), cfg.dtype,
                                  "zeros"),
                "k_rope": ParamSpec((batch, max_len, m.qk_rope_head_dim),
                                    ("batch", "seq", ""), cfg.dtype,
                                    "zeros")}
    # with cfg.window_ring_cache a windowed layer holds a ring of
    # `window` rows instead of max_len, never quantized
    ring = bool(cfg.window_ring_cache and s.window)
    span = min(max_len, s.window) if ring else max_len
    if cfg.kv_quant_int8 and not ring:
        # int8 payload + float16 per-position scales
        return KQ.quant_kv_cache_schema(batch, span, cfg.n_kv_heads,
                                        cfg.head_dim)
    kv = (batch, span, cfg.n_kv_heads, cfg.head_dim)
    axes = ("batch", "seq", "kv_heads", "head_dim")
    return {"k": ParamSpec(kv, axes, cfg.dtype, "zeros"),
            "v": ParamSpec(kv, axes, cfg.dtype, "zeros")}


# ---------------------------------------------------------------------------
# Parameter schema for the full model
# ---------------------------------------------------------------------------


def _retag_dtype(schema, dtype: str):
    """ParamSpecs default to bf16; retag to cfg.dtype (f32 smoke tests)."""
    if dtype == "bfloat16":
        return schema
    return tree_map(
        lambda s: (s if s.dtype != "bfloat16"
                   else ParamSpec(s.shape, s.axes, dtype, s.init, s.scale)),
        schema)


def decoder_param_schema(cfg: ModelConfig) -> Dict[str, Any]:
    d, V = cfg.d_model, cfg.padded_vocab
    prefix, block, n_blocks = layer_structure(cfg)
    schema: Dict[str, Any] = {
        "embed": ParamSpec((V, d), ("vocab", "d_model")),
        "final_norm": L.rmsnorm_schema(d),
        "prefix": [_layer_schema(cfg, s) for s in prefix],
        "blocks": stack_specs(
            {f"p{j}": _layer_schema(cfg, s) for j, s in enumerate(block)},
            n_blocks),
    }
    if not cfg.tie_embeddings:
        schema["lm_head"] = ParamSpec((V, d), ("vocab", "d_model"))
    if cfg.modality == "vision":
        me = cfg.modality_embed_dim
        schema["projector"] = {
            "w1": ParamSpec((me, d), ("", "d_model")),
            "w2": ParamSpec((d, d), ("d_model", "d_model2")),
        }
    if cfg.is_encoder_decoder:
        schema["enc_pos"] = ParamSpec((cfg.encoder_seq_len, d),
                                      ("", "d_model"), init="small")
        schema["encoder"] = stack_specs(_layer_schema(cfg, ENC_SIG),
                                        cfg.n_encoder_layers)
        schema["enc_final_norm"] = L.rmsnorm_schema(d)
    if cfg.mtp_depth:
        schema["mtp"] = {
            "norm_h": L.rmsnorm_schema(d),
            "norm_e": L.rmsnorm_schema(d),
            "w_comb": ParamSpec((2 * d, d), ("", "d_model")),
            "layer": _layer_schema(cfg, MTP_SIG),
            "final_norm": L.rmsnorm_schema(d),
        }
    return _retag_dtype(schema, cfg.dtype)


def init_cache_schema(cfg: ModelConfig, batch: int, max_len: int) -> Dict[str, Any]:
    """Decode-cache spec tree (mirrors the param block structure)."""
    prefix, block, n_blocks = layer_structure(cfg)
    return {
        "pos": ParamSpec((batch,), ("batch",), "int32", "zeros"),
        "prefix": [_layer_cache_schema(cfg, s, batch, max_len) for s in prefix],
        "blocks": stack_specs(
            {f"p{j}": _layer_cache_schema(cfg, s, batch, max_len)
             for j, s in enumerate(block)}, n_blocks),
    }


def paged_cache_schema(cfg: ModelConfig, num_slots: int, num_pages: int,
                       page_size: int, max_blocks: int) -> Dict[str, Any]:
    """Paged decode-cache spec tree (a block pool).

    Per layer: a global pool of ``num_pages`` K/V pages of ``page_size``
    positions — :func:`_layer_cache_schema` with ``batch=num_pages,
    max_len=page_size``, int8 included.  On top: a per-slot ``table``
    (num_slots, max_blocks) int32 shared across layers, and the usual
    per-slot ``pos``.  Only GQA stacks page, windowed layers included
    (their rows are position-addressed like a global layer's); a ring
    layer does not, as in the reference.
    """
    prefix, block, n_blocks = layer_structure(cfg)
    for s in prefix + block:
        if (s.kind != "A" or s.cross or cfg.attn_type == "mla"
                or (cfg.window_ring_cache and s.window)):
            raise ValueError(
                f"{cfg.name}: paged KV cache supports full-attention "
                f"GQA layers only (got kind={s.kind} cross={s.cross} "
                f"attn_type={cfg.attn_type} ring={bool(s.window)})")
    return {
        "pos": ParamSpec((num_slots,), ("batch",), "int32", "zeros"),
        "table": ParamSpec((num_slots, max_blocks), ("batch", ""),
                           "int32", "zeros"),
        "prefix": [_layer_cache_schema(cfg, s, num_pages, page_size)
                   for s in prefix],
        "blocks": stack_specs(
            {f"p{j}": _layer_cache_schema(cfg, s, num_pages, page_size)
             for j, s in enumerate(block)}, n_blocks),
    }


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _embed_lookup(params, cfg: ModelConfig, tokens, tp=None):
    """Gather (default) or the one-hot product of the reference's
    ``embed_one_hot`` (its §Perf H6 option).  With ``tp`` the rank holds
    a block of vocab rows: ids outside it gather zeros, and the sum over
    ``tp`` gives each id its row (the one-hot product's exact value)."""
    if tp is not None:
        w = params["embed"]
        rows = w.shape[0]
        local = tokens.long() - dist.get_rank(group_of(tp)) * rows
        inside = (local >= 0) & (local < rows)
        x = w[local.clamp(0, rows - 1)].masked_fill(~inside[..., None], 0)
        return L.all_reduce(x, tp)
    if cfg.embed_one_hot:
        w = params["embed"]
        return F.one_hot(tokens.long(), w.shape[0]).to(w.dtype) @ w
    return params["embed"][tokens]


def _unembed(params, cfg: ModelConfig, x, tp=None):
    """Logits in float32; with ``tp`` the rank's vocab block, gathered
    over ``tp`` in rank order into the whole vocab."""
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    if isinstance(tp, GradGroup):
        logits = (copy_to_split(x, tp) @ w.T).float()
        return gather_shared(logits, tp.group, logits.dim() - 1)
    logits = (x @ w.T).float()
    if tp is None:
        return logits
    parts = [torch.empty_like(logits) for _ in range(dist.get_world_size(tp))]
    dist.all_gather(parts, logits.contiguous(), group=tp)
    return torch.cat(parts, dim=-1)


def _slice(tree, i: int):
    """Views of slice ``i`` of a stacked tree: in-place writes to a
    cache slice land in the stacked cache."""
    return {k: _slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _project_image(params, image_emb, dtype):
    """Phi-3-vision's projector over the stub patch embeddings (B, P,
    modality_embed_dim): ``gelu(image_emb @ w1) @ w2``, with the tanh
    gelu of ``jax.nn.gelu``'s default."""
    pj = params["projector"]
    h = F.gelu(image_emb.to(dtype) @ pj["w1"], approximate="tanh")
    return h @ pj["w2"]


def _prepend_image(params, cfg: ModelConfig, inputs, x):
    """The token embeddings ``x`` after the projected image, where the
    config takes one and ``inputs`` has ``image_emb``."""
    if cfg.modality != "vision" or "image_emb" not in inputs:
        return x
    return torch.cat([_project_image(params, inputs["image_emb"], x.dtype),
                      x], dim=1)


def _gathered(gather, tree, *path):
    """``tree``, the params at ``path``, as a layer reads them: through
    the sharded step's FSDP ``gather`` (module docstring), else as it
    is."""
    return tree if gather is None else gather(tree, path)


def _encode(params, cfg: ModelConfig, audio_emb, gather=None):
    """Whisper's encoder over the stub frame embeddings (B, T, d), T =
    ``encoder_seq_len``: ``enc_pos`` added, ``n_encoder_layers``
    non-causal layers (rope on, as in the reference), the final norm.
    With ``gather`` (and autograd on) each layer is rematerialized."""
    w = _gathered(gather, params["enc_pos"], "enc_pos")
    x = audio_emb.to(w.dtype) + w[None]
    B, T, _ = x.shape
    positions = torch.arange(T, dtype=torch.int32,
                             device=x.device)[None].expand(B, T)

    def layer(h, lp, i):
        lp = _gathered(gather, lp, "encoder", i)
        return apply_layer(lp, h, cfg, ENC_SIG, positions=positions)[0]

    remat = gather is not None and torch.is_grad_enabled()
    for i in range(cfg.n_encoder_layers):
        lp = _slice(params["encoder"], i)
        x = (checkpoint(layer, x, lp, i, use_reentrant=False) if remat
             else layer(x, lp, i))
    return L.rmsnorm(_gathered(gather, params["enc_final_norm"],
                               "enc_final_norm"), x, cfg.norm_eps)


def forward_prefill(params, cfg: ModelConfig, inputs, cache, *,
                    moe_fn=None, mla_absorb: bool = False, tp=None):
    """Prefill: run the full prompt, fill the cache, return last logits."""
    return _forward_cached(params, cfg, inputs, cache, prefill=True,
                           moe_fn=moe_fn, mla_absorb=mla_absorb, tp=tp)


def forward_decode(params, cfg: ModelConfig, inputs, cache, *,
                   moe_fn=None, mla_absorb: bool = False, tp=None):
    """One decode step: inputs["tokens"] is (B, 1)."""
    return _forward_cached(params, cfg, inputs, cache, prefill=False,
                           moe_fn=moe_fn, mla_absorb=mla_absorb, tp=tp)


def _forward_cached(params, cfg, inputs, cache, *, prefill, mla_absorb,
                    moe_fn=None, tp=None):
    """Returns (logits (B, 1, V) float32 of the last position, cache).
    The cache dict is updated in place and returned: its k/v leaves are
    written where they lie, and ``cache["pos"]`` is replaced by the
    advanced positions.  ``mla_absorb`` picks the MLA layers' absorbed
    attention (it changes nothing elsewhere); ``tp`` is the
    tensor-parallel group and ``moe_fn`` the MoE layers' block (module
    docstring)."""
    prefix, block, n_blocks = layer_structure(cfg)
    tokens = inputs["tokens"]
    B, S = tokens.shape
    x = _embed_lookup(params, cfg, tokens, tp)
    if prefill:
        # the image's positions come first and are cached with the text's
        x = _prepend_image(params, cfg, inputs, x)
        S = x.shape[1]
    # with audio_emb the decoder's cross caches are written from the
    # encoder; without (a served request) they are read as they are
    enc_out = (_encode(params, cfg, inputs["audio_emb"])
               if cfg.is_encoder_decoder and "audio_emb" in inputs else None)

    if prefill:
        # "pos0" (B,) shifts each row's positions: a paged suffix
        # prefill runs only tokens [pos0, pos0 + S) against a scratch
        # cache whose [0, pos0) rows hold the gathered shared prefix
        steps = torch.arange(S, dtype=torch.int32, device=tokens.device)
        pos0 = inputs.get("pos0")
        if pos0 is None:
            positions = steps[None].expand(B, S)
            new_pos = torch.full((B,), S, dtype=torch.int32,
                                 device=tokens.device)
        else:
            positions = pos0[:, None] + steps[None]
            new_pos = pos0 + S
    else:
        positions = cache["pos"][:, None]
        new_pos = cache["pos"] + 1

    # paged slot cache: the per-slot block table, shared across layers;
    # prefill runs on the dense scratch and never sees one
    page_table = None if prefill else cache.get("table")

    for lp, lc, s in zip(params["prefix"], cache["prefix"], prefix):
        x, _, _ = apply_layer(lp, x, cfg, s, positions=positions,
                              cache=lc, page_table=page_table,
                              mla_absorb=mla_absorb, enc_out=enc_out, tp=tp,
                              moe_fn=moe_fn)
    for i in range(n_blocks):
        bp, bc = _slice(params["blocks"], i), _slice(cache["blocks"], i)
        for j, s in enumerate(block):
            x, _, _ = apply_layer(bp[f"p{j}"], x, cfg, s,
                                  positions=positions, cache=bc[f"p{j}"],
                                  page_table=page_table,
                                  mla_absorb=mla_absorb, enc_out=enc_out,
                                  tp=tp, moe_fn=moe_fn)
    cache["pos"] = new_pos

    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _unembed(params, cfg, x[:, -1:], tp), cache


# ---------------------------------------------------------------------------
# No-cache forward (training, evaluation) and losses
# ---------------------------------------------------------------------------


def _embed_inputs(params, cfg: ModelConfig, inputs: Dict[str, torch.Tensor],
                  tp=None, gather=None):
    """Token embedding, after the projected image where there is one.
    Returns (x, positions)."""
    tokens = inputs["tokens"]
    front = {k: _gathered(gather, params[k], k)
             for k in ("embed", "projector") if k in params}
    x = _prepend_image(front, cfg, inputs,
                       _embed_lookup(front, cfg, tokens, tp))
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    return x, positions


def _save_weight_products(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the outputs
    of the 2-D weight products, recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _backbone(params, cfg: ModelConfig, inputs, *, moe_fn=None, tp=None,
              gather=None):
    """Embedding (and the encoder, for an encoder-decoder: not
    rematerialized, as in the reference) and every decoder layer, under
    ``cfg.remat``.  Returns the hidden states before the final norm and
    the MoE load-balance loss summed over the layers (0 without an MoE
    layer).  ``moe_fn``, ``tp``, ``gather``: the module docstring; with
    ``gather`` the prefix layers and the encoder's are rematerialized
    too."""
    prefix, block, n_blocks = layer_structure(cfg)
    x, positions = _embed_inputs(params, cfg, inputs, tp, gather)
    enc_out = (_encode(params, cfg, inputs["audio_emb"], gather)
               if cfg.is_encoder_decoder else None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(h, acc, tree, enc, path):
        # prefix layer path[1], or block path[1]'s layers p0, p1, ...
        tree = _gathered(gather, tree, *path)
        layers = ([(tree, prefix[path[1]])] if path[0] == "prefix"
                  else [(tree[f"p{j}"], s) for j, s in enumerate(block)])
        for lp, s in layers:
            h, _, a = apply_layer(lp, h, cfg, s, positions=positions,
                                  enc_out=enc, tp=tp, moe_fn=moe_fn)
            acc = acc + a
        return h, acc

    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"{cfg.name}: unknown remat {cfg.remat!r}")
    # nothing is saved for a backward pass when autograd is off
    remat = ((cfg.remat != "none" or gather is not None)
             and torch.is_grad_enabled())
    kw = ({"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _save_weight_products)}
          if cfg.remat == "dots" else {})
    for j, lp in enumerate(params["prefix"]):
        path = ("prefix", j)
        x, aux = (checkpoint(body, x, aux, lp, enc_out, path,
                             use_reentrant=False, **kw)
                  if remat and gather is not None
                  else body(x, aux, lp, enc_out, path))
    for i in range(n_blocks):
        bp, path = _slice(params["blocks"], i), ("blocks", i)
        x, aux = (checkpoint(body, x, aux, bp, enc_out, path,
                             use_reentrant=False, **kw)
                  if remat else body(x, aux, bp, enc_out, path))
    return x, aux


def _mtp_hidden(params, cfg: ModelConfig, h_final, tokens, gather=None,
                tp=None):
    """DeepSeek-V3's multi-token prediction (depth 1): the final stream
    at t (before the final norm) beside the embedding of token t + 1,
    combined and run through one extra dense layer, then its own final
    norm.  Returns (B, S - 1, d): position t predicts token t + 2 through
    the shared head.  No remat, as in the reference.  With ``tp`` the
    embedding's rows are the rank's vocab block (the masked lookup) and
    the layer runs tensor-parallel, as a block's."""
    mp = _gathered(gather, params["mtp"], "mtp")
    embed = _gathered(gather, params["embed"], "embed")
    tok_emb = (embed[tokens] if tp is None
               else _embed_lookup({"embed": embed}, cfg, tokens, tp))
    h_in = torch.cat(
        [L.rmsnorm(mp["norm_h"], h_final[:, :-1], cfg.norm_eps),
         L.rmsnorm(mp["norm_e"], tok_emb[:, 1:], cfg.norm_eps)], dim=-1)
    h = h_in @ mp["w_comb"]
    B, S = h.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=h.device)[None].expand(B, S)
    h, _, _ = apply_layer(mp["layer"], h, cfg, MTP_SIG, positions=positions,
                          tp=tp)
    return L.rmsnorm(mp["final_norm"], h, cfg.norm_eps)


def _head(params, cfg: ModelConfig, gather=None):
    """The unembedding weights as :func:`_unembed` reads them."""
    k = "embed" if cfg.tie_embeddings else "lm_head"
    return {k: _gathered(gather, params[k], k)}


def forward_train(params, cfg: ModelConfig, inputs: Dict[str, torch.Tensor],
                  *, moe_fn=None, tp=None, gather=None):
    """Full-sequence forward.  Returns (logits (B, S, V) float32, extras)
    with ``extras["aux_loss"]`` the MoE load-balance loss (0 without an
    MoE layer) and, with ``cfg.mtp_depth``, ``extras["mtp_logits"]``
    (B, S - 1, V) float32.  ``moe_fn``, ``tp``, ``gather``: the module
    docstring."""
    h_final, aux = _backbone(params, cfg, inputs, moe_fn=moe_fn, tp=tp,
                             gather=gather)
    x = L.rmsnorm(_gathered(gather, params["final_norm"], "final_norm"),
                  h_final, cfg.norm_eps)
    extras = {"aux_loss": aux}
    if cfg.mtp_depth:
        # the text positions only, after an image's
        tokens = inputs["tokens"]
        extras["mtp_logits"] = _unembed(_head(params, cfg, gather), cfg,
                                        _mtp_hidden(
            params, cfg, h_final[:, -tokens.shape[1]:], tokens, gather,
            tp), tp)
    return _unembed(_head(params, cfg, gather), cfg, x, tp), extras


def _masked_nll(logits, labels, ignore_id: int, z_loss: float):
    """(sum over the valid positions of NLL + z_loss * lse**2, number of
    valid positions as int32)."""
    valid = labels != ignore_id
    lab = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, lab[..., None])[..., 0]
    lse = torch.logsumexp(logits, dim=-1)
    nll = nll + z_loss * lse ** 2
    return torch.where(valid, nll, 0.0).sum(), valid.sum(dtype=torch.int32)


def _ce_chunk(xc, w, lc, ignore_id: int, z_loss: float, tp=None):
    # the product in the params' dtype, then float32, as the reference's
    # einsum(...).astype(float32)
    if isinstance(tp, GradGroup):
        logits = gather_shared((copy_to_split(xc, tp) @ w.T).float(),
                               tp.group, 2)
    else:
        logits = (xc @ w.T).float()
    return _masked_nll(logits, lc, ignore_id, z_loss)


def chunked_ce(x, w, labels, *, ignore_id: int = -1, z_loss: float = 1e-4,
               chunk: int = 512, tp=None):
    """Cross-entropy without materializing (B, S, V) logits.

    x: (B, S, d) final hidden states; w: (V, d) unembedding.  The sequence
    is cut into chunks of ``c = min(chunk, S)`` positions, ``c`` lowered
    until it divides S; each chunk is rematerialized in the backward pass,
    so only one chunk's (B, c, V) logits exist at a time.  Returns
    (sum_nll float32, n_valid int32).  With training's ``tp`` (a
    :class:`~repro_torch.models.collectives.GradGroup`) ``w`` holds this
    rank's vocab rows and each chunk's logits are gathered over the
    vocab.
    """
    B, S, d = x.shape
    c = min(chunk, S)
    while S % c != 0:
        c -= 1
    remat = torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    nvalid = torch.zeros((), dtype=torch.int32, device=x.device)
    for i in range(0, S, c):
        args = (x[:, i:i + c], w, labels[:, i:i + c], ignore_id, z_loss, tp)
        s, nv = (checkpoint(_ce_chunk, *args, use_reentrant=False) if remat
                 else _ce_chunk(*args))
        tot, nvalid = tot + s, nvalid + nv
    return tot, nvalid


def loss_terms(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
               *, moe_fn=None, tp=None, gather=None):
    """The sums :func:`forward_train_loss` divides: ``(tot, n, aux, mtot,
    mn)``, the chunked CE's sum over the valid positions and their count,
    the aux loss, and the MTP CE's sum and count (None without MTP).  A
    sharded step sums ``tot``, ``n``, ``mtot``, ``mn`` over its data
    ranks before it divides."""
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    labels = batch["labels"]
    x, aux = _backbone(params, cfg, inputs, moe_fn=moe_fn, tp=tp,
                       gather=gather)
    xn = L.rmsnorm(_gathered(gather, params["final_norm"], "final_norm"),
                   x, cfg.norm_eps)
    w = next(iter(_head(params, cfg, gather).values()))
    S_txt = labels.shape[1]
    tot, nvalid = chunked_ce(xn[:, -S_txt:], w, labels, tp=tp)
    mtot = mn = None
    if cfg.mtp_depth:
        h_mtp = _mtp_hidden(params, cfg, x[:, -S_txt:], inputs["tokens"],
                            gather, tp)
        mtot, mn = chunked_ce(h_mtp, w, labels[:, 1:], tp=tp)
    return tot, nvalid, aux, mtot, mn


def combine_loss(tot, n, aux, mtot=None, mn=None):
    """The loss of :func:`loss_terms`' (or :func:`logit_loss_terms`')
    sums: ``tot / n + aux`` (+ ``MTP_WEIGHT`` x ``mtot / mn``)."""
    loss = tot / n.clamp(min=1) + aux
    if mtot is not None:
        loss = loss + MTP_WEIGHT * mtot / mn.clamp(min=1)
    return loss


def forward_train_loss(params, cfg: ModelConfig,
                       batch: Dict[str, torch.Tensor], *, moe_fn=None):
    """Memory-lean training loss: backbone + chunked CE + the MoE
    load-balance loss (+ ``MTP_WEIGHT`` x the multi-token-prediction
    CE, whose labels are shifted by one)."""
    return combine_loss(*loss_terms(params, cfg, batch, moe_fn=moe_fn))


def logit_loss_terms(logits, labels, *, extras=None, ignore_id: int = -1,
                     z_loss: float = 1e-4):
    """:func:`loss_fn`'s sums, as :func:`loss_terms` gives them."""
    S = labels.shape[1]
    # logits[:, -S:] drops modality positions
    tot, nvalid = _masked_nll(logits[:, -S:], labels, ignore_id, z_loss)
    extras = extras or {}
    mtot = mn = None
    if "mtp_logits" in extras:
        mtot, mn = _masked_nll(extras["mtp_logits"], labels[:, 1:],
                               ignore_id, 0.0)
    return tot, nvalid, extras.get("aux_loss", 0.0), mtot, mn


def loss_fn(logits, labels, *, extras=None, ignore_id: int = -1,
            z_loss: float = 1e-4):
    """Next-token CE with ignore mask, z-loss and the aux loss; with
    ``extras["mtp_logits"]`` also ``MTP_WEIGHT`` x the MTP CE (token t +
    2 from position t; no z-loss, as in the reference)."""
    return combine_loss(*logit_loss_terms(logits, labels, extras=extras,
                                          ignore_id=ignore_id,
                                          z_loss=z_loss))
