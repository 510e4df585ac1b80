"""Decoder assembly for the dense GQA and Mamba2 families.

Mirrors the reference's ``models/transformer.py``: layers are grouped
into an optional unrolled prefix followed by ``n_blocks`` repeats of a
block of ``P`` layers, and the parameters and caches of the repeats are
stacked on a leading ``n_blocks`` dim — the same tree, so parameters
carry across from the reference leaf for leaf.  Where the reference
scans over the stack, the port loops over it and takes a view of each
slice.

Scope: full-attention dense GQA decoders (the ``qwen1.5-32b`` family),
with the dense slot cache or the paged pool, each in the config's dtype
or int8 (``kv_quant_int8``); Mamba2 stacks (``"M"`` layers, the
``mamba2-130m`` family: :mod:`repro_torch.models.ssm`) with the dense
slot cache of conv tails and SSM states (the paged pool raises for
them, as the reference's does); and the no-cache training forward with
its losses for both.  Any other family or attention variant (MoE, MLA,
encoder-decoder, modality frontends, multi-token prediction, sliding
window, logit softcap; so Jamba too, for its MoE) raises
``NotImplementedError`` naming its ``ROADMAP.md`` item.

Training: gradients reach the stacked ``blocks`` leaves through the
per-slice views, so ``.grad`` (or ``torch.autograd.grad``) of a stacked
leaf holds every block's gradient, as JAX's scan gives it.  ``cfg.remat``
rematerializes each block in the backward pass: ``"full"`` keeps only
the block's input, ``"dots"`` also keeps the outputs of the weight
products (``aten.mm`` / ``aten.addmm``: the counterpart of
``dots_with_no_batch_dims_saveable``), ``"none"`` keeps everything.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.config import ModelConfig
from repro_torch.models import layers as L
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


def _lcm(a, b):
    return a * b // math.gcd(a, b)


def _check_supported(cfg: ModelConfig) -> None:
    """Raise for anything outside the ported dense-GQA and Mamba2 scope."""
    kinds = {cfg.layer_kind(i) for i in range(cfg.n_layers)}
    if "M" in kinds and cfg.ssm is None:
        raise ValueError(f"{cfg.name}: Mamba layers need cfg.ssm")
    unported = [
        ("A" in kinds and cfg.attn_type != "gqa",
         f"attn_type={cfg.attn_type!r}"),
        (cfg.moe is not None, "mixture of experts"),
        (cfg.is_encoder_decoder, "encoder-decoder"),
        (cfg.modality != "text", f"modality={cfg.modality!r}"),
        (bool(cfg.mtp_depth), "multi-token prediction"),
        (bool(cfg.sliding_window or cfg.window_ring_cache),
         "sliding-window attention"),
        (bool(cfg.attn_logit_softcap), "logit softcap"),
    ]
    found = [what for bad, what in unported if bad]
    if found:
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense full-attention GQA "
            f"decoders and Mamba2 stacks only; {', '.join(found)}: "
            f"ROADMAP.md queue 1, item 8")


def layer_structure(cfg: ModelConfig) -> Tuple[List[LayerSig], List[LayerSig], int]:
    """Returns (prefix_sigs, block_sigs, n_blocks)."""
    _check_supported(cfg)

    def sig(i: int) -> LayerSig:
        return LayerSig(cfg.layer_kind(i), 0, cfg.is_moe_layer(i),
                        cfg.is_encoder_decoder)

    P = _lcm(len(cfg.layer_pattern) or 1, len(cfg.attn_pattern) or 1)
    if cfg.n_layers % P:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers not divisible "
                         f"by period {P}")
    block = [sig(j) for j in range(P)]
    return [], block, cfg.n_layers // P


def _layer_schema(cfg: ModelConfig, s: LayerSig) -> Dict[str, Any]:
    d = cfg.d_model
    out: Dict[str, Any] = {"ln1": L.rmsnorm_schema(d)}
    if s.kind == "M":
        out["ssm"] = ssm_schema(cfg)
    else:
        out["attn"] = L.gqa_schema(cfg)
    # ln2 stays without an MLP (Mamba2: d_ff = 0), as in the reference
    out["ln2"] = L.rmsnorm_schema(d)
    if s.kind == "A" or cfg.d_ff:
        out["mlp"] = L.mlp_schema(cfg)
    return out


def apply_layer(p, x, cfg: ModelConfig, s: LayerSig, *, positions,
                cache=None, page_table=None):
    """One residual block.  Returns (x, cache); the cache is updated in
    place (see :func:`repro_torch.models.layers.gqa_apply` and
    :func:`repro_torch.models.ssm.ssm_apply`)."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if s.kind == "M":
        out, cache = ssm_apply(p["ssm"], h, cfg, cache=cache)
    else:
        out, cache = L.gqa_apply(p["attn"], h, cfg, positions=positions,
                                 cache=cache, window=s.window,
                                 causal=s.causal, page_table=page_table)
    x = x + out
    if "mlp" in p:
        # the reference adds an FFN term of 0.0 when there is no MLP
        x = x + L.mlp_apply(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x, cache


def _layer_cache_schema(cfg: ModelConfig, s: LayerSig, batch: int,
                        max_len: int) -> Dict[str, ParamSpec]:
    if s.kind == "M":
        return ssm_cache_schema(cfg, batch)
    if cfg.kv_quant_int8:
        # int8 payload + float16 per-position scales
        return KQ.quant_kv_cache_schema(batch, max_len, cfg.n_kv_heads,
                                        cfg.head_dim)
    kv = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
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
    per-slot ``pos``.  Only full-attention GQA stacks page.
    """
    prefix, block, n_blocks = layer_structure(cfg)
    for s in prefix + block:
        if s.kind != "A" or s.cross or cfg.attn_type == "mla" or s.window:
            raise ValueError(
                f"{cfg.name}: paged KV cache supports full-attention "
                f"GQA layers only (got kind={s.kind} cross={s.cross} "
                f"attn_type={cfg.attn_type} window={s.window})")
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


def _embed_lookup(params, cfg: ModelConfig, tokens):
    return params["embed"][tokens]


def _unembed(params, cfg: ModelConfig, x):
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return (x @ w.T).float()


def _slice(tree, i: int):
    """Views of slice ``i`` of a stacked tree: in-place writes to a
    cache slice land in the stacked cache."""
    return {k: _slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def forward_prefill(params, cfg: ModelConfig, inputs, cache):
    """Prefill: run the full prompt, fill the cache, return last logits."""
    return _forward_cached(params, cfg, inputs, cache, prefill=True)


def forward_decode(params, cfg: ModelConfig, inputs, cache):
    """One decode step: inputs["tokens"] is (B, 1)."""
    return _forward_cached(params, cfg, inputs, cache, prefill=False)


def _forward_cached(params, cfg, inputs, cache, *, prefill):
    """Returns (logits (B, 1, V) float32 of the last position, cache).
    The cache dict is updated in place and returned: its k/v leaves are
    written where they lie, and ``cache["pos"]`` is replaced by the
    advanced positions."""
    prefix, block, n_blocks = layer_structure(cfg)
    tokens = inputs["tokens"]
    B, S = tokens.shape
    x = _embed_lookup(params, cfg, tokens)

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
        x, _ = apply_layer(lp, x, cfg, s, positions=positions, cache=lc,
                           page_table=page_table)
    for i in range(n_blocks):
        bp, bc = _slice(params["blocks"], i), _slice(cache["blocks"], i)
        for j, s in enumerate(block):
            x, _ = apply_layer(bp[f"p{j}"], x, cfg, s, positions=positions,
                               cache=bc[f"p{j}"], page_table=page_table)
    cache["pos"] = new_pos

    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _unembed(params, cfg, x[:, -1:]), cache


# ---------------------------------------------------------------------------
# No-cache forward (training, evaluation) and losses
# ---------------------------------------------------------------------------


def _embed_inputs(params, cfg: ModelConfig, inputs: Dict[str, torch.Tensor]):
    """Token embedding.  Returns (x, positions); text only (the modality
    frontends raise in ``layer_structure``)."""
    tokens = inputs["tokens"]
    B, S = tokens.shape
    x = _embed_lookup(params, cfg, tokens)
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    return x, positions


def _save_weight_products(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the outputs
    of the 2-D weight products, recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _backbone(params, cfg: ModelConfig, inputs):
    """Embedding and every layer, under ``cfg.remat``.  Returns the
    hidden states before the final norm and the auxiliary loss (0: no
    MoE layer is ported)."""
    prefix, block, n_blocks = layer_structure(cfg)
    x, positions = _embed_inputs(params, cfg, inputs)
    for lp, s in zip(params["prefix"], prefix):
        x, _ = apply_layer(lp, x, cfg, s, positions=positions)

    def block_body(h, bp):
        for j, s in enumerate(block):
            h, _ = apply_layer(bp[f"p{j}"], h, cfg, s, positions=positions)
        return h

    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"{cfg.name}: unknown remat {cfg.remat!r}")
    # nothing is saved for a backward pass when autograd is off
    remat = cfg.remat != "none" and torch.is_grad_enabled()
    kw = ({"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _save_weight_products)}
          if cfg.remat == "dots" else {})
    for i in range(n_blocks):
        bp = _slice(params["blocks"], i)
        x = (checkpoint(block_body, x, bp, use_reentrant=False, **kw)
             if remat else block_body(x, bp))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def forward_train(params, cfg: ModelConfig, inputs: Dict[str, torch.Tensor]):
    """Full-sequence forward.  Returns (logits (B, S, V) float32, extras)
    with ``extras["aux_loss"]`` 0 (no MoE layer is ported)."""
    x, aux = _backbone(params, cfg, inputs)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _unembed(params, cfg, x), {"aux_loss": aux}


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


def _ce_chunk(xc, w, lc, ignore_id: int, z_loss: float):
    # the product in the params' dtype, then float32, as the reference's
    # einsum(...).astype(float32)
    return _masked_nll((xc @ w.T).float(), lc, ignore_id, z_loss)


def chunked_ce(x, w, labels, *, ignore_id: int = -1, z_loss: float = 1e-4,
               chunk: int = 512):
    """Cross-entropy without materializing (B, S, V) logits.

    x: (B, S, d) final hidden states; w: (V, d) unembedding.  The sequence
    is cut into chunks of ``c = min(chunk, S)`` positions, ``c`` lowered
    until it divides S; each chunk is rematerialized in the backward pass,
    so only one chunk's (B, c, V) logits exist at a time.  Returns
    (sum_nll float32, n_valid int32).
    """
    B, S, d = x.shape
    c = min(chunk, S)
    while S % c != 0:
        c -= 1
    remat = torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    nvalid = torch.zeros((), dtype=torch.int32, device=x.device)
    for i in range(0, S, c):
        args = (x[:, i:i + c], w, labels[:, i:i + c], ignore_id, z_loss)
        s, nv = (checkpoint(_ce_chunk, *args, use_reentrant=False) if remat
                 else _ce_chunk(*args))
        tot, nvalid = tot + s, nvalid + nv
    return tot, nvalid


def forward_train_loss(params, cfg: ModelConfig,
                       batch: Dict[str, torch.Tensor]):
    """Memory-lean training loss: backbone + chunked CE (+ aux, 0)."""
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    labels = batch["labels"]
    x, aux = _backbone(params, cfg, inputs)
    xn = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    S_txt = labels.shape[1]
    tot, nvalid = chunked_ce(xn[:, -S_txt:], w, labels)
    return tot / nvalid.clamp(min=1) + aux


def loss_fn(logits, labels, *, extras=None, ignore_id: int = -1,
            z_loss: float = 1e-4):
    """Next-token CE with ignore mask, z-loss and the aux loss."""
    S = labels.shape[1]
    # logits[:, -S:] drops modality positions
    tot, nvalid = _masked_nll(logits[:, -S:], labels, ignore_id, z_loss)
    loss = tot / nvalid.clamp(min=1)
    if extras:
        loss = loss + extras.get("aux_loss", 0.0)
    return loss
