"""Decoder assembly for the dense GQA family.

Mirrors the reference's ``models/transformer.py``: layers are grouped
into an optional unrolled prefix followed by ``n_blocks`` repeats of a
block of ``P`` layers, and the parameters and caches of the repeats are
stacked on a leading ``n_blocks`` dim — the same tree, so parameters
carry across from the reference leaf for leaf.  Where the reference
scans over the stack, the port loops over it and takes a view of each
slice.

Scope: full-attention dense GQA decoders (the ``qwen1.5-32b`` family).
Any other family or attention variant raises ``NotImplementedError``
naming its ``ROADMAP.md`` item.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.core.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.schema import ParamSpec, stack_specs, tree_map


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
    """Raise for anything outside the ported dense-GQA scope."""
    unported = [
        (cfg.attn_type != "gqa", f"attn_type={cfg.attn_type!r}"),
        (cfg.moe is not None, "mixture of experts"),
        (cfg.ssm is not None or cfg.arch_type == "ssm"
         or "M" in cfg.layer_pattern, "Mamba2 SSD layers"),
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
            f"decoders only; {', '.join(found)}: ROADMAP.md queue 1, "
            f"item 8")
    if cfg.kv_quant_int8:
        raise NotImplementedError(
            f"{cfg.name}: int8 KV cache: ROADMAP.md queue 1, items 2-3")


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
    return {"ln1": L.rmsnorm_schema(d), "attn": L.gqa_schema(cfg),
            "ln2": L.rmsnorm_schema(d), "mlp": L.mlp_schema(cfg)}


def apply_layer(p, x, cfg: ModelConfig, s: LayerSig, *, positions,
                cache=None):
    """One residual block.  Returns (x, cache); the cache is updated in
    place (see :func:`repro_torch.models.layers.gqa_apply`)."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    out, cache = L.gqa_apply(p["attn"], h, cfg, positions=positions,
                             cache=cache, window=s.window, causal=s.causal)
    x = x + out
    h2 = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + L.mlp_apply(p["mlp"], h2), cache


def _layer_cache_schema(cfg: ModelConfig, s: LayerSig, batch: int,
                        max_len: int) -> Dict[str, ParamSpec]:
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
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
        new_pos = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    else:
        positions = cache["pos"][:, None]
        new_pos = cache["pos"] + 1

    for lp, lc, s in zip(params["prefix"], cache["prefix"], prefix):
        x, _ = apply_layer(lp, x, cfg, s, positions=positions, cache=lc)
    for i in range(n_blocks):
        bp, bc = _slice(params["blocks"], i), _slice(cache["blocks"], i)
        for j, s in enumerate(block):
            x, _ = apply_layer(bp[f"p{j}"], x, cfg, s, positions=positions,
                               cache=bc[f"p{j}"])
    cache["pos"] = new_pos

    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _unembed(params, cfg, x[:, -1:]), cache
