"""Mixture-of-experts blocks.

An own copy of the reference's ``models/moe.py`` less its expert-parallel
path (``moe_apply_ep``, ``shard_map`` with ``all_to_all``: the training
half of ``ROADMAP.md`` queue 1, item 9).  Serving shards the experts'
``d_ff_expert`` over the model axis instead, as the reference's serving
executor does (``tp``).  Expert weights live as ``(E, d, f)``
and ``(E, f, d)``, the reference's leaves, so parameters carry across
leaf for leaf.

:func:`moe_apply_ragged` computes the reference's function, whose
grouped products are ``jax.lax.ragged_dot`` over token rows sorted by
expert, in the exact capacity form instead: no expert receives more
than T rows (each token's top-k experts are distinct), so each routed
row is written into a zero ``(E, T, d)`` buffer at ``[expert, token]``
and the three products are ``torch.bmm`` against the stacked weights.
The group sizes never reach the host, so neither prefill nor a decode
chunk waits on the device.  Every write goes to its own
``[expert, token]`` pair, so the dispatch is deterministic, and the
combine adds each token's k weighted rows in the reference's order
(ascending expert id: its stable sort, then its scatter-add).  The cost:
the products run over all E x T rows, E / k times the routed work, and
every expert's weights are read each step.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.config import ModelConfig, MoEConfig
from repro_torch.models.layers import all_reduce, mlp_apply, mlp_schema
from repro_torch.models.schema import ParamSpec


def moe_schema(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    e: MoEConfig = cfg.moe
    f = e.d_ff_expert
    s = {
        "router": ParamSpec((d, e.n_experts), ("d_model", "experts_r"),
                            init="small"),
        "w_gate": ParamSpec((e.n_experts, d, f),
                            ("experts", "d_model", "d_ff_expert")),
        "w_up": ParamSpec((e.n_experts, d, f),
                          ("experts", "d_model", "d_ff_expert")),
        "w_down": ParamSpec((e.n_experts, f, d),
                            ("experts", "d_ff_expert", "d_model")),
    }
    if e.n_shared_experts:
        s["shared"] = mlp_schema(cfg, d_ff=f * e.n_shared_experts)
    return s


def router_probs(p, xf, e: MoEConfig):
    """xf: (T, d) -> (top_vals (T, k) float32, top_idx (T, k), aux_loss
    scalar).  ``jax.lax.top_k`` breaks ties towards the lower expert id
    and ``torch.topk`` does not: the first k of a stable descending sort
    do."""
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_vals, top_idx = vals[:, :e.top_k], idx[:, :e.top_k]
    top_vals = top_vals / (top_vals.sum(dim=-1, keepdim=True) + 1e-9)
    # Switch-style load-balance auxiliary loss: E * sum_e f_e * p_e
    pe = probs.mean(dim=0)                            # mean router prob
    onehot = F.one_hot(top_idx[:, 0], e.n_experts).float()
    fe = onehot.mean(dim=0)                           # fraction routed (top-1)
    aux = e.n_experts * (pe * fe).sum() * e.load_balance_coef
    return top_vals, top_idx, aux


def _shared_out(p, x, tp=None):
    return mlp_apply(p["shared"], x, tp) if "shared" in p else 0.0


def moe_apply_ragged(p, x, cfg: ModelConfig, tp=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss).  With ``tp`` the
    experts (and the shared expert) hold this rank's ``d_ff_expert``
    columns: the router runs whole on every rank, and the routed
    partial output is summed over ``tp`` (the shared expert's in its own
    MLP, before its output bias)."""
    B, S, d = x.shape
    e = cfg.moe
    T = B * S
    xf = x.reshape(T, d)
    top_vals, top_idx, aux = router_probs(p, xf, e)

    # each token's k choices in ascending expert id: the reference's
    # stable sort orders a token's rows so, and its scatter-add sums them
    # in that order
    order = torch.argsort(top_idx, dim=-1, stable=True)
    top_idx = torch.gather(top_idx, 1, order)
    top_vals = torch.gather(top_vals, 1, order)
    tok = torch.arange(T, device=x.device)[:, None].expand(T, e.top_k)
    xs = xf.new_zeros((e.n_experts, T, d)).index_put(
        (top_idx, tok), xf[:, None].expand(T, e.top_k, d))

    h = F.silu(torch.bmm(xs, p["w_gate"])) * torch.bmm(xs, p["w_up"])
    out = torch.bmm(h, p["w_down"])                   # (E, T, d)

    w = top_vals.to(out.dtype)
    rows = out[top_idx, tok] * w[..., None]           # (T, k, d)
    y = rows[:, 0]
    for j in range(1, e.top_k):
        y = y + rows[:, j]
    y = all_reduce(y.reshape(B, S, d), tp) + _shared_out(p, x, tp)
    return y.to(x.dtype), aux
