"""Mixture-of-experts blocks.

An own copy of the reference's ``models/moe.py``: the shard-agnostic
:func:`moe_apply_ragged` and the expert-parallel :func:`moe_apply_ep`
(capacity slots, ``all_to_all`` over the data axis to the experts'
shards and back; :func:`repro_torch.launch.moe_parallel.make_ep_moe_fn`
makes it a ``moe_fn``).  Serving shards the experts' ``d_ff_expert``
over the model axis (``tp``), as the reference's serving executor does.
Expert weights live as ``(E, d, f)`` and ``(E, f, d)``, the reference's
leaves, so parameters carry across leaf for leaf.

:func:`moe_apply_ragged` is the reference's sort-based dispatch: the
T x k routed rows sorted by expert (a stable sort), the group offsets
counted on the device (``searchsorted`` over the sorted ids: no
``bincount``, whose CUDA form reads its maximum back to the host), and
the three products (gate, up, down) through
:func:`repro_torch.kernels.grouped_gemm.grouped_gemm`, which computes
only each expert's routed rows (K7 on the card, its gradient K7 and K8;
the reference's ``jax.lax.ragged_dot``).  The group sizes never reach
the host, so neither prefill nor a decode chunk waits on the device.
The sorted rows are a permutation of the token-major ``(T x k, d)``
rows, so their gradient writes each row once, and the combine adds each
token's k weighted rows in the reference's order (ascending expert id:
its stable sort, then its scatter-add), with no atomics.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.config import ModelConfig, MoEConfig
from repro_torch.kernels.grouped_gemm import grouped_gemm
from repro_torch.models import collectives as C
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


def router_probs(p, xf, e: MoEConfig, data=None):
    """xf: (T, d) -> (top_vals (T, k) float32, top_idx (T, k), aux_loss
    scalar).  ``jax.lax.top_k`` breaks ties towards the lower expert id
    and ``torch.topk`` does not: the first k of a stable descending sort
    do.  With ``data`` (the data axis's group, each rank holding its own
    rows) the aux loss takes the means over every rank's rows, as the
    reference's GSPMD step computes it on the global batch: the sums
    and the row count are summed over ``data`` before the product."""
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_vals, top_idx = vals[:, :e.top_k], idx[:, :e.top_k]
    top_vals = top_vals / (top_vals.sum(dim=-1, keepdim=True) + 1e-9)
    # Switch-style load-balance auxiliary loss: E * sum_e f_e * p_e
    onehot = F.one_hot(top_idx[:, 0], e.n_experts).float()
    if data is None:
        pe = probs.mean(dim=0)                        # mean router prob
        fe = onehot.mean(dim=0)                       # fraction routed (top-1)
    else:
        rows = probs.new_full((1,), probs.shape[0])
        tot = C.sum_shared(torch.cat([probs.sum(0), onehot.sum(0), rows]),
                           data)
        pe = tot[:e.n_experts] / tot[-1]
        fe = tot[e.n_experts:-1] / tot[-1]
    aux = e.n_experts * (pe * fe).sum() * e.load_balance_coef
    return top_vals, top_idx, aux


def _shared_out(p, x, tp=None):
    return mlp_apply(p["shared"], x, tp) if "shared" in p else 0.0


def moe_apply_ragged(p, x, cfg: ModelConfig, tp=None, data=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss).  With ``tp`` the
    experts (and the shared expert) hold this rank's ``d_ff_expert``
    columns: the router runs whole on every rank, and the routed
    partial output is summed over ``tp`` (the shared expert's in its own
    MLP, before its output bias).  Under training's ``tp`` (a
    :class:`~repro_torch.models.collectives.GradGroup`) the router
    weights meet this rank's partial rows through an ``f``, so their
    gradient's parts are summed over the model ranks and the router's
    gradient is whole on every rank.  ``data``: see
    :func:`router_probs`."""
    B, S, d = x.shape
    e = cfg.moe
    T = B * S
    xf = x.reshape(T, d)
    top_vals, top_idx, aux = router_probs(p, xf, e, data)
    xf = C.copy_to_split(xf, tp)

    # each token's k choices in ascending expert id: the reference's
    # stable sort orders a token's rows so, and its scatter-add sums them
    # in that order
    E, k = e.n_experts, e.top_k
    order = torch.argsort(top_idx, dim=-1, stable=True)
    top_idx = torch.gather(top_idx, 1, order)
    top_vals = torch.gather(top_vals, 1, order)
    flat_e = top_idx.reshape(-1)                      # (T*k,) token-major
    sort_idx = torch.argsort(flat_e, stable=True)
    offsets = torch.searchsorted(
        flat_e[sort_idx], torch.arange(E + 1, device=x.device)).int()
    # a permutation of the token-major rows: its gradient writes each
    # row once
    xs = xf[:, None].expand(T, k, d).reshape(T * k, d)[sort_idx]

    # a token's k experts are distinct: no group holds more than T rows
    h = (F.silu(grouped_gemm(xs, p["w_gate"], offsets, T))
         * grouped_gemm(xs, p["w_up"], offsets, T))
    out = grouped_gemm(h, p["w_down"], offsets, T)   # (T*k, d), sorted

    # each token's k rows in its ascending expert order
    pos = torch.empty_like(sort_idx).scatter_(
        0, sort_idx, torch.arange(T * k, device=x.device))
    w = C.copy_to_split(top_vals.to(out.dtype), tp)
    rows = out[pos.reshape(T, k)] * w[..., None]      # (T, k, d)
    y = rows[:, 0]
    for j in range(1, k):
        y = y + rows[:, j]
    y = all_reduce(y.reshape(B, S, d), tp)
    y = y + _shared_out(p, x, tp)
    return y.to(x.dtype), aux


def _capacity(capacity_factor: float, k: int, T: int, E: int) -> int:
    """The reference's slots an expert takes from one shard:
    ``max(1, ceil(capacity_factor * k * T / E))``, in its float
    arithmetic."""
    return max(1, int(-(-capacity_factor * k * T // E)))


def moe_apply_ep(p, x, cfg: ModelConfig, *, data_group, model_group=None,
                 replica_group=None, capacity_factor: float = 1.25,
                 comm_dtype=None, scatter_down: bool = False,
                 stats=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE, the reference's ``moe_apply_ep`` step for
    step.  Every rank of the mesh runs it on its own rows:

    * ``x`` is this rank's token slice (B_loc, S, d), whole ``d``;
    * ``p["router"]`` whole; the expert weights this rank's shard of
      experts over ``data_group`` and of ``d_ff_expert`` over
      ``model_group`` (the local leaf is (E_loc, d, f_loc)); the shared
      expert's ``d_ff`` split over ``model_group``.

    Dispatch: each routed row takes a slot of its expert's capacity
    ``cap`` in a sort by expert (stable, so the rows past ``cap`` — the
    dropped ones — are the reference's), the (E, cap, d) send buffer
    (dropped rows 0) goes ``all_to_all`` over ``data_group`` to the
    experts' ranks as (E_loc, n * cap, d), three per-expert products run
    on the local columns, the partial sums meet over ``model_group`` (a
    sum; with ``scatter_down`` and ``d % mp == 0`` a reduce-scatter onto
    ``d`` and an all-gather at token granularity), ``all_to_all`` back,
    and each token adds its kept rows times its router weights, in
    ascending expert id (the reference's scatter-add order), with no
    atomics.  The aux loss is averaged over ``replica_group`` (``pmean``;
    default ``data_group``).  The groups are plain process groups; a
    ``model_group`` of None or of one rank issues no model collective.
    Every collective carries its gradient
    (:mod:`repro_torch.models.collectives`).  ``stats``, a dict, gets
    the routed rows, the kept ones and the (T, k) mask of each token's
    kept choices.
    """
    B, S, d = x.shape
    e = cfg.moe
    n_shards = torch.distributed.get_world_size(data_group)
    E, k = e.n_experts, e.top_k
    if E % n_shards:
        raise ValueError(f"{cfg.name}: {E} experts do not split over "
                         f"{n_shards} data ranks")
    E_loc = E // n_shards
    T = B * S
    xf = x.reshape(T, d)

    top_vals, top_idx, aux = router_probs(p, xf, e)
    aux = C.mean_shared(aux, data_group if replica_group is None
                        else replica_group)

    # --- capacity-based slotting (sort by expert, position within group)
    cap = _capacity(capacity_factor, k, T, E)
    flat_e = top_idx.reshape(-1)                            # (T*k,)
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    # position of each routed row within its expert's group
    seg_pos = (torch.arange(T * k, device=x.device)
               - torch.searchsorted(sorted_e, sorted_e, side="left"))
    keep = seg_pos < cap
    tok_idx = sort_idx // k
    if stats is not None:
        stats["routed"] = T * k
        stats["kept"] = keep.sum()
        stats["keep"] = torch.empty_like(keep).index_put_(
            (sort_idx,), keep).reshape(T, k)

    # the (E, cap, d) send buffer, dropped rows 0: kept rows own their
    # slot, dropped ones all write one spare row, cut off after
    send_dtype = comm_dtype or xf.dtype
    slot = torch.where(keep, sorted_e * cap + seg_pos, E * cap)
    contrib = torch.where(keep[:, None], xf[tok_idx], 0.0).to(send_dtype)
    buf = contrib.new_zeros((E * cap + 1, d)).index_copy(0, slot, contrib)
    buf = buf[:E * cap].reshape(n_shards, E_loc, cap, d)

    # --- all_to_all: block i (rank i's experts) to rank i; block j of
    # what comes back is from source shard j
    recv = C.all_to_all(buf, data_group)
    recv = recv.transpose(0, 1).reshape(E_loc, n_shards * cap, d)

    # --- dense per-expert compute (local experts, local d_ff shard)
    mp = (1 if model_group is None
          else torch.distributed.get_world_size(model_group))
    tp = C.GradGroup(model_group) if mp > 1 else None
    recv = C.copy_to_split(recv.to(x.dtype), tp)
    h = F.silu(torch.bmm(recv, p["w_gate"])) * torch.bmm(recv, p["w_up"])
    out = torch.bmm(h, p["w_down"]).to(send_dtype)

    if mp > 1 and scatter_down and d % mp == 0:
        # reduce-scatter the partial down projection onto d, send a d/mp
        # slice back, all-gather d only at token granularity
        out = C.scatter_sum(out, model_group, 2)            # (E_loc, C', d/m)
        d_loc = d // mp
    else:
        # d_ff is split over the model ranks: partial sums
        out = all_reduce(out, tp)
        d_loc = d

    # --- all_to_all back to the source shards
    back = out.reshape(E_loc, n_shards, cap, d_loc).transpose(0, 1)
    send = C.all_to_all(back, data_group).reshape(E * cap, d_loc)

    # --- combine: each routed row's expert output, weighted, summed per
    # token in ascending expert id (the sorted order within a token)
    got = torch.where(keep[:, None], send[slot.clamp(max=E * cap - 1)], 0.0)
    w = top_vals.reshape(-1)[sort_idx][:, None].to(got.dtype)
    if d_loc != d:
        # the weights meet this rank's d slice only: their gradient's
        # parts are summed over the model ranks
        w = C.copy_to_split(w, tp)
    got = got * w
    pos = torch.empty_like(sort_idx)
    pos[sort_idx] = torch.arange(T * k, device=x.device)
    rows = got[pos.reshape(T, k).sort(dim=1).values]       # (T, k, d_loc)
    y = rows[:, 0]
    for j in range(1, k):
        y = y + rows[:, j]
    if d_loc != d:
        y = C.gather_shared(y, model_group, 1)              # (T, d)
    y = y.reshape(B, S, d)
    if "shared" in p:
        # the shared expert's d_ff is split over the model ranks
        y = y + mlp_apply(p["shared"], x, tp)
    return y.to(x.dtype), aux
