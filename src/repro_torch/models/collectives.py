"""Collectives that carry gradients, for sharded training.

SPMD training (:mod:`repro_torch.training.sharded`) runs one process a
card; every rank computes the same global loss and ranks meet only in
collectives.  Autograd sees one rank's program, so each collective
below is a ``torch.autograd.Function`` whose backward is the transpose
that this convention needs:

* a forward all-reduce whose result every rank then uses alike (the
  Megatron ``g``: an output projection over the model axis; the loss's
  sums over the data axis) passes the gradient through unchanged;
* a replicated activation entering a column-split product (the
  Megatron ``f``) is the identity forward and all-reduces the gradient;
* an all-gather whose result every rank uses alike (the logits' vocab,
  the expert output's ``d`` after ``scatter_down``) keeps this rank's
  slice of the gradient; an all-gather whose result each rank uses on
  its own part (the FSDP gather of a weight, used on the data rank's
  rows; the ``head_dim`` rows of q / k / v a tensor-parallel attention
  gathers, used for the rank's own heads) reduce-scatters (sums) it
  instead;
* a reduce-scatter all-gathers the gradient; an all-to-all sends it
  back the way the rows came (with uneven blocks too).

``torch.distributed.nn.functional.all_reduce`` is not used: its
backward all-reduces again, which would multiply every upstream
gradient by the group's size.  The serving path keeps the plain
in-place :func:`repro_torch.models.layers.all_reduce`; a tensor-parallel
``tp`` wrapped in :class:`GradGroup` selects the functions here.

Every call counts itself in :data:`ISSUED` by kind.  The FSDP gather
also tracks the bytes of gathered weights still alive (freed when the
gathered tensor's storage is, a saved tensor included): :data:`GATHERED`
holds the live bytes and their peak since :func:`reset_counts`.
"""
from __future__ import annotations

import weakref
from collections import Counter
from dataclasses import dataclass

import torch
import torch.distributed as dist

# collectives issued since reset_counts(), by kind
ISSUED: Counter = Counter()
# bytes of FSDP-gathered weights alive now, and their peak
GATHERED = {"live": 0, "peak": 0}


def reset_counts() -> None:
    ISSUED.clear()
    GATHERED["peak"] = GATHERED["live"]


@dataclass(frozen=True)
class GradGroup:
    """A process group whose collectives carry gradients: the model
    axis's group as the training forward takes it (``tp``)."""
    group: object


def group_of(tp):
    """The raw process group of ``tp`` (a group or a :class:`GradGroup`)."""
    return tp.group if isinstance(tp, GradGroup) else tp


# the single-tensor collectives by their newer names where torch has them
_gather_into = getattr(dist, "all_gather_single", None) or (
    dist.all_gather_into_tensor)
_scatter_into = getattr(dist, "reduce_scatter_single", None) or (
    dist.reduce_scatter_tensor)


def reduce_sum(x, group):
    """The sum of ``x`` over ``group``, no gradient, in place where ``x``
    is contiguous (the optimizer's norms, the gradients of the leaves
    every data rank holds whole)."""
    ISSUED["all_reduce"] += 1
    x = x.contiguous()
    dist.all_reduce(x, group=group)
    return x


def all_gather(x, group, dim: int):
    """Shards of ``group``'s ranks concatenated on ``dim`` in rank order
    (no gradient)."""
    ISSUED["all_gather"] += 1
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _gather_into(out, x.contiguous(), group=group)
    return out.view(n, *x.shape).movedim(0, dim).reshape(
        *x.shape[:dim], n * x.shape[dim], *x.shape[dim + 1:])


def reduce_scatter(x, group, dim: int):
    """The sum over ``group`` of ``x``, this rank's block of ``dim`` (no
    gradient)."""
    ISSUED["reduce_scatter"] += 1
    n = dist.get_world_size(group)
    s = x.shape[dim] // n
    parts = x.reshape(*x.shape[:dim], n, s, *x.shape[dim + 1:]).movedim(dim, 0)
    out = x.new_empty(parts.shape[1:])
    _scatter_into(out, parts.reshape(-1, *parts.shape[2:]), group=group)
    return out


def _slice(x, group, dim: int):
    n, r = dist.get_world_size(group), dist.get_rank(group)
    s = x.shape[dim] // n
    return x.narrow(dim, r * s, s).contiguous()


def _all_to_all(x, group, sizes=None, out_sizes=None):
    """Block i of dim 0 to rank i; block j of the result from rank j.
    Equal blocks, or the rows of dim 0 ``sizes`` sends and ``out_sizes``
    receives, rank by rank."""
    ISSUED["all_to_all"] += 1
    x = x.contiguous()
    if sizes is None:
        out = torch.empty_like(x)
    else:
        out = x.new_empty((sum(out_sizes),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x, out_sizes, sizes, group=group)
    return out


class _SumShared(torch.autograd.Function):
    """g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return reduce_sum(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToSplit(torch.autograd.Function):
    """f: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return reduce_sum(g.clone(), ctx.group), None


class _GatherSplit(torch.autograd.Function):
    """All-gather on ``dim`` forward; the gradient reduce-scattered
    (summed over the group, this rank's block) backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _GatherShared(torch.autograd.Function):
    """All-gather on ``dim`` forward; this rank's slice backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.group, ctx.dim), None, None


class _ScatterSum(torch.autograd.Function):
    """Reduce-scatter on ``dim`` forward; all-gather backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


def _track(t) -> None:
    """Count ``t``'s bytes as live until its storage is freed."""
    st = t.untyped_storage()
    n = st.nbytes()
    GATHERED["live"] += n
    GATHERED["peak"] = max(GATHERED["peak"], GATHERED["live"])
    weakref.finalize(st, _untrack, n)


def _untrack(n: int) -> None:
    GATHERED["live"] -= n


class _GatherWeight(_GatherSplit):
    """FSDP: :class:`_GatherSplit` of a weight's shards, its bytes
    tracked in :data:`GATHERED`."""

    @staticmethod
    def forward(ctx, x, group, dim):
        out = _GatherSplit.forward(ctx, x, group, dim)
        _track(out)
        return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, sizes, out_sizes):
        ctx.group, ctx.sizes, ctx.out_sizes = group, sizes, out_sizes
        return _all_to_all(x, group, sizes, out_sizes)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(g, ctx.group, ctx.out_sizes, ctx.sizes), None,
                None, None)


class _MeanShared(torch.autograd.Function):
    """pmean: the mean over the group forward, gradient / n backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        return reduce_sum(x.clone(), group) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def sum_shared(x, group):
    """g over ``group``: every rank gets the sum and uses it alike."""
    return _SumShared.apply(x, group)


def copy_to_split(x, tp):
    """f: ``x`` as it is; with a :class:`GradGroup` its gradient is
    summed over the group (the column-split products' parts)."""
    return _CopyToSplit.apply(x, tp.group) if isinstance(tp, GradGroup) else x


def gather_shared(x, group, dim: int):
    """Every rank's block of ``dim``, in rank order, used alike."""
    return _GatherShared.apply(x, group, dim)


def scatter_sum(x, group, dim: int):
    """The sum over ``group``, this rank's block of ``dim``."""
    return _ScatterSum.apply(x, group, dim)


def gather_split(x, group, dim: int):
    """Every rank's block of ``dim``, in rank order, each rank using the
    result on its own part (the gradient summed, this rank's block)."""
    return _GatherSplit.apply(x, group, dim)


def gather_weight(x, group, dim: int):
    """The FSDP gather of a weight's ``dim`` over the data ranks."""
    return _GatherWeight.apply(x, group, dim)


def all_to_all(x, group, sizes=None, out_sizes=None):
    """Block i of ``x``'s dim 0 to rank i: equal blocks, or ``sizes[i]``
    rows to rank i and ``out_sizes[j]`` rows from rank j."""
    return _AllToAll.apply(x, group, sizes, out_sizes)


def mean_shared(x, group):
    """The mean over ``group`` (the reference's ``pmean``)."""
    return _MeanShared.apply(x, group)
