"""Sharding resolution: logical axes -> partition specs.

An own copy of the reference's ``sharding.py`` (production rule set):

* ``model`` axis: vocab > d_ff/d_ff_expert/d_inner > heads > kv_heads >
  kv_lora > head_dim — first candidate whose dim divides the axis size
  (**divisibility fallback**: e.g. 40 heads on a 16-way model axis fall
  back to head_dim; if nothing divides, the tensor is replicated over
  ``model`` and the event is recorded in :data:`FALLBACK_LOG`).
* ``data`` axis (weights): ZeRO/FSDP-style extra sharding of large
  tensors over the data axis, preferring the d_model dim.
* ``batch`` leaves (activations, KV caches) shard over ("pod","data")
  when divisible, else "data", else replicated.
* ``experts``: sharded over "data" in expert-parallel (EP) mode.

A spec is a plain tuple with one entry per dim — ``None``, an axis name,
or a tuple of names — the counterpart of a JAX ``PartitionSpec``.  The
resolver reads only a mesh's ``axis_names`` and ``devices.shape``, so
it takes the port's :class:`~repro_torch.launch.mesh.ServingMesh` or a
stub of those two attributes.  :func:`local_shape` and
:func:`local_shard` turn a spec into this process's piece of a tensor
on a real mesh.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.schema import (ParamSpec, init_from_schema,
                                       tree_map_with_path)

MODEL_PRIORITY = ("vocab", "d_ff", "d_ff_expert", "d_inner", "heads",
                  "kv_heads", "kv_lora", "head_dim")
FSDP_MIN_SIZE = 1 << 18          # don't FSDP-shard small tensors

# fallback events (logical description), as the reference records them
FALLBACK_LOG: List[str] = []


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _batch_entry(dim: int, mesh):
    ba = batch_axes(mesh)
    sizes = mesh_axis_sizes(mesh)
    prod = int(np.prod([sizes[a] for a in ba]))
    if dim % prod == 0:
        return ba if len(ba) > 1 else ba[0], set(ba)
    if "data" in sizes and dim % sizes["data"] == 0:
        return "data", {"data"}
    return None, set()


def resolve_spec(ps: ParamSpec, mesh, *, fsdp: bool = True,
                 ep: bool = False, log_name: str = "") -> tuple:
    """Resolve one ParamSpec to a spec tuple."""
    sizes = mesh_axis_sizes(mesh)
    n = len(ps.shape)
    entries: List[Optional[object]] = [None] * n
    used: set = set()

    # --- batch (activation / cache tensors) — first batch dim only
    for i, (ax, dim) in enumerate(zip(ps.axes, ps.shape)):
        if ax == "batch":
            entry, u = _batch_entry(dim, mesh)
            if not (u & used):
                entries[i], used = entry, used | u
            break

    # --- expert parallelism
    if ep and "data" not in used and "data" in sizes:
        for i, (ax, dim) in enumerate(zip(ps.axes, ps.shape)):
            if ax == "experts" and dim % sizes["data"] == 0:
                entries[i] = "data"
                used.add("data")
                break

    # --- model axis by priority
    if "model" in sizes:
        placed = False
        for name in MODEL_PRIORITY:
            for i, (ax, dim) in enumerate(zip(ps.axes, ps.shape)):
                if ax == name and entries[i] is None \
                        and dim % sizes["model"] == 0:
                    entries[i] = "model"
                    used.add("model")
                    placed = True
                    break
            if placed:
                break
        if not placed and any(a in MODEL_PRIORITY for a in ps.axes):
            FALLBACK_LOG.append(
                f"{log_name or ps.axes}: no dim divisible by model="
                f"{sizes['model']} shape={ps.shape} axes={ps.axes} "
                f"-> replicated")

    # --- FSDP over data axis for big weight tensors
    has_batch = "batch" in ps.axes
    if (fsdp and not has_batch and "data" not in used and "data" in sizes
            and int(np.prod(ps.shape)) >= FSDP_MIN_SIZE):
        # prefer d_model, else the largest remaining divisible dim
        order = sorted(range(n), key=lambda i: (ps.axes[i] != "d_model",
                                                -ps.shape[i]))
        for i in order:
            if entries[i] is None and ps.axes[i] != "layers" \
                    and ps.shape[i] % sizes["data"] == 0:
                entries[i] = "data"
                used.add("data")
                break

    return tuple(entries)


def leaf_name(path) -> str:
    """'blocks/p0/attn/wq'-style name for a leaf's path (dict keys and
    list indices from the root)."""
    return "/".join(str(k) for k in path)


def specs_for_schema(schema, mesh, *, fsdp: bool = True, ep: bool = False):
    """Spec tree matching a ParamSpec tree."""
    return tree_map_with_path(
        lambda path, ps: resolve_spec(ps, mesh, fsdp=fsdp, ep=ep,
                                      log_name=leaf_name(path)), schema)


def model_axis_fallbacks(schema, mesh, *, fsdp: bool = False):
    """Audit the ``model``-axis coverage of a schema on a mesh.

    Returns ``(sharded, fallbacks)``: names of leaves that carry a
    MODEL_PRIORITY logical axis and resolve WITH / WITHOUT a ``model``
    entry on this mesh.  A non-empty ``fallbacks`` list on an ``mp>1``
    serve mesh means those tensors would replicate over the model axis
    (the divisibility fallback).
    """
    sharded: List[str] = []
    fallbacks: List[str] = []

    def f(path, ps):
        if not any(a in MODEL_PRIORITY for a in ps.axes):
            return
        name = leaf_name(path)
        spec = resolve_spec(ps, mesh, fsdp=fsdp, log_name=name)
        (sharded if "model" in spec else fallbacks).append(name)

    tree_map_with_path(f, schema)
    return sharded, fallbacks


def input_sharding(mesh, batch: int, rank: int) -> tuple:
    """Batch-sharded activation input: (B, ...) with B maybe indivisible."""
    entry, _ = _batch_entry(batch, mesh)
    return (entry,) + (None,) * (rank - 1)


def opt_state_spec_like(param_spec: tuple, ps: ParamSpec, mesh) -> tuple:
    """ZeRO-1: optimizer moments shard like the param (already FSDP'd)."""
    return param_spec


# ---------------------------------------------------------------------------
# This process's piece of a tensor on a real mesh
# ---------------------------------------------------------------------------


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def local_shape(shape, spec: tuple, mesh, axes=None) -> Tuple[int, ...]:
    """The shape of one process's shard of a ``shape`` tensor laid out by
    ``spec``; with ``axes``, only the mesh axes named there split (the
    others replicate)."""
    sizes = mesh_axis_sizes(mesh)
    out = []
    for dim, entry in zip(shape, spec):
        n = int(np.prod([sizes[a] for a in _entry_axes(entry)
                         if axes is None or a in axes]))
        out.append(dim // n)
    return tuple(out)


def local_shard(t, spec: tuple, mesh, axes=None):
    """This process's shard of ``t`` under ``spec`` (see
    :func:`local_shape`): views, one ``narrow`` a split dim.  The shard
    index of a dim split over several axes runs over them in order, the
    last fastest, as JAX lays out a multi-axis entry."""
    sizes = mesh_axis_sizes(mesh)
    for d, entry in enumerate(spec):
        split = [a for a in _entry_axes(entry)
                 if axes is None or a in axes]
        n = int(np.prod([sizes[a] for a in split]))
        if n == 1:
            continue
        idx = 0
        for a in split:
            idx = idx * sizes[a] + mesh.coord(a)
        step = t.shape[d] // n
        t = t.narrow(d, idx * step, step)
    return t


def leaf_at(tree, path):
    """The leaf of ``tree`` at ``path`` (dict keys and list indices)."""
    for k in path:
        tree = tree[k]
    return tree


def named_specs(schema, specs) -> list:
    """``(leaf name, ParamSpec, spec)`` of every leaf, in tree order."""
    out: list = []
    tree_map_with_path(lambda path, ps: out.append(
        (leaf_name(path), ps, leaf_at(specs, path))), schema)
    return out


def local_schema(schema, specs, mesh, axes=None):
    """The schema of one process's shards (see :func:`local_shape`)."""
    return tree_map_with_path(
        lambda path, ps: ParamSpec(
            local_shape(ps.shape, leaf_at(specs, path), mesh, axes),
            ps.axes, ps.dtype, ps.init, ps.scale), schema)


def _own_shard(t, spec, mesh):
    """This process's shard of a whole leaf: ``t`` itself where nothing
    splits it (a view, never a copy), else an own contiguous copy of
    the shard, so the whole leaf can be freed."""
    shard = local_shard(t, spec, mesh)
    return t if shard.shape == t.shape else shard.clone(
        memory_format=torch.contiguous_format)


def local_params(schema, params, mesh, specs):
    """Each leaf of ``params`` as this process holds it under ``specs``.
    A leaf may come whole (its shard is taken) or already as this
    process's shard (kept as it is)."""
    def f(path, ps):
        t, spec = leaf_at(params, path), leaf_at(specs, path)
        want = local_shape(ps.shape, spec, mesh)
        if tuple(t.shape) == want:
            return t
        if tuple(t.shape) != tuple(ps.shape):
            raise ValueError(f"{leaf_name(path)}: {tuple(t.shape)} is "
                             f"neither the whole leaf {ps.shape} nor this "
                             f"rank's shard {want} under {spec}")
        return _own_shard(t, spec, mesh)
    return tree_map_with_path(f, schema)


def init_local_params(schema, mesh, specs, *, seed: int = 0):
    """Seeded weights on ``mesh.device``, each leaf drawn whole from the
    shared seed (the draws of ``init_from_schema``) and cut to this
    process's shard at once: the peak is the shards plus one leaf."""
    return init_from_schema(
        schema, seed=seed, device=mesh.device,
        keep=lambda path, ps, t: _own_shard(t, leaf_at(specs, path), mesh))
