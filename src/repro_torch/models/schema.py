"""Parameter schema: declarative weight descriptors.

A model is described as a tree (nested dicts and lists) of
:class:`ParamSpec` leaves, the same tree the reference builds, so its
parameters carry across leaf for leaf (see :mod:`repro_torch.bridge`).
The tree drives two consumers here:

* ``init_from_schema(schema, seed=..., device=...)`` — materialize
  parameters, drawn with one seeded ``torch.Generator``;
* ``zeros_from_schema(schema, device=...)`` — the decode caches.

Every tensor is created directly in its own dtype on the target device,
one leaf at a time.  The reference draws float32 and casts; at the full
width of a 32B model that would need a 137 GB float32 copy of the
weights, which no single card holds.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import numpy as np
import torch

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
    "int32": torch.int32,
    "int8": torch.int8,
}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; "
                         f"known: {sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    # logical axis names, one per dim (kept for the sharding slice)
    axes: Tuple[str, ...]
    dtype: str = "bfloat16"
    init: str = "normal"            # normal | zeros | ones | small
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def tree_map_with_path(fn: Callable, tree, path: Tuple = ()) -> Any:
    """Map ``fn(path, leaf)`` over the leaves of a dict/list tree; a
    leaf's path holds the dict keys and list indices from the root.
    Dict keys are visited in sorted order, the order JAX flattens a dict
    in."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], path + (k,))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, t, path + (i,))
                for i, t in enumerate(tree)]
    return fn(path, tree)


def tree_map(fn: Callable, tree) -> Any:
    """Map ``fn`` over the leaves of a dict/list tree, in
    :func:`tree_map_with_path`'s order."""
    return tree_map_with_path(lambda _, leaf: fn(leaf), tree)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def _init_leaf(spec: ParamSpec, device, gen: torch.Generator) -> torch.Tensor:
    t = torch.empty(spec.shape, dtype=torch_dtype(spec.dtype), device=device)
    if spec.init == "zeros":
        return t.zero_()
    if spec.init == "ones":
        return t.fill_(1)
    scale = spec.scale * 0.1 if spec.init == "small" else spec.scale
    # drawn in the leaf's own dtype, in place: no float32 staging copy
    return t.normal_(0.0, scale, generator=gen)


def init_from_schema(schema, *, seed: int, device, keep=None) -> Any:
    """Materialize a parameter tree, leaf by leaf, from one generator
    seeded with ``seed`` on ``device``.  ``keep(path, spec, leaf)``, if
    given, replaces each leaf as soon as it is drawn (a tensor-parallel
    rank keeps its shard), so at most one whole leaf exists at a time;
    the draws are the same either way."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    def draw(path, s):
        leaf = _init_leaf(s, dev, gen)
        return leaf if keep is None else keep(path, s, leaf)
    return tree_map_with_path(draw, schema)


def zeros_from_schema(schema, *, device) -> Any:
    dev = torch.device(device)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=torch_dtype(s.dtype),
                                          device=dev), schema)


def n_params(schema) -> int:
    return int(sum(np.prod(s.shape) for s in tree_leaves(schema)))


def stack_specs(spec_tree, n: int, axis_name: str = "layers"):
    """Add a leading stacked dim (one slice per repeated block)."""
    return tree_map(
        lambda s: ParamSpec((n,) + s.shape, (axis_name,) + s.axes, s.dtype,
                            s.init, s.scale),
        spec_tree)
