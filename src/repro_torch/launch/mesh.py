"""The serving mesh on ``torch.distributed``.

An own copy of the reference's ``launch/mesh.py`` (``check_mp_divisibility``,
``make_serving_mesh``, ``make_local_mesh``) for SPMD serving: one
process per card, started by ``torchrun --nproc-per-node N`` (or one
process alone, which makes a world of one itself).  A
:class:`ServingMesh` lays the world's ranks out as a ``(dp, mp)`` grid
with the axis names ``("data", "model")``, row-major as
``torch.distributed.device_mesh.init_device_mesh`` does, and holds this
rank's coordinates, the process group of each axis and the rank's
device.  The mesh hands plain process groups to the executor, the model
apply and sharded retrieval, whose hand-written kernels take plain local
tensors: no DTensor.

The same mesh carries sharded training
(:mod:`repro_torch.training.sharded`).  :func:`make_production_mesh` is
the reference's production layout without processes, for resolving
specs (:mod:`repro_torch.launch.specs`).  The reference's TPU constants
(peak rates, HBM and ICI bandwidths) are not carried over: they feed its
roofline analysis, whose H100 twin is the next slice (``ROADMAP.md``
queue 1, item 9, next 1).
"""
from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.device import resolve_device

AXES = ("data", "model")


@dataclass
class ServingMesh:
    """A ``(dp, mp)`` grid of the world's ranks.  ``devices`` is the grid
    of global ranks (``axis_names`` and ``devices.shape`` are all the
    sharding resolver reads); ``coords`` this rank's position on each
    axis; ``groups`` each axis's process group holding this rank."""
    devices: np.ndarray
    coords: Dict[str, int]
    groups: Dict[str, object]
    device: torch.device
    axis_names = AXES

    def size(self, axis: str) -> int:
        return int(self.devices.shape[self.axis_names.index(axis)])

    def coord(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups[axis]

    @property
    def dp(self) -> int:
        return self.size("data")

    @property
    def mp(self) -> int:
        return self.size("model")


@dataclass(frozen=True)
class LayoutMesh:
    """A mesh's layout alone: ``axis_names`` and a ``devices`` grid of
    device numbers, no process group (what the sharding resolver
    reads)."""
    axis_names: tuple
    devices: np.ndarray


def make_production_mesh(*, multi_pod: bool = False) -> LayoutMesh:
    """The reference's production layouts (``launch/mesh.py``): one pod
    of 16 x 16 over ``("data", "model")``, or two pods, ``(2, 16, 16)``
    over ``("pod", "data", "model")``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return LayoutMesh(axes, np.arange(int(np.prod(shape))).reshape(shape))


def check_mp_divisibility(model_cfg, mp: int, *, spec: str = "") -> None:
    """Fail fast when ``mp`` can't partition a model's param schema.

    Runs the real sharding resolver (``sharding.model_axis_fallbacks``,
    divisibility fallbacks included) over the config's schema on a stub
    ``mp``-wide mesh, so the validation can never diverge from what the
    executor will do.  Leaves that would replicate over the ``model``
    axis raise ``ValueError`` naming the config and every offending
    tensor.  No device or process group is touched.
    """
    if mp <= 1:
        return
    from repro_torch.models.transformer import decoder_param_schema
    from repro_torch.sharding import model_axis_fallbacks

    _, fallbacks = model_axis_fallbacks(decoder_param_schema(model_cfg),
                                        LayoutMesh(AXES, np.empty((1, mp))))
    if fallbacks:
        raise ValueError(
            f"serving mesh {spec or f'mp={mp}'} cannot tensor-parallel "
            f"model {model_cfg.name!r}: mp={mp} divides no dim of "
            f"{', '.join(fallbacks)} — these tensors would silently "
            "replicate over the model axis; pick an mp that divides "
            "the model's head/FFN/vocab dims")


def _parse(spec: str):
    parts = dict(kv.split("=", 1) for kv in spec.split(",") if kv)
    unknown = set(parts) - {"dp", "mp"}
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)} in {spec!r} "
                         "(expected dp=N[,mp=M])")
    return int(parts.get("dp", 1)), int(parts.get("mp", 1))


def _rank_device(device) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (``torchrun`` sets it; 0
    alone), bound as the current card; the CPU as it is."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    return dev


def make_serving_mesh(spec: str, model_cfg=None, *,
                      device="cuda") -> ServingMesh:
    """Parse a ``dp=N[,mp=M]`` flag into a ``("data", "model")`` mesh.

    The serving executor shards the continuous engine's slot dimension
    over ``data`` and, with ``mp > 1``, the model's attention heads, FFN
    and vocab over ``model`` (tensor parallel).  Pass the target
    ``model_cfg`` to check up front that ``mp`` divides those dims
    (:func:`check_mp_divisibility`), before any device is touched.

    ``dp * mp`` must equal the world's size: that of an initialized
    process group, else the ``WORLD_SIZE`` that ``torchrun
    --nproc-per-node dp*mp`` sets (the group is then initialized from
    ``torchrun``'s environment), else 1 — one process alone makes a
    world of one over an in-memory ``HashStore``.  The backend is NCCL
    on ``cuda``, gloo on ``cpu``.
    """
    dp, mp = _parse(spec)
    if model_cfg is not None:
        check_mp_divisibility(model_cfg, mp, spec=spec)
    n = (dist.get_world_size() if dist.is_initialized()
         else int(os.environ.get("WORLD_SIZE", 1)))
    if dp * mp != n:
        raise ValueError(
            f"mesh {spec!r} needs {dp * mp} processes but the world has "
            f"{n} (start one process a device: torchrun --nproc-per-node "
            f"{dp * mp})")
    dev = _rank_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:          # started by torchrun
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(dev.type, (dp, mp), mesh_dim_names=AXES)
    coords = dict(zip(AXES, dm.get_coordinate()))
    return ServingMesh(devices=dm.mesh.cpu().numpy(), coords=coords,
                       groups={a: dm.get_group(a) for a in AXES},
                       device=dev)


def make_local_mesh(device="cuda") -> ServingMesh:
    """Every process of the world on the ``data`` axis (one process
    alone: a world of one)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return make_serving_mesh(f"dp={n}", device=device)


def share_from_rank0(tensors) -> None:
    """Overwrite each tensor, in place, with rank 0's.  The ranks of a
    mesh must make the same host decisions, so a router trained on each
    rank's own card (whose float sums need not end bit for bit the same
    on another card) routes with rank 0's weights everywhere."""
    for t in tensors:
        dist.broadcast(t, src=0)


@contextlib.contextmanager
def rank0_prints():
    """Standard output goes nowhere on every rank but rank 0 (with no
    process group, this process prints)."""
    if not dist.is_initialized() or dist.get_rank() == 0:
        yield
        return
    with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
        yield
