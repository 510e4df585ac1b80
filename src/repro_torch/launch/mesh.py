"""The serving mesh on ``torch.distributed``, and the card's constants.

An own copy of the reference's ``launch/mesh.py`` (``check_mp_divisibility``,
``make_serving_mesh``, ``make_local_mesh``, ``make_production_mesh``)
for SPMD serving and training: one process per card, started by
``torchrun --nproc-per-node N`` (or one process alone, which makes a
world of one itself).  A :class:`ServingMesh` lays the world's ranks out
as a ``(dp, mp)`` grid with the axis names ``("data", "model")``, or as
a ``(pod, dp, mp)`` grid over ``("pod", "data", "model")``, row-major
as ``torch.distributed.device_mesh.init_device_mesh`` lays it out, and
holds this rank's coordinates, the process group of each axis (and of
``pod`` x ``data``, the batch's axes) and the rank's device.  The mesh
hands plain process groups to the executor, the model apply and sharded
retrieval, whose hand-written kernels take plain local tensors: no
DTensor.

The same mesh carries sharded training
(:mod:`repro_torch.training.sharded`).  :func:`make_production_mesh` is
the reference's production layout without processes, for resolving
specs (:mod:`repro_torch.launch.specs`); :func:`mesh_from_layout` puts
process groups on such a layout, which the dry run
(:mod:`repro_torch.launch.dryrun`) does over a fake world of 256 or 512
ranks.

**One host clock.**  Every rank of a serving mesh runs the whole host
scheduler on the same inputs, and a clock reading is one of them: a
deadline, a retry's budget or a latency that one rank reads past its
limit and another does not sends the ranks down different paths, and
their next collectives no longer pair.  The reference serves a mesh
from one controller, so it has one clock.  :func:`make_serving_mesh`
also makes the *host group*, one gloo group over the whole world (on
the card beside the NCCL axis groups, so a host float never goes
through a CUDA tensor), and :meth:`ServingMesh.agreed_clock` wraps a
clock so that every rank reads rank 0's reading.

:data:`PEAK_FLOPS_BF16`, :data:`HBM_BW` and :data:`LINK_BW` feed the
roofline (:mod:`repro_torch.analysis.roofline`).
"""
from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.device import resolve_device

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")

# The card's rates, for the roofline (per card): the data-sheet figures
# of the NVIDIA H100 80GB HBM3 (SXM, 700 W), the card chip_smoke.py
# reports.  They take the place of the reference's TPU v5e figures
# (197e12 FLOP/s, 819e9 B/s, 50e9 B/s a link).
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense bf16 on the tensor cores
HBM_BW = 3.35e12              # B/s
# NVLink 4: 900 GB/s a card, 450e9 B/s each direction.  One figure
# serves every axis, as the reference's ICI_BW does: a 16-wide model
# axis spans two 8-card nodes, whose network is not modelled, as the
# reference does not model the DCN between its pods.
LINK_BW = 450e9               # B/s, per direction


@dataclass
class ServingMesh:
    """A ``(dp, mp)`` or ``(pod, dp, mp)`` grid of the world's ranks.
    ``devices`` is the grid of global ranks (``axis_names`` and
    ``devices.shape`` are all the sharding resolver reads); ``coords``
    this rank's position on each axis; ``groups`` the process group
    holding this rank of each axis and of ``BATCH`` (``pod`` x
    ``data``).  An axis the mesh lacks has size 1 and coordinate 0.
    ``host`` is the gloo group over the whole world that carries rank
    0's host readings (:meth:`agree`, :meth:`agreed_clock`); a mesh made
    by :func:`mesh_from_layout` alone has none."""
    devices: np.ndarray
    coords: Dict[str, int]
    groups: Dict[str, object]
    device: torch.device
    axis_names: tuple = AXES
    host: object = None

    @property
    def n_ranks(self) -> int:
        return int(self.devices.size)

    @property
    def leader(self) -> bool:
        """This process is rank 0, whose host readings every rank takes."""
        return dist.get_rank() == 0

    def agree(self, values: Sequence[float], n: int) -> List[float]:
        """Rank 0's ``values`` (at most ``n`` floats, zero-padded to
        ``n``) on every rank: one float64 broadcast on the host group.
        The other ranks' ``values`` are not read."""
        buf = torch.zeros(n, dtype=torch.float64)
        if self.leader and len(values):
            buf[:len(values)] = torch.tensor(values, dtype=torch.float64)
        dist.broadcast(buf, src=0, group=self.host)
        return buf.tolist()

    def agreed_clock(self, clock: Callable[[], float]) -> Callable[[], float]:
        """``clock`` itself in a world of one, else an :class:`AgreedClock`
        over it: every host decision of a mesh reads rank 0's clock."""
        if self.n_ranks == 1:
            return clock
        if self.host is None:
            raise ValueError("this mesh has no host group (mesh_from_layout "
                             "makes none): serve on make_serving_mesh's")
        return AgreedClock(clock, self)

    def size(self, axis: str) -> int:
        if axis not in self.axis_names:
            return 1
        return int(self.devices.shape[self.axis_names.index(axis)])

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups[axis]

    @property
    def pod(self) -> int:
        return self.size("pod")

    @property
    def batch_shards(self) -> int:
        """The batch's shards: ``pod`` x ``data``."""
        return self.pod * self.dp

    @property
    def batch_index(self) -> int:
        """This rank's shard of the batch, pod-major as a
        ``("pod", "data")`` spec lays the rows out."""
        return self.coord("pod") * self.dp + self.coord("data")

    @property
    def dp(self) -> int:
        return self.size("data")

    @property
    def mp(self) -> int:
        return self.size("model")


class AgreedClock:
    """Rank 0's reading of a ``perf_counter``-style ``clock`` on every
    rank of a serving mesh.  Each call is one read: rank 0 calls
    ``clock`` and broadcasts the float64 on the mesh's host group
    (:meth:`ServingMesh.agree`), and every rank returns that value; the
    other ranks never call their own.  Reads keep program order, so a
    scripted clock gives the readings one device gives.  A read is a
    collective: call it from one thread of a rank at a time, the same
    number of times on every rank (``reads`` counts them)."""

    def __init__(self, clock: Callable[[], float], mesh: "ServingMesh"):
        self.clock = clock
        self.mesh = mesh
        self.reads = 0

    def __call__(self) -> float:
        self.reads += 1
        return self.mesh.agree([self.clock()] if self.mesh.leader else [],
                               1)[0]


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


BATCH = "batch"     # the group key of pod x data


def _parse(spec: str):
    parts = dict(kv.split("=", 1) for kv in spec.split(",") if kv)
    unknown = set(parts) - {"pod", "dp", "mp"}
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)} in {spec!r} "
                         "(expected dp=N[,mp=M])")
    return (int(parts.get("pod", 1)), int(parts.get("dp", 1)),
            int(parts.get("mp", 1)))


def mesh_from_layout(layout, device: torch.device) -> ServingMesh:
    """Process groups on ``layout`` (a :class:`LayoutMesh` whose grid
    holds the world's ranks) for this rank.  Every rank creates every
    group, in the same order (``torch.distributed.new_group``'s rule):
    each axis's lines of the grid, then, with a ``pod`` axis, the
    ``pod`` x ``data`` planes (a line holding every rank takes the
    world's group).  Touches no device."""
    grid, axes = np.asarray(layout.devices), tuple(layout.axis_names)
    rank = dist.get_rank()
    where = np.argwhere(grid == rank)[0]
    coords = {a: int(c) for a, c in zip(axes, where)}
    groups = {}

    def lines(axis_idx):
        moved = np.moveaxis(grid, axis_idx, -1)
        return moved.reshape(-1, moved.shape[-1])

    plans = [(a, lines(i)) for i, a in enumerate(axes)]
    if "pod" in axes:
        # pod x data: the model axis last, each plane flattened pod-major
        moved = np.moveaxis(grid, axes.index("model"), 0)
        plans.append((BATCH, moved.reshape(moved.shape[0], -1)))
    for key, rows in plans:
        for ranks in rows:
            ranks = [int(r) for r in ranks]
            # a line that spans the world is the world's own group, as
            # init_device_mesh takes it
            g = (dist.group.WORLD if len(ranks) == dist.get_world_size()
                 else dist.new_group(ranks))
            if rank in ranks:
                groups[key] = g
    groups.setdefault(BATCH, groups["data"])
    return ServingMesh(devices=grid, coords=coords, groups=groups,
                       device=device, axis_names=axes)


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
    """Parse a ``[pod=P,]dp=N[,mp=M]`` flag into a ``("data", "model")``
    mesh, or a ``("pod", "data", "model")`` one where ``pod`` is given.

    The serving executor shards the continuous engine's slot dimension
    over ``data`` and, with ``mp > 1``, the model's attention heads, FFN
    and vocab over ``model`` (tensor parallel).  Pass the target
    ``model_cfg`` to check up front that ``mp`` divides those dims
    (:func:`check_mp_divisibility`), before any device is touched.

    ``pod * dp * mp`` must equal the world's size: that of an initialized
    process group, else the ``WORLD_SIZE`` that ``torchrun
    --nproc-per-node dp*mp`` sets (the group is then initialized from
    ``torchrun``'s environment), else 1 — one process alone makes a
    world of one over an in-memory ``HashStore``.  The backend is NCCL
    on ``cuda``, gloo on ``cpu``; the host group (``ServingMesh.host``)
    is gloo on both, made after the axis groups on every rank.
    """
    pod, dp, mp = _parse(spec)
    if model_cfg is not None:
        check_mp_divisibility(model_cfg, mp, spec=spec)
    n = (dist.get_world_size() if dist.is_initialized()
         else int(os.environ.get("WORLD_SIZE", 1)))
    if pod * dp * mp != n:
        raise ValueError(
            f"mesh {spec!r} needs {pod * dp * mp} processes but the world "
            f"has {n} (start one process a device: torchrun "
            f"--nproc-per-node {pod * dp * mp})")
    dev = _rank_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:          # started by torchrun
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
    shape, axes = ((pod, dp, mp), POD_AXES) if "pod" in spec else (
        (dp, mp), AXES)
    mesh = mesh_from_layout(LayoutMesh(axes, np.arange(n).reshape(shape)),
                            dev)
    mesh.host = dist.new_group(backend="gloo")
    return mesh


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
