"""The expert-parallel block as a drop-in ``moe_fn``.

An own copy of the reference's ``launch/moe_parallel.py``.  The
reference wraps ``moe_apply_ep`` in ``shard_map`` over its mesh; the
port is SPMD already (one process a card), so the wrapper hands
:func:`repro_torch.models.moe.moe_apply_ep` this rank's rows, this
rank's weight shards and the mesh's process groups.
"""
from __future__ import annotations

from functools import partial

from repro_torch.core.config import ModelConfig
from repro_torch.models.moe import moe_apply_ep


def make_ep_moe_fn(mesh, capacity_factor: float = 1.25, comm_dtype=None,
                   scatter_down: bool = False):
    """Returns ``moe_fn(p, x, cfg) -> (y, aux)`` running expert-parallel
    on ``mesh`` (a :class:`~repro_torch.launch.mesh.ServingMesh`).

    ``p`` holds this rank's leaves as the reference's ``in_specs`` lay
    them out: the expert weights split experts -> ``data`` and d_ff ->
    ``model`` (``specs_for_schema(..., ep=True)``), the router whole, the
    shared expert's d_ff over ``model`` (FSDP's gathers done); ``x`` is
    this rank's rows: a batch the data axis divides is split over
    it, one it does not is the same on every rank, as the reference's
    ``x_spec`` replicates it (the block computes the same either way).
    The ``all_to_all`` runs over ``data``; the aux loss is averaged over
    the replica ranks (``data``: the port's meshes have no ``pod``
    axis)."""
    fn = partial(moe_apply_ep, data_group=mesh.group("data"),
                 model_group=mesh.group("model"),
                 replica_group=mesh.group("data"),
                 capacity_factor=capacity_factor, comm_dtype=comm_dtype,
                 scatter_down=scatter_down)

    def moe_fn(p, x, cfg: ModelConfig, stats=None):
        return fn(p, x, cfg, stats=stats)

    return moe_fn
