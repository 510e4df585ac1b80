"""Sharded train and eval steps: FSDP over ``data`` x tensor parallel
over ``model`` (x data parallel over ``pod``), on ``torch.distributed``.

The reference has no module of this name: it jits ``make_train_step``
over FSDP specs (``launch/specs.py::param_specs`` / ``opt_specs``, built
in ``launch/dryrun.py::build_step``) and its GSPMD compiler inserts the
collectives.  The port writes them out.  It is SPMD, one process a
card, on a :class:`~repro_torch.launch.mesh.ServingMesh`: every rank
runs the same step on its own rows of the batch and ranks meet only in
the collectives of :mod:`repro_torch.models.collectives`.  The steps
compute what the reference's single-device step computes on the whole
batch.

What each rank holds: the params and the AdamW moments as this rank's
shards under ``specs_for_schema(schema, mesh, fsdp=True, ep=use_ep(cfg,
mesh))`` (:func:`train_specs`; :func:`shard_params` and
:func:`init_opt_state` make them).

* **FSDP over data.**  Each layer's leaves split over ``data`` are
  all-gathered inside the layer's rematerialized body (the ``gather``
  hook of :mod:`repro_torch.models.transformer`), on the dim the
  resolver split (``d_model`` by preference), and the gather's backward
  reduce-scatters (sums) the gradient onto the shard; the backward pass
  gathers each layer again, so at most one layer's gathered weights
  (or the embedding's, or the head's) are alive at a time
  (``collectives.GATHERED`` measures it).  A caller's ``moe_fn`` is
  expert-parallel: the expert weights then stay on their data shards.
* **Tensor parallel over model** (mp > 1), GQA, MLA and FFN sublayers
  (DeepSeek-V3's MTP layer too): the serving apply's placement
  (``TP_AXES``) with the Megatron ``f`` / ``g`` collectives, the
  embedding's masked lookup and the logits gathered over the vocab, and
  the head_dim routes' gathers (reduce-scatter backward) and
  all-to-all where mp does not divide the heads or kv heads;
  :func:`~repro_torch.models.transformer.check_tensor_parallel` refuses
  Mamba2 and Whisper at mp > 1.
* **The multi-pod layout** (a mesh with a ``pod`` axis, the
  reference's ``(2, 16, 16)``): the batch's rows split over ``pod`` x
  ``data``, pod-major; the weights are placed as on one pod (the
  resolver puts no leaf on ``pod``), so FSDP and EP stay within a pod,
  over ``data``.
* **The loss** is the global batch's mean: each rank's CE sums and
  valid counts are summed over ``pod`` x ``data`` before the division.
  The MoE aux loss without EP takes its means over the global batch
  (:func:`~repro_torch.models.moe.router_probs` over ``pod`` x
  ``data``); with EP the ranks' aux is averaged over ``pod`` x
  ``data``, as the reference's ``pmean`` over its replica axes does.
* **Gradients.**  A leaf not split over ``data`` (below
  ``FSDP_MIN_SIZE``: norms, biases) has its gradient summed over
  ``pod`` x ``data`` (one all-reduce a dtype); a leaf split over
  ``data`` (FSDP, EP) has its reduce-scattered shard summed over
  ``pod`` where the mesh has that axis (one all-reduce a dtype); a leaf
  replicated over ``model`` already has the same gradient on every
  model rank.  The clipping norm counts each leaf once (``global_norm``
  with the mesh) and AdamW updates the shards in place.

On a mesh axis of one rank the collectives still run: the gather is a
copy of the leaf (one layer's weights at a time), the reduce-scatter a
copy of its gradient.  The batch given to a step is the global batch,
the same on every rank; each rank takes its rows, and with
``microbatches`` its rows of each global microbatch.
"""
from __future__ import annotations

from functools import partial
from typing import Dict

import torch

from repro_torch.launch.mesh import BATCH
from repro_torch.launch.specs import use_ep
from repro_torch.models import collectives as C
from repro_torch.models.moe import moe_apply_ragged
from repro_torch.models.registry import Model
from repro_torch.models.schema import zeros_from_schema
from repro_torch.models.transformer import (check_tensor_parallel,
                                            combine_loss, logit_loss_terms,
                                            loss_terms)
from repro_torch.sharding import (leaf_at, local_params, local_schema,
                                  named_specs, specs_for_schema,
                                  tree_map_with_path)
from repro_torch.training.optimizer import (OptConfig, adamw_init_schema,
                                            adamw_update)
from repro_torch.training.steps import value_and_grads


def _axes(spec) -> set:
    return {a for e in spec if e is not None
            for a in (e if isinstance(e, tuple) else (e,))}


def train_specs(model: Model, mesh):
    """The spec of every parameter leaf on ``mesh``: FSDP, and EP where
    the experts divide ``data`` (:func:`~repro_torch.launch.specs.use_ep`)."""
    return specs_for_schema(model.schema, mesh, fsdp=True,
                            ep=use_ep(model.cfg, mesh))


def shard_params(model: Model, mesh, params):
    """This rank's shards of ``params`` (whole leaves, or shards kept)."""
    return local_params(model.schema, params, mesh, train_specs(model, mesh))


def init_opt_state(model: Model, mesh):
    """Zero AdamW moments of this rank's shards, on the mesh's device."""
    schema = adamw_init_schema(model.schema)
    specs = specs_for_schema(schema, mesh, fsdp=True,
                             ep=use_ep(model.cfg, mesh))
    return zeros_from_schema(local_schema(schema, specs, mesh),
                             device=mesh.device)


@torch.no_grad()
def gather_params(model: Model, mesh, params):
    """Every leaf whole, all-gathered from the ranks' shards (each rank
    gets the whole tree)."""
    specs = train_specs(model, mesh)

    def f(path, ps):
        t = leaf_at(params, path)
        for dim, axis in enumerate(leaf_at(specs, path)):
            if axis is not None:
                t = C.all_gather(t, mesh.group(axis), dim)
        return t
    return tree_map_with_path(f, model.schema)


class _Sharded:
    """What both steps share: the specs, the groups, the gather hook,
    the MoE block and the rank's rows."""

    def __init__(self, model: Model, mesh, moe_fn):
        cfg = model.cfg
        self.model, self.mesh = model, mesh
        self.specs = train_specs(model, mesh)
        mp = mesh.size("model")
        check_tensor_parallel(named_specs(model.schema, self.specs), mp)
        self.tp = C.GradGroup(mesh.group("model")) if mp > 1 else None
        self.data = mesh.group("data")
        # the batch's axes: pod x data (data alone without a pod axis)
        self.batch = mesh.group(BATCH)
        self.pod = mesh.group("pod") if "pod" in mesh.axis_names else None
        # a caller's moe_fn is expert-parallel: its expert leaves stay
        # on their data shards
        ep = moe_fn is not None
        if ep and not use_ep(cfg, mesh):
            raise ValueError(f"{cfg.name}: an expert-parallel moe_fn needs "
                             f"the experts to divide data={mesh.dp}")
        # without EP the MoE layers take the aux loss's global means
        self.moe_fn = moe_fn if moe_fn is not None or cfg.moe is None else (
            partial(moe_apply_ragged, tp=self.tp, data=self.batch))
        # the dim each leaf is gathered on over data (None: not gathered)
        self.dims = tree_map_with_path(lambda path, ps: next(
            (i for i, e in enumerate(leaf_at(self.specs, path))
             if e == "data" and not (ep and ps.axes[i] == "experts")),
            None), model.schema)
        # a slice of a stack has lost its leading dim
        self.sliced = {k: _shift(self.dims[k]) for k in ("blocks", "encoder")
                       if k in self.dims}
        # each leaf's spec in tree order; the leaves whole on every
        # data rank
        self.leaf_specs = [spec for _, _, spec in
                           named_specs(model.schema, self.specs)]
        self.whole = [i for i, spec in enumerate(self.leaf_specs)
                      if "data" not in _axes(spec)]
        self.split = [i for i, spec in enumerate(self.leaf_specs)
                      if "data" in _axes(spec)]

    def gather(self, tree, path):
        dims = (self.sliced[path[0]] if path[0] in self.sliced
                else leaf_at(self.dims, path))
        return _map(tree, dims, lambda t, dim: t if dim is None else
                    C.gather_weight(t, self.data, dim))

    def rows(self, batch: Dict[str, torch.Tensor], microbatches: int):
        """This rank's rows of each of ``microbatches`` consecutive
        blocks of the global batch (views), over ``pod`` x ``data``."""
        dp, r = self.mesh.batch_shards, self.mesh.batch_index
        out = []
        for i in range(microbatches):
            mb = {}
            for k, x in batch.items():
                if x.shape[0] % (dp * microbatches):
                    raise ValueError(
                        f"batch of {x.shape[0]} rows does not split into "
                        f"{microbatches} microbatches over {dp} batch "
                        f"shards")
                b = x.shape[0] // (dp * microbatches)
                mb[k] = x[(i * dp + r) * b:(i * dp + r + 1) * b]
            out.append(mb)
        return out

    def loss(self, tot, n, aux, mtot, mn):
        """The global loss of this rank's sums: CE sums and counts summed
        over ``pod`` x ``data`` (one all-reduce), then divided."""
        parts = [tot, n.float()] + ([] if mtot is None
                                    else [mtot, mn.float()])
        s = C.sum_shared(torch.stack(parts), self.batch)
        return combine_loss(s[0], s[1], aux,
                            *(() if mtot is None else (s[2], s[3])))


def _shift(dims):
    if isinstance(dims, dict):
        return {k: _shift(v) for k, v in dims.items()}
    return None if dims is None else dims - 1


def _map(tree, dims, fn):
    if isinstance(tree, dict):
        return {k: _map(v, dims[k], fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, d, fn) for v, d in zip(tree, dims)]
    return fn(tree, dims)


def make_sharded_train_step(model: Model, opt_cfg: OptConfig, mesh, *,
                            moe_fn=None, microbatches: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics), :func:`repro_torch.training.steps.make_train_step` (fused
    loss) over ``mesh``: ``params`` and ``opt_state`` are this rank's
    shards (updated in place), ``batch`` the global batch; ``metrics``
    holds the global ``loss``, ``grad_norm`` and ``lr`` as tensors, the
    same on every rank.  ``moe_fn``: the MoE layers' expert-parallel block
    (:func:`repro_torch.launch.moe_parallel.make_ep_moe_fn`); it needs
    the experts to divide ``data``.  Without it the MoE layers run
    ``moe_apply_ragged`` on gathered experts with the global aux."""
    sh = _Sharded(model, mesh, moe_fn)

    def loss_for(params, mb):
        return sh.loss(*loss_terms(params, model.cfg, mb, moe_fn=sh.moe_fn,
                                   tp=sh.tp, gather=sh.gather))

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grads(loss_for, params,
                                      sh.rows(batch, microbatches))
        _sum_over(grads, sh.whole, sh.batch)
        if sh.pod is not None:
            _sum_over(grads, sh.split, sh.pod)
        params, opt_state, metrics = adamw_update(
            grads, opt_state, params, opt_cfg, mesh=mesh, specs=sh.leaf_specs)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_sharded_eval_step(model: Model, mesh, *, moe_fn=None):
    """Returns eval_step(params, batch) -> the global loss (a float32
    tensor), :func:`repro_torch.training.steps.make_eval_step` over
    ``mesh`` (the whole logits of this rank's rows, ``loss_fn``'s sums
    summed over ``pod`` x ``data``).  The attention takes the reference's kernel
    gate as ``make_eval_step`` does: K4 under
    ``cfg.use_pallas_attention``."""
    sh = _Sharded(model, mesh, moe_fn)

    @torch.no_grad()
    def eval_step(params, batch):
        rows = sh.rows(batch, 1)[0]
        inputs = {k: v for k, v in rows.items() if k != "labels"}
        logits, extras = model.train_logits(params, inputs,
                                            moe_fn=sh.moe_fn, tp=sh.tp,
                                            gather=sh.gather)
        return sh.loss(*logit_loss_terms(logits, rows["labels"],
                                         extras=extras))

    return eval_step


@torch.no_grad()
def _sum_over(grads, idx, group) -> None:
    """Sum the gradients at ``idx`` over ``group`` in place, one
    all-reduce of their concatenation a dtype."""
    by_dtype: Dict[torch.dtype, list] = {}
    for i in idx:
        by_dtype.setdefault(grads[i].dtype, []).append(i)
    for idx in by_dtype.values():
        flat = C.reduce_sum(torch.cat([grads[i].reshape(-1) for i in idx]),
                            group)
        for i, part in zip(idx, flat.split([grads[i].numel()
                                            for i in idx])):
            grads[i] = part.view_as(grads[i])
