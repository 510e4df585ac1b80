"""Worker bodies of the sharded-training and expert-parallel tests.

Each runs on every rank of a gloo world that ``torch_dist.run_world``
spawns: it imports torch, numpy and the port, never JAX, takes the
reference's weights and inputs as numpy arrays and returns numpy
results for the parent to hold against the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

LR = 1e-3
STEPS = 3


def _cfg(arch, **over):
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch, "smoke"), dtype="float32")
    moe = over.pop("moe", None)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return dataclasses.replace(cfg, **over)


def _t(a):
    import torch
    return torch.from_numpy(np.array(a))


def _np(tree):
    """A tree of tensors as numpy (float32 for floating leaves)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    t = tree.detach()
    return (t.float() if t.is_floating_point() else t).numpy()


# ---------------------------------------------------------------------------
# The expert-parallel block
# ---------------------------------------------------------------------------


def _ep_local(p, mesh):
    """This rank's EP leaves of an MoE block: experts over data, d_ff over
    model, the router whole, the shared expert's d_ff over model."""
    from repro_torch.sharding import local_shard
    specs = {"router": (None, None), "w_gate": ("data", None, "model"),
             "w_up": ("data", None, "model"),
             "w_down": ("data", "model", None)}
    out = {k: local_shard(_t(p[k]), spec, mesh).clone().requires_grad_()
           for k, spec in specs.items()}
    if "shared" in p:
        sspec = {"w_gate": (None, "model"), "w_up": (None, "model"),
                 "w_down": ("model", None)}
        out["shared"] = {k: local_shard(_t(v), sspec[k], mesh).clone()
                         .requires_grad_() for k, v in p["shared"].items()}
    return out


def ep_block(rank, spec, cases):
    """``make_ep_moe_fn`` on this rank's rows and shards for each case
    ``(key, arch, np_params, x, c, capacity, scatter_down, comm_dtype)``:
    y and aux, the keep mask of this rank's (T, k) choices, and the
    gradients of sum(y * c) + aux for this rank's expert shards, its x
    rows, and the router and the shared expert summed over the data
    ranks (each data rank holds its own rows' part)."""
    import torch
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.launch.moe_parallel import make_ep_moe_fn
    from repro_torch.models.collectives import reduce_sum
    from repro_torch.models.schema import tree_leaves
    mesh = make_serving_mesh(spec, device="cpu")
    dp, r = mesh.dp, mesh.coord("data")
    out = {"coords": dict(mesh.coords)}
    for key, arch, p, x, c, cap, scatter, comm in cases:
        cfg = _cfg(arch)
        b = x.shape[0] // dp
        xl = _t(x[r * b:(r + 1) * b]).requires_grad_()
        cl = _t(c[r * b:(r + 1) * b])
        pl = _ep_local(p, mesh)
        fn = make_ep_moe_fn(mesh, capacity_factor=cap, scatter_down=scatter,
                            comm_dtype={"bf16": torch.bfloat16}.get(comm))
        stats = {}
        y, aux = fn(pl, xl, cfg, stats=stats)
        leaves = tree_leaves(pl)
        grads = torch.autograd.grad((y * cl).sum() + aux, leaves + [xl])
        g = dict(zip(["x"], grads[-1:]))
        # tree_leaves' order: sorted keys, the shared expert's inside
        names = [f"{k}/{j}" if k == "shared" else k for k in sorted(pl)
                 for j in (sorted(pl[k]) if k == "shared" else [None])]
        for name, grad in zip(names, grads[:-1]):
            if name == "router" or name.startswith("shared/"):
                grad = reduce_sum(grad.clone(), mesh.group("data"))
            g[name] = grad
        out[key] = {"y": _np(y), "aux": float(aux.detach()),
                    "keep": _np(stats["keep"]),
                    "kept": int(stats["kept"]), "grads": _np(g)}
    return out


# ---------------------------------------------------------------------------
# The sharded train step
# ---------------------------------------------------------------------------


def _steps(model, mesh, np_params, batch, *, moe_fn=None, microbatches=1):
    """STEPS sharded train steps from ``np_params`` on ``batch``: the
    metrics of each, the params gathered whole, the first moments
    gathered whole, and the FSDP gather's peak of live bytes."""
    import torch
    from repro_torch.bridge import params_from_numpy
    from repro_torch.models import collectives as C
    from repro_torch.training import OptConfig
    from repro_torch.training.sharded import (gather_params, init_opt_state,
                                              make_sharded_train_step,
                                              shard_params)
    params = shard_params(model, mesh, params_from_numpy(np_params,
                                                         device="cpu"))
    opt = init_opt_state(model, mesh)
    step = make_sharded_train_step(
        model, OptConfig(lr=LR, warmup_steps=1, total_steps=10), mesh,
        moe_fn=moe_fn, microbatches=microbatches)
    b = {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}
    metrics, issued = [], []
    C.reset_counts()
    peak = 0
    for _ in range(STEPS):
        C.reset_counts()
        params, opt, m = step(params, opt, b)
        metrics.append({k: float(v) for k, v in m.items()})
        issued.append(dict(C.ISSUED))
        peak = max(peak, C.GATHERED["peak"])
    return {"metrics": metrics, "issued": issued, "peak": peak,
            "params": _np(gather_params(model, mesh, params)),
            "m": _np(gather_params(model, mesh, opt["m"])),
            "requires_grad": any(t.requires_grad for t in
                                 _leaves(params))}


def _leaves(tree):
    from repro_torch.models.schema import tree_leaves
    return tree_leaves(tree)


def train_layout(rank, spec, cases):
    """Each case ``(key, arch, over, np_params, batch, kind)`` on the
    mesh ``spec``: kind "steps" (STEPS train steps), "mb2" (at
    microbatches=2), "ep" (with the EP moe_fn at capacity 2.0), "eval"
    (the sharded eval step, and K4's gate left off), "ep_cached"
    (prefill and 4 greedy decode steps with the EP moe_fn on this
    rank's rows), "ep_aux" (the aux loss of the sharded forward with the
    EP moe_fn), "refuse" (the step's ValueError text)."""
    import torch
    from repro_torch.bridge import params_from_numpy
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.launch.moe_parallel import make_ep_moe_fn
    from repro_torch.models import build_model
    from repro_torch.training import OptConfig
    from repro_torch.training.sharded import (make_sharded_eval_step,
                                              make_sharded_train_step,
                                              shard_params)
    mesh = make_serving_mesh(spec, device="cpu")
    out = {"coords": dict(mesh.coords)}
    for key, arch, over, np_params, batch, kind in cases:
        model = build_model(_cfg(arch, **over))
        if kind == "refuse":
            try:
                make_sharded_train_step(model, OptConfig(), mesh)
            except ValueError as exc:
                out[key] = str(exc)
            else:
                out[key] = None
            continue
        if kind in ("steps", "mb2", "ep"):
            out[key] = _steps(
                model, mesh, np_params, batch,
                moe_fn=(make_ep_moe_fn(mesh, capacity_factor=2.0)
                        if kind == "ep" else None),
                microbatches=2 if kind == "mb2" else 1)
            continue
        params = shard_params(model, mesh,
                              params_from_numpy(np_params, device="cpu"))
        b = {k: torch.from_numpy(v.astype(np.int64))
             for k, v in batch.items()}
        if kind == "eval":
            out[key] = float(make_sharded_eval_step(model, mesh)(params, b))
            continue
        fn = make_ep_moe_fn(mesh, capacity_factor=2.0)
        dp, r = mesh.dp, mesh.coord("data")
        n = b["tokens"].shape[0] // dp
        rows = {k: v[r * n:(r + 1) * n] for k, v in b.items()}
        # dbrx SMOKE's leaves are under FSDP_MIN_SIZE: none is gathered
        assert not any("data" in spec and ps.axes[spec.index("data")]
                       != "experts" for _, ps, spec in _named(model, mesh))
        with torch.no_grad():
            if kind == "ep_aux":
                _, extras = model.train_logits(
                    params, {"tokens": rows["tokens"]}, moe_fn=fn)
                out[key] = float(extras["aux_loss"])
                continue
            cache = model.init_cache(n, rows["tokens"].shape[1] + 8,
                                     device="cpu")
            logits, cache = model.prefill(params, {"tokens": rows["tokens"]},
                                          cache, moe_fn=fn)
            got, toks = [logits], []
            for _ in range(4):
                nxt = logits[:, -1].argmax(-1)
                toks.append(nxt)
                logits, cache = model.decode(params, {"tokens": nxt[:, None]},
                                             cache, moe_fn=fn)
                got.append(logits)
        out[key] = {"logits": [_np(x) for x in got],
                    "tokens": [_np(t) for t in toks]}
    return out


def _named(model, mesh):
    from repro_torch.sharding import named_specs
    from repro_torch.training.sharded import train_specs
    return named_specs(model.schema, train_specs(model, mesh))


# ---------------------------------------------------------------------------
# The dry run against a real world
# ---------------------------------------------------------------------------


def dryrun_real(rank, spec, arch, over, shape):
    """The dry run's counted fields of this rank's step (``shape``: the
    dry run's kind / global_batch / seq_len) run for real on the mesh
    ``spec`` (zero weights and batch)."""
    import torch
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_serving_mesh
    mesh = make_serving_mesh(spec, device="cpu")
    fn, args, info, nbytes = D.build_step(_cfg(arch, **over), shape, mesh,
                                          device=torch.device("cpu"))
    rec = D.trace(fn, args, nbytes)
    rec["info"] = info
    return rec


def dryrun_fake(rank, axes, grid, arch, over, shape):
    """The same step traced as rank 0 of a fake world of the grid's size
    (this process's gloo world of one is replaced)."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import LayoutMesh
    layout = LayoutMesh(tuple(axes),
                        np.arange(int(np.prod(grid))).reshape(grid))
    return D.trace_case(_cfg(arch, **over), shape, layout, device="cpu")
