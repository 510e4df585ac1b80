"""Multi-pod dry run: trace every (arch x input shape x mesh) on fake tensors.

An own copy of the reference's ``launch/dryrun.py``.  The reference
lowers and compiles each step over ``ShapeDtypeStruct`` stand-ins on 512
forced host devices and reads XLA's memory and cost analyses.  The port
has no compiler to ask, so it runs the step once, as rank 0 of a
``torch.distributed`` world of 256 ranks (one pod, ``16 x 16``) or 512
(two pods) on the fake backend, with every tensor a fake one
(``FakeTensorMode``): weights, optimizer state, batch and caches are
rank 0's shards (``launch/specs.py``'s ``ShardedShape.local``) and
nothing is allocated.  The collectives of the fake backend return at
once.  Tracing allocates nothing on a device, so it never resolves one
(``resolve_device`` is not called): a fake tensor on ``cuda`` only
carries the name, and the ops take the card's route, K1 included,
through each kernel's fake rule.

The record of a combination, with the reference's keys where the
meaning carries over (:func:`run_one`):

* ``flops``: ``FlopCounterMode``'s count of this rank's step (every op
  executed: every layer, every microbatch, the backward and the
  rematerialized forward);
* ``bytes_accessed``: each aten op's tensor operands plus results (an
  in-place op's result once, as its operand), as if nothing were fused
  (views and collectives left out);
* ``collective_bytes`` / ``collective_counts``: the reference's five
  kinds, each collective's output buffer on this rank, as its HLO
  census counts them, taken from the ``c10d`` ops dispatched (the
  tensor-parallel apply's collectives as well as
  ``models/collectives.py``'s);
* ``argument_size_in_bytes``: this rank's shards of the step's inputs
  (params, optimizer state, batch, caches) by their specs;
  ``output_size_in_bytes``: the distinct storages of the outputs;
  ``temp_size_in_bytes``: the peak of the bytes of storages made during
  the step and alive together; ``peak_bytes``: the two summed;
* ``launches``: the hand-written kernels' launches the card would
  make: the dispatches of their fake rules' ops (``repro_torch::*``; K1
  on the card's route).  A wrapper's own ``launches`` counts real
  launches only, so it stays at 0 here;
* ``info`` (microbatches, ep, flags), ``fallbacks``
  (``sharding.FALLBACK_LOG``), ``trace_s``.

A combination the port's apply refuses (``check_tensor_parallel``)
prints ``FAIL`` with the check's message; the run goes on and exits 1.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dbrx-132b \\
        --shape train_4k --mesh single --pad-heads 16
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Records go to ``experiments/dryrun_torch/``.  ``--device`` picks the
fake tensors' device: ``cuda`` (the card's route) on a torch built with
CUDA, else ``cpu`` (the plain route; a CPU-only torch cannot index a
fake CUDA tensor).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import weakref
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import sharding as shlib
from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, get_config,
                                 shape_supported)
from repro_torch.launch.mesh import make_production_mesh, mesh_from_layout
from repro_torch.launch.moe_parallel import make_ep_moe_fn
from repro_torch.launch.specs import (ShardedShape, batch_specs_at,
                                      cache_specs_at, opt_specs, param_specs,
                                      serve_param_specs, use_ep)
from repro_torch.models.registry import build_model
from repro_torch.models.schema import torch_dtype, tree_leaves
from repro_torch.models.transformer import (check_tensor_parallel,
                                            init_cache_schema)
from repro_torch.sharding import named_specs
from repro_torch.training.optimizer import OptConfig

RESULTS_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# the c10d ops the port's collectives dispatch, by the reference's kinds
_C10D_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}


# the hand-written kernels a step can reach; a kernel with a fake rule
# dispatches the op ``repro_torch::<name>`` on a fake CUDA tensor (K1,
# and the MoE layers' grouped GEMM K7 / K8)
KERNELS = ("flash_decode", "paged_flash_decode", "flash_attention",
           "ssd_chunk_scan", "grouped_gemm", "grouped_gemm_dw")


def _tensors(tree) -> list:
    """The tensors of a tree of tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Census(TorchDispatchMode):
    """Counts what a step dispatches: the bytes its aten ops read and
    write, its collectives by kind (count and output bytes), the
    kernels' would-be launches (their fake rules' ops), and the
    bytes of the storages it makes that are alive together (their
    peak).  The storages of ``arguments`` are the step's inputs: never
    counted as made.  A storage stops counting when it is freed
    (``weakref.finalize``, as ``collectives.GATHERED`` tracks the FSDP
    gathers).  Works alike on fake and real tensors."""

    def __init__(self, arguments=()):
        super().__init__()
        self.bytes_accessed = 0
        self.coll_bytes = dict.fromkeys(COLLECTIVES, 0)
        self.coll_counts = dict.fromkeys(COLLECTIVES, 0)
        self.launches = dict.fromkeys(KERNELS, 0)
        self.live = 0
        self.peak = 0
        self._seen: set = set()
        for t in _tensors(arguments):
            self._see(t, count=False)

    def _see(self, t: torch.Tensor, count: bool = True) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        self._seen.add(key)
        n = st.nbytes() if count else 0
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._drop, key, n)

    def _drop(self, key, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            kind = _C10D_KINDS.get(func._schema.name.split("::")[-1])
            if kind is not None:
                self.coll_counts[kind] += 1
                self.coll_bytes[kind] += sum(
                    _nbytes(t) for t in _tensors(args[0]))
        elif func.namespace == "repro_torch":
            name = func._schema.name.split("::")[-1]
            self.launches[name] = self.launches.get(name, 0) + 1
        elif func.namespace == "aten" and not func.is_view:
            ins = _tensors((args, kwargs))
            # an in-place op's result is its operand: one access
            seen = {id(t) for t in ins}
            self.bytes_accessed += sum(_nbytes(t) for t in ins) + sum(
                _nbytes(t) for t in _tensors(out) if id(t) not in seen)
        for t in _tensors(out):
            self._see(t)
        return out


def trace(fn, args, arguments_bytes: int) -> dict:
    """Run ``fn(*args)`` once under :class:`Census` and
    ``FlopCounterMode``; the record's counted fields."""
    from torch.utils.flop_counter import FlopCounterMode
    census = Census(args)
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as flops, census:
        out = fn(*args)
    trace_s = time.perf_counter() - t0
    outs = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in _tensors(out)}
    return {
        "trace_s": round(trace_s, 2),
        "flops": float(flops.get_total_flops()),
        "bytes_accessed": float(census.bytes_accessed),
        "collective_bytes": census.coll_bytes,
        "collective_counts": census.coll_counts,
        "argument_size_in_bytes": int(arguments_bytes),
        "output_size_in_bytes": int(sum(outs.values())),
        "temp_size_in_bytes": int(census.peak),
        "peak_bytes": int(arguments_bytes + census.peak),
        "launches": dict(census.launches),
    }


def pick_microbatches(cfg, B, S, n_batch_shards, budget=1 << 30):
    """Grad-accum factor keeping the scanned activation carry bounded.

    Budget is deliberately conservative (~1 GiB of carried activations):
    the backward live-set of one rematerialized block is ~4x the carry.
    """
    per_dev_tokens = (B // max(n_batch_shards, 1)) * S
    est = cfg.n_layers * per_dev_tokens * cfg.d_model * 2 * 2  # x + slack
    n_mb = 1
    while est / n_mb > budget and (B // max(n_batch_shards, 1)) % (n_mb * 2) == 0:
        n_mb *= 2
    return n_mb


# ---------------------------------------------------------------------------
# The fake world
# ---------------------------------------------------------------------------


def fake_world(n: int) -> None:
    """Make this process rank 0 of a world of ``n`` ranks on the fake
    backend (``torch.testing._internal.distributed.fake_pg``), replacing
    a world of another size."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def default_device() -> str:
    """``cuda`` where torch is built with CUDA, else ``cpu``: a CPU-only
    torch has no CUDA device guard, so it cannot index a fake CUDA
    tensor.  Asks the build, not a device."""
    return "cuda" if torch.version.cuda else "cpu"


def _fake(tree, device):
    """Zero tensors of the stand-ins' local shapes (inside
    ``FakeTensorMode`` nothing is allocated)."""
    if isinstance(tree, ShardedShape):
        return torch.zeros(tree.local, dtype=torch_dtype(tree.dtype),
                           device=device)
    if isinstance(tree, dict):
        return {k: _fake(v, device) for k, v in tree.items()}
    return [_fake(v, device) for v in tree]


def step_specs(cfg, shape: dict, mesh) -> dict:
    """The stand-ins of a step's arguments on ``mesh``: ``params``,
    ``opt`` and ``batch`` for a train step (the weights under FSDP),
    ``params``, ``batch`` and ``cache`` for prefill and decode (the
    weights as the serving apply holds them, whole over ``data``:
    ``ShardedExecutor``'s placement, since ``model.prefill`` and
    ``decode`` have no FSDP gather; the reference's dry run gives its
    serve steps the FSDP specs and lets GSPMD gather them)."""
    kind, B, S = shape["kind"], shape["global_batch"], shape["seq_len"]
    ep = use_ep(cfg, mesh)
    out = {"batch": batch_specs_at(cfg, kind, B, S, mesh)}
    if kind == "train":
        out["params"] = param_specs(cfg, mesh, ep=ep)
        out["opt"] = opt_specs(cfg, mesh, ep=ep)
    else:
        out["params"] = serve_param_specs(cfg, mesh, ep=ep)
        out["cache"] = cache_specs_at(cfg, B, S, mesh)
    return out


def argument_bytes(specs: dict) -> int:
    """The bytes of this rank's shards of :func:`step_specs`."""
    total = 0
    for tree in specs.values():
        for s in tree_leaves(tree):
            n = 1
            for d in s.local:
                n *= d
            total += n * torch_dtype(s.dtype).itemsize
    return total


def _global_batch(specs, device) -> dict:
    """The global batch the train step takes (each rank takes its rows)."""
    return {k: torch.zeros(s.shape, dtype=torch_dtype(s.dtype),
                           device=device) for k, s in specs.items()}


def configure(arch: str, *, q_chunk=0, window_ring=False,
              embed_one_hot=False, pad_heads=0):
    """The FULL config of ``arch`` under the flags."""
    cfg = get_config(arch, "full")
    if q_chunk:
        cfg = dataclasses.replace(cfg, attn_q_chunk=q_chunk)
    if window_ring:
        cfg = dataclasses.replace(cfg, window_ring_cache=True)
    if embed_one_hot:
        cfg = dataclasses.replace(cfg, embed_one_hot=True)
    if pad_heads:
        # pad head counts up to a TP-divisible multiple (zero-init extra
        # heads are exact; here it is a structural variant) instead of
        # falling back to head_dim sharding
        def up(h):
            return ((h + pad_heads - 1) // pad_heads) * pad_heads if h else h
        cfg = dataclasses.replace(cfg, n_heads=up(cfg.n_heads),
                                  n_kv_heads=up(cfg.n_kv_heads))
    return cfg


def build_step(cfg, shape: dict, mesh, *, device, mla_absorb=False,
               capacity_factor=1.25, microbatches=None, moe_comm_bf16=False,
               moe_scatter_down=False):
    """Returns ``(fn, args, info, argument_bytes)`` for one config at
    one input shape (``INPUT_SHAPES``' keys ``kind``, ``global_batch``,
    ``seq_len``) on ``mesh``; built inside ``FakeTensorMode`` the
    arguments are fake, outside it zeros (a real world's run of the
    same step).  Train: ``make_sharded_train_step`` at
    :func:`pick_microbatches`' factor.  Prefill: ``model.prefill``.
    Decode: ``model.decode`` and the next token's argmax, as the
    reference's ``serve_step``.  The EP ``moe_fn`` goes in where
    ``use_ep`` holds."""
    from repro_torch.training.sharded import make_sharded_train_step
    model = build_model(cfg)
    kind, B, S = shape["kind"], shape["global_batch"], shape["seq_len"]
    ep = use_ep(cfg, mesh)
    moe_fn = make_ep_moe_fn(
        mesh, capacity_factor,
        comm_dtype=torch.bfloat16 if moe_comm_bf16 else None,
        scatter_down=moe_scatter_down) if ep else None
    specs = step_specs(cfg, shape, mesh)
    nbytes = argument_bytes(specs)
    info = {"ep": ep}

    if kind == "train":
        n_mb = microbatches or pick_microbatches(cfg, B, S,
                                                 mesh.batch_shards)
        info["microbatches"] = n_mb
        step = make_sharded_train_step(model, OptConfig(), mesh,
                                       moe_fn=moe_fn, microbatches=n_mb)
        args = (_fake(specs["params"], device), _fake(specs["opt"], device),
                _global_batch(specs["batch"], device))
        return step, args, info, nbytes

    # the placement check ShardedExecutor makes
    check_tensor_parallel(
        [(n, ps, s.spec) for n, ps, s in
         named_specs(model.schema, specs["params"])
         + named_specs(init_cache_schema(cfg, B, S), specs["cache"])],
        mesh.mp)
    tp = mesh.group("model")
    args = tuple(_fake(specs[k], device) for k in ("params", "batch",
                                                    "cache"))

    if kind == "prefill":
        @torch.no_grad()
        def prefill(params, inputs, cache):
            return model.prefill(params, inputs, cache, moe_fn=moe_fn,
                                 mla_absorb=mla_absorb, tp=tp)
        return prefill, args, info, nbytes

    @torch.no_grad()
    def serve_step(params, inputs, cache):
        logits, new_cache = model.decode(params, inputs, cache,
                                         moe_fn=moe_fn,
                                         mla_absorb=mla_absorb, tp=tp)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        return nxt, new_cache
    return serve_step, args, info, nbytes


def trace_case(cfg, shape: dict, layout, *, device=None, **kw) -> dict:
    """Trace one config at one shape on ``layout`` (a
    :class:`~repro_torch.launch.mesh.LayoutMesh`) as rank 0 of a fake
    world of its size: the record's counted fields and ``info``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    device = torch.device(device or default_device())
    fake_world(int(layout.devices.size))
    mesh = mesh_from_layout(layout, device)
    shlib.FALLBACK_LOG.clear()
    with FakeTensorMode():
        fn, args, info, nbytes = build_step(cfg, shape, mesh, device=device,
                                            **kw)
        rec = trace(fn, args, nbytes)
    rec["info"] = info
    rec["fallbacks"] = list(dict.fromkeys(shlib.FALLBACK_LOG))
    return rec


def run_one(arch: str, shape_name: str, mesh_kind: str, *, device=None,
            mla_absorb=False, capacity_factor=1.25, microbatches=None,
            pad_heads=0, moe_comm_bf16=False, moe_scatter_down=False,
            q_chunk=0, window_ring=False, embed_one_hot=False) -> dict:
    """The record of one (arch, input shape, mesh) on the production
    mesh (``single``: 256 ranks; ``multi``: 512)."""
    layout = make_production_mesh(multi_pod=mesh_kind == "multi")
    cfg = configure(arch, q_chunk=q_chunk, window_ring=window_ring,
                    embed_one_hot=embed_one_hot, pad_heads=pad_heads)
    flags = dict(mla_absorb=mla_absorb, capacity_factor=capacity_factor,
                 microbatches=microbatches, pad_heads=pad_heads,
                 moe_comm_bf16=moe_comm_bf16,
                 moe_scatter_down=moe_scatter_down, q_chunk=q_chunk,
                 window_ring=window_ring, embed_one_hot=embed_one_hot)
    counted = trace_case(cfg, INPUT_SHAPES[shape_name], layout,
                         device=device, mla_absorb=mla_absorb,
                         capacity_factor=capacity_factor,
                         microbatches=microbatches,
                         moe_comm_bf16=moe_comm_bf16,
                         moe_scatter_down=moe_scatter_down)
    info = counted.pop("info")
    info.update({k: v for k, v in flags.items() if v})
    return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
            "n_devices": int(layout.devices.size), "info": info,
            "fallbacks": counted.pop("fallbacks"),
            "device": str(device or default_device()), **counted}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mla-absorb", action="store_true")
    ap.add_argument("--capacity-factor", type=float, default=1.25)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--pad-heads", type=int, default=0,
                    help="pad head counts to a multiple (e.g. 16)")
    ap.add_argument("--moe-comm-bf16", action="store_true")
    ap.add_argument("--moe-scatter-down", action="store_true")
    ap.add_argument("--q-chunk", type=int, default=0)
    ap.add_argument("--window-ring", action="store_true")
    ap.add_argument("--embed-one-hot", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="the fake tensors' device (default: cuda on a "
                         "torch built with CUDA, else cpu)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    device = args.device or default_device()
    print(f"device {device}: the "
          f"{'card' if device == 'cuda' else 'plain'} route"
          f"{'' if args.device else ' (default of this torch build)'}",
          flush=True)

    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    failures = []
    t0 = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            if not shape_supported(arch, shape):
                print(f"SKIP  {arch} × {shape} (not a supported pair)")
                continue
            for mk in meshes:
                name = f"{arch}__{shape}__{mk}{args.tag}"
                try:
                    rec = run_one(arch, shape, mk, device=device,
                                  mla_absorb=args.mla_absorb,
                                  capacity_factor=args.capacity_factor,
                                  microbatches=args.microbatches,
                                  pad_heads=args.pad_heads,
                                  moe_comm_bf16=args.moe_comm_bf16,
                                  moe_scatter_down=args.moe_scatter_down,
                                  q_chunk=args.q_chunk,
                                  window_ring=args.window_ring,
                                  embed_one_hot=args.embed_one_hot)
                    (RESULTS_DIR / f"{name}.json").write_text(
                        json.dumps(rec, indent=1))
                    print(f"OK    {name}: device={device} "
                          f"trace={rec['trace_s']}s "
                          f"flops={rec['flops']:.3g} "
                          f"temp={rec['temp_size_in_bytes'] / 2**30:.2f}GiB "
                          f"peak={rec['peak_bytes'] / 2**30:.2f}GiB "
                          f"coll={sum(rec['collective_bytes'].values()):.3g}B",
                          flush=True)
                except Exception as e:  # noqa: BLE001
                    failures.append((name, repr(e)[:400]))
                    print(f"FAIL  {name}: {repr(e)[:400]}", flush=True)
    print(f"\n{time.perf_counter() - t0:.1f} s")
    if failures:
        print(f"{len(failures)} FAILURES")
        return 1
    print("ALL DRY-RUNS PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
