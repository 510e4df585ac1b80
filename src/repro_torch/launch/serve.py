"""Serving driver: the full SLO-routed RAG service loop via the Gateway.

Builds the paper testbed (corpus, BM25 index), trains a routing
policy, then serves queries end-to-end through the unified routing
API: Gateway -> RoutingPolicy.route -> action-bucketed
retrieval/generation -> reward + error-budget accounting.

The generation side is selectable: the default simulator backend (the
paper's cost model), or ``--backend continuous`` for the continuous
batching engine over ``qwen1.5-32b`` (seeded weights): ``--variant
smoke`` (the default) or ``--variant full``, the published widths.
Everything runs on ``--device`` (the card unless ``--device cpu``).
``--mesh dp=N[,mp=M]`` shards the engine over N x M processes, one a
card (:class:`repro_torch.serving.executor.ShardedExecutor`): slots
over ``dp``, params over ``mp``.  Start it under ``torchrun``: every
rank serves the same requests and rank 0 alone prints and writes the
trace and metrics files.  Without ``torchrun``, ``--mesh dp=1`` serves
in one process.

    PYTHONPATH=src python -m repro_torch.launch.serve --slo quality_first -n 50
    PYTHONPATH=src python -m repro_torch.launch.serve --backend continuous \\
        --variant full -n 16
    PYTHONPATH=src python -m repro_torch.launch.serve --backend continuous \\
        --open-loop 4 --deadline-ms 3000 -n 24 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.serve \\
        --backend continuous --variant full --mesh dp=4,mp=2 -n 16

The flags, printed lines and defaults are those of the JAX package's
serving CLI, plus ``--device`` and ``--variant``.  ``main`` returns the
run's objects (stats, policy, gateway, backend, the host seconds of the
testbed build and of the router's training) for callers in the same
process.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch.distributed as dist

from repro_torch.core.config import TestbedConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.metrics import evaluate_actions
from repro_torch.core.offline_log import build_testbed
from repro_torch.launch.mesh import (make_serving_mesh, rank0_prints,
                                     share_from_rank0)
from repro_torch.models.schema import tree_leaves
from repro_torch.routing import (ConstrainedPolicy, Gateway, MLPPolicy,
                                 Request, SimulatorBackend, get_action_space,
                                 get_slo_profile, list_slo_profiles)
from repro_torch.routing.registry import DEFAULT_SPACE, list_action_spaces


def _continuous_backend(index, num_slots, device, variant="smoke",
                        retrievers=None, cache_size: int = 0, clock=None,
                        mesh=None):
    """Real-model generation: a ContinuousEngine on ``device``, or over
    ``mesh`` with each rank drawing only its shards of the weights."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.models import build_model
    from repro_torch.routing import ContinuousEngineBackend
    from repro_torch.sharding import init_local_params, specs_for_schema

    # the JAX package's CLI serves SMOKE only; ``--variant full`` runs
    # the front door at the published widths on the card
    mcfg = get_config("qwen1.5-32b", variant)
    model = build_model(mcfg)
    if mesh is None:
        params = model.init(seed=0, device=device)
    else:
        params = init_local_params(
            model.schema, mesh,
            specs_for_schema(model.schema, mesh, fsdp=False), seed=0)
    kw = {} if clock is None else {"clock": clock}
    return ContinuousEngineBackend.create(
        model, params, HashTokenizer(mcfg.vocab_size), index,
        num_slots=num_slots, max_prompt_len=192, max_new_tokens=8,
        retrievers=retrievers, retrieval_cache_size=cache_size, mesh=mesh,
        **kw)


def _dump_telemetry(args, tracer, metrics) -> None:
    """Write the run's Chrome trace / Prometheus exposition on exit."""
    if tracer is not None and args.trace_out:
        with open(args.trace_out, "w") as f:
            f.write(tracer.chrome_trace_json(indent=1))
        probs = tracer.problems()
        print(f"# trace: {args.trace_out} "
              f"({tracer.n_finished} requests, "
              f"{len(tracer.sampled_trees)} sampled trees, "
              f"{len(probs)} problems)")
        for p in probs[:5]:
            print(f"#   trace problem: {p}")
    if metrics is not None and args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(metrics.exposition())
        print(f"# metrics: {args.metrics_out}")


def _serve_open_loop(args, policy, backend, cfg, space, index, data,
                     clock, tracer=None, metrics=None):
    """Open-loop mode: seeded Poisson arrivals through AsyncGateway in
    virtual time, per-request deadlines, SLO-actuated admission."""
    from repro_torch.serving.streaming import AdmissionConfig, AsyncGateway
    from repro_torch.serving.traffic import (LoadGenerator, PoissonProcess,
                                             build_trace)

    gateway = AsyncGateway(
        policy, backend, router_cfg=cfg.router, index=index,
        action_space=space, adaptive_refusal=args.adaptive,
        clock=clock.now, deadline_ms=args.deadline_ms,
        admission=AdmissionConfig(max_backlog=4 * args.num_slots),
        tracer=tracer, metrics=metrics)
    eval_q = data.questions[-cfg.n_eval:]
    trace = build_trace(eval_q, PoissonProcess(args.open_loop, seed=0),
                        args.n, slo=args.slo, deadline_ms=args.deadline_ms)
    print(f"# open-loop: {args.n} arrivals at {args.open_loop}/s "
          f"(poisson, seed 0), deadline {args.deadline_ms}ms")
    rep = LoadGenerator(gateway, trace).run_virtual(clock)
    print(json.dumps(rep.as_dict(), indent=1))
    st = gateway.stats
    print(f"# admission: shed={st.shed} forced_refusals="
          f"{st.forced_refusals} depth_clamped={st.depth_clamped}")
    print("# error budgets:",
          json.dumps(gateway.budget.report_dict(), indent=1))
    es = gateway.engine_stats
    if es is not None:
        print(f"# engine: prefills={es.n_prefills} "
              f"decode_chunks={es.n_decode_chunks} "
              f"max_concurrent={es.max_concurrent}")
    if tracer is not None and tracer.enabled:
        print("# stage percentiles:",
              json.dumps(tracer.stage_percentiles(), indent=1))
    _dump_telemetry(args, tracer, metrics)
    return gateway, rep


def main(argv=None, *, init_params=None) -> dict:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``).
    ``init_params(router_cfg)`` gives the router's initial params
    (default: the seeded draw)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--slo", default="quality_first",
                    choices=list_slo_profiles())
    ap.add_argument("--objective", default="argmax_ce")
    ap.add_argument("-n", type=int, default=50)
    ap.add_argument("--refusal-cap", type=float, default=1.0)
    ap.add_argument("--adaptive", action="store_true",
                    help="enable budget-driven refusal back-pressure")
    ap.add_argument("--backend", default="simulator",
                    choices=("simulator", "continuous"),
                    help="simulator = paper cost model; continuous = "
                         "slot-based engine over qwen1.5-32b")
    ap.add_argument("--variant", default="smoke", choices=("smoke", "full"),
                    help="qwen1.5-32b variant of --backend continuous")
    ap.add_argument("--mesh", default=None, metavar="dp=N[,mp=M]",
                    help="shard the continuous engine over a dp x mp "
                         "mesh of processes, one a card (torchrun): "
                         "slots on the dp (data) axis, params on the "
                         "mp (model) axis")
    ap.add_argument("--num-slots", type=int, default=8)
    ap.add_argument("--space", default=DEFAULT_SPACE,
                    choices=list_action_spaces(),
                    help="registered action space to route over; "
                         "hybrid9 adds retriever choice "
                         "(bm25|dense|hybrid) to the action set")
    ap.add_argument("--retrieval-cache", type=int, default=0,
                    metavar="N", help="bounded LRU over retrieval "
                    "results (0 = off); hit counters land in "
                    "GatewayStats")
    ap.add_argument("--open-loop", type=float, default=0.0, metavar="RATE",
                    help="serve an open-loop seeded Poisson arrival "
                         "stream at RATE req/s (virtual time) through "
                         "AsyncGateway instead of the closed-loop serve")
    ap.add_argument("--deadline-ms", type=float, default=250.0,
                    help="per-request completion deadline for "
                         "--open-loop (goodput counts answers within it)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON of the run "
                         "(open in Perfetto / chrome://tracing)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the Prometheus text exposition of the "
                         "run's metrics registry at exit")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh and args.backend != "continuous":
        ap.error("--mesh requires --backend continuous")
    device = resolve_device(args.device)
    if args.mesh:
        from repro_torch.configs import get_config
        # the process group the mesh makes (from torchrun's environment,
        # or a world of one) is this run's to destroy: left to the
        # interpreter's teardown, its threads can abort the process
        created = not dist.is_initialized()
        try:
            mesh = make_serving_mesh(
                args.mesh, model_cfg=get_config("qwen1.5-32b",
                                                args.variant),
                device=device)
            # every rank serves the same requests; rank 0 alone reports
            with rank0_prints():
                return _serve(args, mesh.device, mesh, init_params)
        finally:
            if created and dist.is_initialized():
                dist.destroy_process_group()
    return _serve(args, device, None, init_params)


def _serve(args, device, mesh, init_params) -> dict:
    """The CLI's run on parsed ``args``; over a ``mesh`` only rank 0
    writes the trace and metrics files."""
    space = get_action_space(args.space)
    cfg = TestbedConfig()
    if space.n_actions != cfg.router.n_actions:
        cfg = dataclasses.replace(cfg, router=dataclasses.replace(
            cfg.router, n_actions=space.n_actions))
    profile = get_slo_profile(args.slo)
    t0 = time.perf_counter()
    data, index, pipe, train_log, eval_log = build_testbed(
        cfg, None if args.space == DEFAULT_SPACE else space)
    seconds = {"build_testbed": time.perf_counter() - t0}
    init = None if init_params is None else init_params(cfg.router)
    t0 = time.perf_counter()
    if args.objective == "constrained":
        policy = ConstrainedPolicy.train(train_log, train_log.rewards(profile),
                                         cfg.router,
                                         refusal_cap=args.refusal_cap,
                                         init_params=init, device=device)
    else:
        policy = MLPPolicy.train(train_log, train_log.rewards(profile),
                                 cfg.router, objective=args.objective,
                                 refusal_cap=args.refusal_cap,
                                 init_params=init, device=device)
    if mesh is not None:
        share_from_rank0(tree_leaves(policy.params))
    seconds["train_router"] = time.perf_counter() - t0

    shown = [0]

    def report(req, action, out, rew):
        if shown[0] < 10:
            shown[0] += 1
            status = ("REFUSED" if out.refused
                      else ("OK" if out.correct else "WRONG"))
            print(f"q={req.question.text[:48]:50s} -> a{action.idx} "
                  f"(k={action.k},{action.mode:7s}) "
                  f"cost={out.cost_tokens:6.0f} {status}")

    clock = None
    if args.open_loop:
        from repro_torch.serving.traffic import VirtualClock
        clock = VirtualClock()
    tracer = metrics = None
    rank0 = mesh is None or dist.get_rank() == 0
    if rank0 and (args.trace_out or args.metrics_out):
        from repro_torch.obs import MetricsRegistry, Tracer
        obs_clock = clock.now if clock is not None else time.perf_counter
        tracer = Tracer(obs_clock)
        metrics = MetricsRegistry(obs_clock)
    if args.backend == "continuous":
        # reuse the suite build_testbed already wired into the pipeline
        # (it embedded the whole corpus once for non-bm25 spaces); the
        # backend wraps it behind its own cache when requested
        suite = (pipe.retrievers
                 if set(space.retriever_names) - {"bm25"} else None)
        t0 = time.perf_counter()
        backend = _continuous_backend(index, args.num_slots, device,
                                      variant=args.variant, retrievers=suite,
                                      cache_size=args.retrieval_cache,
                                      clock=clock.now if clock else None,
                                      mesh=mesh)
        seconds["build_backend"] = time.perf_counter() - t0
    else:
        if args.retrieval_cache and pipe.retrieval_cache is None:
            from repro_torch.retrieval.hybrid import resolve_retrievers
            pipe.retrievers, pipe.retrieval_cache = resolve_retrievers(
                pipe.retrievers, index, cache_size=args.retrieval_cache)
        backend = SimulatorBackend(
            pipe, **({"clock": clock.now} if clock else {}))
    run = {"policy": policy, "backend": backend, "seconds": seconds}
    t0 = time.perf_counter()
    if args.open_loop:
        run["gateway"], run["report"] = _serve_open_loop(
            args, policy, backend, cfg, space, index, data, clock,
            tracer=tracer, metrics=metrics)
        seconds["serve"] = time.perf_counter() - t0
        return run
    gateway = Gateway(policy, backend, router_cfg=cfg.router,
                      index=index, max_batch=16, action_space=space,
                      adaptive_refusal=args.adaptive, on_outcome=report,
                      tracer=tracer, metrics=metrics)

    eval_q = data.questions[-cfg.n_eval:][: args.n]
    print(f"# serving {args.n} queries under SLO={args.slo} "
          f"objective={args.objective}")
    stats = gateway.serve([Request(qid=q.qid, question=q, slo=args.slo)
                           for q in eval_q])
    seconds["serve"] = time.perf_counter() - t0
    print(f"# served={stats.served} avg_reward={stats.avg_reward:+.4f} "
          f"actions={dict(sorted(stats.action_counts.items()))}")
    if stats.retrieval_cache_lookups:
        print(f"# retrieval cache: {stats.retrieval_cache_hits}"
              f"/{stats.retrieval_cache_lookups} hits")
    es = gateway.engine_stats
    if es is not None:
        print(f"# engine: prefills={es.n_prefills} "
              f"decode_chunks={es.n_decode_chunks} "
              f"max_concurrent={es.max_concurrent} "
              f"cache_allocations={es.cache_allocations}")
    print("# error budgets:",
          json.dumps(gateway.budget.report_dict(), indent=1))
    _dump_telemetry(args, tracer, metrics)

    # offline metrics on the logged sweep for the same routed states
    acts = policy.route(eval_log.states[: args.n], args.slo).actions
    rep = evaluate_actions(eval_log.subset(np.arange(args.n)), acts, profile,
                           args.objective)
    print(json.dumps(rep.row(), indent=1))
    run.update(gateway=gateway, stats=stats)
    return run


if __name__ == "__main__":
    main()
