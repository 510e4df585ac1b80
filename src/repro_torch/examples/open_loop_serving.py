"""Open-loop serving & load shedding: AsyncGateway + the traffic
harness.

Replays seeded Poisson and bursty on-off arrival streams against the
AsyncGateway in virtual time and sweeps the offered load.  At
comfortable load everything is served within deadline; over-offered,
the SLO control loop starts actuating — shedding at the queue, forcing
refusals, clamping retrieval depth — and goodput-under-SLO (answers
within deadline per second) degrades gracefully instead of collapsing
into an unbounded queue.  Same seed, same numbers: the whole run is
deterministic.

The routing MLP is trained and run on ``--device`` (the card unless
``--device cpu``).  ``--backend simulator`` (the default) serves through
the simulator's synthetic service model; ``--backend engine`` through
``ContinuousEngineBackend`` over qwen SMOKE (seeded weights) on the same
device, with the engine on the same virtual clock.

The last sweep point runs with the telemetry plane attached: a
``Tracer`` + ``MetricsRegistry`` on the same virtual clock, a Chrome
trace-event JSON written to ``--trace-out`` and the Prometheus
exposition to ``--metrics-out``.

    PYTHONPATH=src python -m repro_torch.examples.open_loop_serving \\
        [--backend engine] [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.core.config import RouterConfig, TestbedConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.offline_log import build_testbed
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.routing import (ContinuousEngineBackend, MLPPolicy,
                                 SimulatorBackend, get_slo_profile)
from repro_torch.serving.streaming import AdmissionConfig, AsyncGateway
from repro_torch.serving.traffic import (LoadGenerator, OnOffProcess,
                                         PoissonProcess, VirtualClock,
                                         build_trace)

DEADLINE_MS = 120.0


def _engine_backend_factory(index, device):
    """A function of the clock that makes a ContinuousEngineBackend over
    qwen SMOKE on ``device`` (weights made once)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.models import build_model
    mcfg = get_config("qwen1.5-32b", "smoke")
    model = build_model(mcfg)
    params = model.init(seed=0, device=device)

    def make(clock):
        return ContinuousEngineBackend.create(
            model, params, HashTokenizer(mcfg.vocab_size), index,
            num_slots=4, max_prompt_len=96, max_new_tokens=4,
            clock=clock.now)
    return make


def run(policy, cfg, index, make_backend, questions, process, label,
        n_requests, telemetry=None):
    clock = VirtualClock()
    backend = make_backend(clock)
    tracer = Tracer(clock.now) if telemetry else None
    metrics = MetricsRegistry(clock.now) if telemetry else None
    gw = AsyncGateway(policy, backend, router_cfg=cfg.router, index=index,
                      clock=clock.now, deadline_ms=DEADLINE_MS,
                      admission=AdmissionConfig(max_backlog=16),
                      tracer=tracer, metrics=metrics)
    trace = build_trace(questions, process, n_requests,
                        deadline_ms=DEADLINE_MS)
    rep = LoadGenerator(gw, trace).run_virtual(clock,
                                               service_quantum_s=0.005)
    st = gw.stats
    print(f"{label:26s} goodput={rep.goodput:7.1f}/s "
          f"({rep.goodput_fraction:5.1%})  shed={rep.shed:3d}  "
          f"forced={st.forced_refusals:3d}  clamped={st.depth_clamped:3d}  "
          f"p50={rep.latency.percentile(50):6.1f}ms "
          f"p99={rep.latency.percentile(99):6.1f}ms")
    if telemetry:
        trace_out, metrics_out = telemetry
        with open(trace_out, "w") as f:
            f.write(tracer.chrome_trace_json(indent=1))
        with open(metrics_out, "w") as f:
            f.write(metrics.exposition())
        attribution = gw.budget.report_dict().get("latency_attribution", {})
        print(f"# telemetry: {tracer.n_finished} traced requests, "
              f"{len(tracer.problems())} trace problems, dominant stage "
              f"= {attribution.get('dominant_stage', '?')}")
        for stage, pct in sorted(tracer.stage_percentiles().items()):
            print(f"#   {stage:11s} n={pct['n']:4d} "
                  f"p50={pct['p50_ms']:8.2f}ms p99={pct['p99_ms']:8.2f}ms")
        print(f"# wrote {trace_out} and {metrics_out}")
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="simulator",
                    choices=("simulator", "engine"))
    ap.add_argument("--requests", type=int, default=300)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace-out", default="open_loop_trace.json")
    ap.add_argument("--metrics-out", default="open_loop_metrics.prom")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = TestbedConfig(n_train=300, n_eval=100, n_paragraphs=300,
                        router=RouterConfig(n_epochs=15))
    data, index, pipe, train_log, _ = build_testbed(cfg)
    policy = MLPPolicy.train(
        train_log, train_log.rewards(get_slo_profile("quality_first")),
        cfg.router, objective="argmax_ce", device=device)
    qs = data.questions[-100:]
    if args.backend == "engine":
        make_backend = _engine_backend_factory(index, device)
    else:
        def make_backend(clock):
            return SimulatorBackend(pipe, stream_slots=4, service_polls=2,
                                    clock=clock.now)

    print(f"# {args.requests} requests per trace, deadline {DEADLINE_MS}ms, "
          f"{args.backend} backend (virtual time)")
    reports = {}
    for rate in (50.0, 200.0, 800.0, 3200.0):
        reports[f"poisson {rate:.0f}"] = run(
            policy, cfg, index, make_backend, qs,
            PoissonProcess(rate, seed=0), f"poisson {rate:6.0f}/s",
            args.requests)
    # same mean rate as poisson 200/s, but clumped into bursts — the
    # on-off stream sheds where smooth traffic wouldn't
    reports["on-off 200"] = run(
        policy, cfg, index, make_backend, qs,
        OnOffProcess(400.0, on_s=0.25, off_s=0.25, seed=0),
        "on-off  mean 200/s", args.requests)
    # once more with the telemetry plane attached: per-request span
    # trees + metrics registry on the same virtual clock
    reports["traced"] = run(
        policy, cfg, index, make_backend, qs, PoissonProcess(200.0, seed=0),
        "poisson 200/s (traced)", args.requests,
        telemetry=(args.trace_out, args.metrics_out))
    return reports


if __name__ == "__main__":
    main()
