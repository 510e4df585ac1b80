"""The port's open loop against the reference: twins of
``tests/test_streaming_gateway.py``, each run through both packages.

Arrival processes, traces, the virtual-time load harness, AsyncGateway
admission control (shed, force-refuse, depth-clamp), the offered-load
sweep and the background serving thread, over the deterministic
``SimulatorBackend`` of the small testbed: traces, ``LoadReport.as_dict()``,
per-handle outcomes, sheds and virtual latencies are the reference's
exactly.  Then the real continuous engine (qwen SMOKE float32, the
reference's params bridged) behind ``ContinuousEngineBackend``'s stream
protocol, dense and paged with mid-stream deadline cancellation, with
the same identity, and the stream path's host reads counted.
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import dataclasses
import importlib
import types

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ZERO_STATE = lambda qs: np.zeros((len(qs), 1))


def _ns(pkg: str):
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")
    routing, streaming, traffic = (m("routing"), m("serving.streaming"),
                                   m("serving.traffic"))
    config = m("core.config")
    return types.SimpleNamespace(
        pkg=pkg, m=m, FixedPolicy=routing.FixedPolicy,
        Request=routing.Request, Gateway=routing.Gateway,
        SimulatorBackend=routing.SimulatorBackend,
        AdmissionConfig=streaming.AdmissionConfig,
        AsyncGateway=streaming.AsyncGateway,
        StreamHandle=streaming.StreamHandle, Arrival=traffic.Arrival,
        LoadGenerator=traffic.LoadGenerator,
        OnOffProcess=traffic.OnOffProcess,
        PoissonProcess=traffic.PoissonProcess,
        VirtualClock=traffic.VirtualClock, build_trace=traffic.build_trace,
        sweep_offered_load=traffic.sweep_offered_load,
        SLOTarget=m("serving.slo_budget").SLOTarget,
        TestbedConfig=config.TestbedConfig, RouterConfig=config.RouterConfig)


REF, PORT = _ns("repro"), _ns("repro_torch")


@pytest.fixture(scope="module")
def testbeds():
    """The reference test's small testbed, built in each package."""
    out = {}
    for ns in (REF, PORT):
        cfg = ns.TestbedConfig(n_train=40, n_eval=16, n_paragraphs=60,
                               router=ns.RouterConfig(n_epochs=1))
        out[ns.pkg] = ns.m("core.offline_log").build_testbed(cfg)
    return out


def _gateway(ns, pipe, clock, *, action=2, deadline_ms=200.0,
             admission=None, **kw):
    be = ns.SimulatorBackend(pipe, stream_slots=4, service_polls=2,
                             clock=clock.now)
    return ns.AsyncGateway(ns.FixedPolicy(action), be, state_fn=ZERO_STATE,
                           clock=clock.now, deadline_ms=deadline_ms,
                           admission=admission or ns.AdmissionConfig(), **kw)


def _handles(handles):
    return [(h.request.qid, h.done(), h.shed, h.forced_refusal, h.retries,
             h.outcome.action, h.outcome.answer, h.outcome.correct,
             h.outcome.refused, h.latency_ms, h.first_token_ms,
             h.deadline_met) for h in handles]


def _stats(st):
    return (st.served, st.shed, st.forced_refusals, st.depth_clamped,
            st.degraded, st.retries, st.timed_out, st.faulted,
            dict(sorted(st.action_counts.items())), st.total_reward,
            st.latency_percentiles())


def _replay(ns, testbeds, rate, n, *, qs=8, deadline_ms=500.0, seed=0,
            quantum=0.01, gw_deadline_ms=200.0, **gw_kw):
    """One virtual-time replay over the simulator (``deadline_ms`` on
    the trace, ``gw_deadline_ms`` the gateway's default); everything a
    twin compares."""
    data, _, pipe, *_ = testbeds[ns.pkg]
    clock = ns.VirtualClock()
    gw = _gateway(ns, pipe, clock, deadline_ms=gw_deadline_ms, **gw_kw)
    trace = ns.build_trace(data.questions[:qs],
                           ns.PoissonProcess(rate, seed=seed), n,
                           deadline_ms=deadline_ms)
    gen = ns.LoadGenerator(gw, trace)
    rep = gen.run_virtual(clock, service_quantum_s=quantum)
    return rep, gw, (rep.as_dict(), _handles(gen.last_handles),
                     _stats(gw.stats), gw.in_flight)


# --- arrival processes ------------------------------------------------------


def test_poisson_seeded_and_mean_rate():
    def gaps(ns, seed):
        it = ns.PoissonProcess(100.0, seed=seed).inter_arrivals()
        return [next(it) for _ in range(5000)]

    a = gaps(PORT, 7)
    assert a == gaps(PORT, 7) == gaps(REF, 7)
    assert np.mean(a) == pytest.approx(1 / 100.0, rel=0.1)
    with pytest.raises(ValueError):
        PORT.PoissonProcess(0.0)


def test_onoff_bursty_but_same_mean():
    def gaps(ns):
        p = ns.OnOffProcess(200.0, on_s=0.5, off_s=0.5, seed=3)
        it = p.inter_arrivals()
        return p.mean_rate, [next(it) for _ in range(8000)]

    mean, g = gaps(PORT)
    assert mean == pytest.approx(100.0)
    assert 1 / np.mean(g) == pytest.approx(100.0, rel=0.25)
    assert np.std(g) / np.mean(g) > 1.3
    assert (mean, g) == gaps(REF)
    with pytest.raises(ValueError):
        PORT.OnOffProcess(0.0)


def test_build_trace_monotone_and_cycling(testbeds):
    def trace(ns):
        qs = testbeds[ns.pkg][0].questions[:3]
        tr = ns.build_trace(qs, ns.PoissonProcess(10.0, seed=0), 7,
                            deadline_ms=123.0, slo="cheap")
        return qs, tr, [(a.t, a.request.qid, a.request.question.qid,
                         a.request.slo, a.request.deadline_ms) for a in tr]

    qs, tr, rows = trace(PORT)
    assert len(tr) == 7
    ts = [a.t for a in tr]
    assert ts == sorted(ts) and ts[0] > 0
    assert [a.request.qid for a in tr] == list(range(7))
    assert tr[3].request.question is qs[0]
    assert all(a.request.deadline_ms == 123.0 for a in tr)
    assert all(a.request.slo == "cheap" for a in tr)
    assert rows == trace(REF)[2]
    with pytest.raises(ValueError):
        PORT.build_trace([], PORT.PoissonProcess(1.0), 3)


def test_virtual_clock():
    c = PORT.VirtualClock()
    assert c.now() == 0.0
    c.advance(1.5)
    c.advance_to(1.0)
    assert c.now() == 1.5
    with pytest.raises(ValueError):
        c.advance(-1.0)


# --- AsyncGateway: open-loop serving ----------------------------------------


def test_open_loop_serves_trace_and_stamps_latency(testbeds):
    rep, gw, got = _replay(PORT, testbeds, 40.0, 40)
    assert rep.offered == 40 and rep.completed == 40
    assert rep.shed == 0
    assert rep.answered + rep.refused == 40
    p = rep.latency.percentiles()
    assert p["n"] > 0 and p["p50_ms"] >= 0.0
    assert gw.stats.served == 40
    assert gw.stats.latency_percentiles()["n"] == 40
    assert gw.in_flight == 0
    assert got == _replay(REF, testbeds, 40.0, 40)[2]


def test_open_loop_deterministic_same_seed(testbeds):
    def run(ns):
        return _replay(ns, testbeds, 300.0, 60, deadline_ms=100.0, seed=11,
                       admission=ns.AdmissionConfig(max_backlog=6))[2]

    got = run(PORT)
    assert got == run(PORT) == run(REF)


def test_backlog_shedding_engages_under_overload(testbeds):
    def run(ns):
        return _replay(ns, testbeds, 500.0, 80, deadline_ms=1000.0,
                       admission=ns.AdmissionConfig(max_backlog=4))

    rep, gw, got = run(PORT)
    assert rep.shed > 0
    assert gw.stats.shed == rep.shed
    assert rep.completed == rep.offered
    assert rep.shed + rep.answered + rep.refused == rep.offered
    assert got == run(REF)[2]


def test_expired_deadline_shed_at_queue(testbeds):
    def run(ns):
        data, _, pipe, *_ = testbeds[ns.pkg]
        clock = ns.VirtualClock()
        gw = _gateway(ns, pipe, clock, deadline_ms=5.0,
                      admission=ns.AdmissionConfig(max_backlog=1000))
        h = gw.submit_stream(ns.Request(qid=0, question=data.questions[0]))
        clock.advance(1.0)
        gw.pump()
        return h, gw, _handles([h])

    h, gw, got = run(PORT)
    assert h.done() and h.shed
    assert gw.stats.shed == 1
    assert not h.deadline_met
    assert got == run(REF)[2]


def test_latency_burn_shed_and_forced_refusals(testbeds):
    def run(ns):
        adm = ns.AdmissionConfig(max_backlog=10_000, min_events=8,
                                 shed_burn=3.0, force_refuse_burn=2.0,
                                 burn_window=16, shed_expired=False)
        rep, gw, got = _replay(ns, testbeds, 200.0, 60, deadline_ms=10.0,
                               gw_deadline_ms=10.0, admission=adm)
        return rep, gw, got + (gw.budget.burn_rate("latency"),)

    rep, gw, got = run(PORT)
    assert got[-1] > 1.0
    assert gw.stats.forced_refusals > 0 or gw.stats.shed > 0
    assert rep.forced_refusals == gw.stats.forced_refusals
    assert got == run(REF)[2]


def test_depth_clamp_on_cost_burn(testbeds):
    def run(ns):
        targets = [ns.SLOTarget("cost", "cost_tokens", 1.0, objective=0.95)]
        adm = ns.AdmissionConfig(max_backlog=10_000, min_events=4,
                                 clamp_burn=1.0, force_refuse_burn=1e9,
                                 shed_burn=1e9)
        return _replay(ns, testbeds, 40.0, 30, deadline_ms=0.0,
                       gw_deadline_ms=0.0, admission=adm,
                       budget_targets=targets)

    rep, gw, got = run(PORT)
    assert gw.stats.depth_clamped > 0
    assert gw.stats.forced_refusals == 0
    shallow = min((a for a in gw.space if a.mode == "guarded" and a.k > 0),
                  key=lambda a: a.k)
    assert gw.stats.action_counts[shallow.idx] > 0
    assert got == run(REF)[2]


def test_closed_loop_paths_untouched(testbeds):
    def run(ns):
        data, _, pipe, *_ = testbeds[ns.pkg]
        reqs = [ns.Request(qid=q.qid, question=q)
                for q in data.questions[:12]]
        base = ns.Gateway(ns.FixedPolicy(1), ns.SimulatorBackend(pipe),
                          state_fn=ZERO_STATE).serve(list(reqs))
        stream = _gateway(ns, pipe, ns.VirtualClock(),
                          action=1).serve(list(reqs))
        return base, stream

    base, stream = run(PORT)
    assert base.served == stream.served == 12
    assert dict(base.action_counts) == dict(stream.action_counts)
    assert base.total_reward == pytest.approx(stream.total_reward)
    ref_base, _ = run(REF)
    assert dict(base.action_counts) == dict(ref_base.action_counts)
    assert base.total_reward == ref_base.total_reward


def test_async_gateway_rejects_nonstreaming_backend():
    class NoStream:
        def execute_batch(self, qs, a):
            return []

    with pytest.raises(TypeError):
        PORT.AsyncGateway(PORT.FixedPolicy(0), NoStream(),
                          state_fn=ZERO_STATE)


def test_stream_handle_result_timeout(testbeds):
    data, _, pipe, *_ = testbeds["repro_torch"]
    clock = PORT.VirtualClock()
    gw = _gateway(PORT, pipe, clock)
    h = gw.submit_stream(PORT.Request(qid=0, question=data.questions[0]))
    with pytest.raises(TimeoutError):
        h.result(timeout=0.01)
    gw.drain_stream()
    assert h.done() and h.result() is not None


def test_background_thread_smoke(testbeds):
    data, _, pipe, *_ = testbeds["repro_torch"]
    be = PORT.SimulatorBackend(pipe, stream_slots=4, service_polls=2)
    gw = PORT.AsyncGateway(PORT.FixedPolicy(2), be, state_fn=ZERO_STATE,
                           deadline_ms=10_000.0)
    with gw:
        handles = [gw.submit_stream(PORT.Request(qid=i, question=q))
                   for i, q in enumerate(data.questions[:10])]
        outs = [h.result(timeout=30.0) for h in handles]
    assert len(outs) == 10 and all(o is not None for o in outs)
    assert gw.stats.served + gw.stats.shed == 10
    assert gw._thread is None


def test_run_realtime_resolves_every_arrival(testbeds):
    """``LoadGenerator.run_realtime``: the serving thread serves while
    the caller paces a short trace on the host's clock; every arrival
    resolves and the thread is stopped."""
    data, _, pipe, *_ = testbeds["repro_torch"]
    be = PORT.SimulatorBackend(pipe, stream_slots=4, service_polls=2)
    gw = PORT.AsyncGateway(PORT.FixedPolicy(2), be, state_fn=ZERO_STATE,
                           deadline_ms=10_000.0)
    trace = PORT.build_trace(data.questions[:8],
                             PORT.PoissonProcess(400.0, seed=0), 12,
                             deadline_ms=10_000.0)
    rep = PORT.LoadGenerator(gw, trace).run_realtime(timeout_s=30.0)
    assert rep.offered == rep.completed == 12
    assert rep.offered_rate > 0 and gw._thread is None


# --- offered-load sweep -----------------------------------------------------


def test_sweep_offered_load_rows(testbeds):
    def run(ns):
        data, _, pipe, *_ = testbeds[ns.pkg]

        def make(clock):
            return _gateway(ns, pipe, clock,
                            admission=ns.AdmissionConfig(max_backlog=6))

        return ns.sweep_offered_load(make, data.questions[:8],
                                     [20.0, 800.0], n_requests=60,
                                     deadline_ms=200.0, seed=0)

    rows = run(PORT)
    assert [r["rate"] for r in rows] == [20.0, 800.0]
    for r in rows:
        assert r["offered"] == 60
        assert {"goodput", "shed", "latency_p50_ms",
                "latency_p99_ms"} <= set(r)
    assert rows[1]["shed"] > rows[0]["shed"]
    assert rows == run(REF)


# --- the real continuous engine ---------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    import jax.numpy as jnp

    from repro.configs import get_config as ref_config
    from repro.models import build_model as ref_build
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    rc = dataclasses.replace(ref_config("qwen1.5-32b", "smoke"),
                             dtype="float32")
    tc = dataclasses.replace(get_config("qwen1.5-32b", "smoke"),
                             dtype="float32")
    rm, tm = ref_build(rc), build_model(tc)
    np_params = jax.tree_util.tree_map(np.asarray,
                                       rm.init(jax.random.PRNGKey(0)))
    return {"repro": (rc, rm, jax.tree_util.tree_map(jnp.asarray,
                                                     np_params)),
            "repro_torch": (tc, tm, params_from_numpy(np_params,
                                                      device="cpu"))}


def _engine_gateway(ns, smoke, testbeds, clock, *, n_slots=4,
                    deadline_ms=5000.0, backlog=12, **engine_kw):
    cfg, model, params = smoke[ns.pkg]
    _, index, *_ = testbeds[ns.pkg]
    tok = ns.m("data.tokenizer").HashTokenizer(cfg.vocab_size)
    backend = ns.m("routing.engine_backend").ContinuousEngineBackend.create(
        model, params, tok, index, num_slots=n_slots, max_prompt_len=96,
        max_new_tokens=4, clock=clock.now, **engine_kw)
    return ns.AsyncGateway(ns.FixedPolicy(0), backend, state_fn=ZERO_STATE,
                           clock=clock.now, deadline_ms=deadline_ms,
                           admission=ns.AdmissionConfig(max_backlog=backlog))


def _engine_replay(ns, smoke, testbeds, *, rate=100.0, n=16, seed=2,
                   deadline_ms=5000.0, quantum=0.005, **kw):
    data = testbeds[ns.pkg][0]
    clock = ns.VirtualClock()
    gw = _engine_gateway(ns, smoke, testbeds, clock,
                         deadline_ms=deadline_ms, **kw)
    trace = ns.build_trace(data.questions[:6],
                           ns.PoissonProcess(rate, seed=seed), n,
                           deadline_ms=deadline_ms)
    gen = ns.LoadGenerator(gw, trace)
    rep = gen.run_virtual(clock, service_quantum_s=quantum)
    es = gw.engine_stats
    return rep, gw, (rep.as_dict(), _handles(gen.last_handles),
                     _stats(gw.stats),
                     (es.n_admitted, es.n_completed, es.n_prefills,
                      es.n_decode_chunks, es.n_decode_steps,
                      es.n_timed_out, es.max_concurrent))


def test_open_loop_continuous_engine_end_to_end(smoke, testbeds):
    """A seeded Poisson trace through AsyncGateway over the continuous
    engine in virtual time: every request accounted, the stream serves
    across pumps, deterministic, and the reference's report, outcomes
    and engine counters exactly."""
    rep, gw, got = _engine_replay(PORT, smoke, testbeds)
    assert rep.completed == rep.offered == 16
    assert gw.stats.served + gw.stats.shed == 16
    assert gw.engine_stats.n_completed > 0
    assert _engine_replay(PORT, smoke, testbeds)[2] == got
    assert got == _engine_replay(REF, smoke, testbeds)[2]


def test_open_loop_paged_mid_stream_deadline(smoke, testbeds):
    """The paged engine under deadlines tight enough that residents are
    cancelled mid-decode: their pages go back to the pool while later
    admissions reuse them; everything resolves, only prefix-cache
    references remain, and the run is the reference's."""
    kw = dict(rate=200.0, n=16, deadline_ms=35.0, quantum=0.005,
              n_slots=2, backlog=32, paged=True, page_size=4)
    rep, gw, got = _engine_replay(PORT, smoke, testbeds, **kw)
    eng = gw.backend.engine
    assert rep.completed == rep.offered == 16
    assert eng.stats.n_timed_out > 0 and gw.stats.timed_out > 0
    assert eng.stats.n_completed > 0 and eng.stats.n_pages_evicted > 0
    pool = eng._pages
    assert all(r in (0, 1) for r in pool._ref)
    assert pool.pages_in_use == sum(len(c) for c in pool._prefix)
    assert got == _engine_replay(REF, smoke, testbeds, **kw)[2]


class _ScalarReads(TorchDispatchMode):
    """Counts device-to-host scalar reads, including those PyTorch makes
    inside its own C++: each is an ``aten._local_scalar_dense``."""

    def __init__(self):
        super().__init__()
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.reads += func is torch.ops.aten._local_scalar_dense.default
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_stream_path_reads_only_the_control_sync(smoke, testbeds,
                                                 monkeypatch, paged):
    """A pump loop over the stream protocol makes no scalar read from the
    device, and every host copy of a tensor comes from the executor's own
    control sync, output fetch or fault flags: ``stream_submit`` and
    ``stream_poll`` add none."""
    clock = PORT.VirtualClock()
    gw = _engine_gateway(PORT, smoke, testbeds, clock,
                         **(dict(paged=True, page_size=4) if paged else {}))
    ex = gw.backend.engine.executor
    inside = [0]
    for name in ("sync_control", "fetch_outputs", "slot_faults"):
        def wrapped(*a, _f=getattr(ex, name), **kw):
            inside[0] += 1
            try:
                return _f(*a, **kw)
            finally:
                inside[0] -= 1
        setattr(ex, name, wrapped)
    stray = []
    for name in ("item", "tolist", "numpy", "cpu", "__bool__"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _name=name, **kw):
            if not inside[0]:
                stray.append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, spy)
    data = testbeds["repro_torch"][0]
    with _ScalarReads() as scalar:
        handles = [gw.submit_stream(PORT.Request(qid=i, question=q))
                   for i, q in enumerate(data.questions[:6])]
        for _ in range(200):
            if not gw.in_flight:
                break
            gw.pump()
            clock.advance(0.005)
    monkeypatch.undo()
    assert all(h.done() for h in handles)
    assert gw.engine_stats.n_completed == 6
    assert stray == [] and scalar.reads == 0


def test_concurrent_submitters_stress(testbeds):
    """More submitting threads than cores against the background serving
    thread, with a shortened switch interval: every handle resolves and
    the gateway accounts each request exactly once (a lost update under
    the gateway lock would break the counts)."""
    import os
    import sys
    import threading
    data, _, pipe, *_ = testbeds["repro_torch"]
    be = PORT.SimulatorBackend(pipe, stream_slots=4, service_polls=2)
    gw = PORT.AsyncGateway(PORT.FixedPolicy(2), be, state_fn=ZERO_STATE,
                           deadline_ms=60_000.0,
                           admission=PORT.AdmissionConfig(max_backlog=10_000))
    n_threads, per = 2 * (os.cpu_count() or 2) + 1, 12
    handles, lock = [], threading.Lock()

    def submitter(k):
        for i in range(per):
            q = data.questions[(k * per + i) % len(data.questions)]
            h = gw.submit_stream(PORT.Request(qid=k * per + i, question=q))
            with lock:
                handles.append(h)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        gw.start(idle_sleep_s=1e-4)
        threads = [threading.Thread(target=submitter, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
        for h in handles:
            h.result(timeout=60.0)
        gw.stop(timeout=30.0)
    finally:
        sys.setswitchinterval(old)
    n = n_threads * per
    assert len(handles) == n and all(h.done() for h in handles)
    assert gw.stats.served + gw.stats.shed == n
    assert gw.in_flight == 0 and gw._thread is None
