"""The port's fault-tolerant serving plane against the reference: twins
of every test in ``tests/test_faults.py``, each run through both
packages on the same inputs.

Injector, breaker, retriever-seam, scheduler (the numpy
``FakeExecutor`` of ``test_host_scheduler`` behind ``ChaosExecutor``)
and AsyncGateway tests are host code: the port's schedules, fire logs,
tokens, counters and virtual-time outcomes are the reference's exactly,
and each keeps the reference test's own assertions.  The real-executor
tests run qwen SMOKE float32 with the reference's params bridged; the
four scenarios of ``benchmarks/chaos_bench.py`` run at a small size
through the real continuous engine in virtual time, and every row
(counters, outcomes, latencies, stage table) is the reference's.
"""
import dataclasses
import importlib
import sys
import time
import types
from pathlib import Path

import jax
import numpy as np
import pytest

from test_host_scheduler import FakeExecutor, _prompts, arith_gen, expected

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

pytestmark = pytest.mark.chaos

ZERO_STATE = lambda qs: np.zeros((len(qs), 1))


def _ns(pkg: str):
    """The fault-plane symbols of one package."""
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")
    errors, hybrid, faults = (m("core.errors"), m("retrieval.hybrid"),
                              m("serving.faults"))
    routing, streaming, traffic = (m("routing"), m("serving.streaming"),
                                   m("serving.traffic"))
    return types.SimpleNamespace(
        pkg=pkg, TransientFaultError=errors.TransientFaultError,
        FaultTimeoutError=errors.FaultTimeoutError,
        CircuitBreaker=hybrid.CircuitBreaker,
        IndexRetriever=hybrid.IndexRetriever,
        collect_breakers=hybrid.collect_breakers,
        resolve_retrievers=hybrid.resolve_retrievers,
        retrieve_with_fallback=hybrid.retrieve_with_fallback,
        FixedPolicy=routing.FixedPolicy, Request=routing.Request,
        Gateway=routing.Gateway,
        ContinuousEngine=m("serving.continuous").ContinuousEngine,
        ChaosInjector=faults.ChaosInjector, FaultPlan=faults.FaultPlan,
        FaultSpec=faults.FaultSpec, RetryPolicy=faults.RetryPolicy,
        AdmissionConfig=streaming.AdmissionConfig,
        AsyncGateway=streaming.AsyncGateway,
        VirtualClock=traffic.VirtualClock,
        LoadGenerator=traffic.LoadGenerator,
        PoissonProcess=traffic.PoissonProcess,
        build_trace=traffic.build_trace,
        ActionOutcome=m("serving.pipeline").ActionOutcome,
        Question=m("data.synthetic_squad").Question)


REF, PORT = _ns("repro"), _ns("repro_torch")


def _plan(ns, *specs, seed=0):
    return ns.FaultPlan(specs=tuple(ns.FaultSpec(**s) for s in specs),
                        seed=seed)


def _port_plan(ref_plan):
    """The same FaultPlan, rebuilt from the port's types."""
    return PORT.FaultPlan(specs=tuple(
        PORT.FaultSpec(**dataclasses.asdict(s)) for s in ref_plan.specs),
        seed=ref_plan.seed)


# --- injector ---------------------------------------------------------------


def test_fault_spec_validation():
    for bad in (dict(site="s", kind="explode"),
                dict(site="s", kind="raise", count=0),
                dict(site="s", kind="raise", prob=0.0)):
        with pytest.raises(ValueError):
            PORT.FaultSpec(**bad)


def test_injector_window_and_replay():
    specs = (dict(site="a", kind="raise", start=2, count=3),
             dict(site="b", kind="raise", start=0, count=-1, prob=0.5))

    def run(ns):
        inj = ns.ChaosInjector(_plan(ns, *specs, seed=7))
        hits_a = [inj.fire("a") is not None for _ in range(8)]
        hits_b = [inj.fire("b") is not None for _ in range(20)]
        return hits_a, hits_b, [r[:3] for r in inj.fire_log]

    ha, hb, log = run(PORT)
    assert ha == [False, False, True, True, True, False, False, False]
    assert 0 < sum(hb) < 20
    assert run(PORT) == (ha, hb, log)       # same seed => same schedule
    assert run(REF) == (ha, hb, log)        # and the reference's draws


def test_injector_unarmed_is_noop():
    inj = PORT.ChaosInjector(PORT.FaultPlan())
    assert not inj.armed
    assert inj.fire("anything") is None
    assert inj.fire_log == [] and inj.calls("anything") == 0


def test_apply_error_kinds():
    ns = PORT
    inj = ns.ChaosInjector(_plan(ns, dict(site="s", kind="raise")),
                           sleep=lambda s: None)
    with pytest.raises(ns.TransientFaultError):
        inj.apply_error_kind(ns.FaultSpec(site="s", kind="raise"), "s")
    with pytest.raises(ns.FaultTimeoutError):
        inj.apply_error_kind(ns.FaultSpec(site="s", kind="timeout"), "s")
    slept = []
    inj.sleep = slept.append
    assert inj.apply_error_kind(
        ns.FaultSpec(site="s", kind="latency", latency_s=0.1), "s") is True
    assert slept == [0.1]
    assert inj.apply_error_kind(
        ns.FaultSpec(site="s", kind="stall"), "s") is False


# --- circuit breaker --------------------------------------------------------


def _breaker_walks(ns):
    """The reference tests' breaker sequences; returns every observed
    state so both packages can be compared step by step."""
    seen = []
    b = ns.CircuitBreaker(window=8, min_calls=4, failure_threshold=0.5,
                          cooldown=3, half_open_probes=1)
    for _ in range(4):
        seen.append(b.allow())
        b.record_failure()
    seen += [b.state, b.n_trips, b.allow(), b.allow(), b.allow(), b.state]
    b.record_success()
    seen += [b.state, b.failure_rate()]
    for _ in range(4):
        b.record_failure()
    seen += [b.state, b.allow(), b.allow(), b.allow()]
    b.record_failure()
    seen += [b.state, b.n_trips]
    return seen


def test_breaker_state_machine():
    seen = _breaker_walks(PORT)
    assert seen == [True] * 4 + ["open", 1, False, False, True, "half_open",
                                 "closed", 0.0, "open", False, False, True,
                                 "open", 3]
    assert seen == _breaker_walks(REF)


def test_breaker_window_evicts_old_failures():
    b = PORT.CircuitBreaker(window=4, min_calls=4, failure_threshold=0.75)
    for _ in range(3):
        b.record_failure()
    for _ in range(4):
        b.record_success()
    assert b.failure_rate() == 0.0 and b.state == "closed"


def test_breaker_wall_clock_cooldown():
    def walk(ns):
        t = [0.0]
        b = ns.CircuitBreaker(window=8, min_calls=4, failure_threshold=0.5,
                              cooldown=3, half_open_probes=1,
                              clock=lambda: t[0], cooldown_s=5.0)
        seen = []
        for _ in range(4):
            seen.append(b.allow())
            b.record_failure()
        seen.append(b.state)
        t[0] = 4.9
        seen += [b.allow() for _ in range(10)] + [b.state, b.n_denied]
        t[0] = 5.0
        seen += [b.allow(), b.state]
        b.record_success()
        seen.append(b.state)
        for _ in range(4):
            b.record_failure()
        t[0] = 11.0
        seen.append(b.allow())
        b.record_failure()
        seen.append(b.state)
        t[0] = 15.9
        seen.append(b.allow())
        t[0] = 16.0
        seen += [b.allow(), b.state]
        return seen

    seen = walk(PORT)
    assert seen == ([True] * 4 + ["open"] + [False] * 10 + ["open", 10]
                    + [True, "half_open", "closed", True, "open", False,
                       True, "half_open"])
    assert seen == walk(REF)


def test_breaker_clock_mode_validation():
    with pytest.raises(ValueError, match="come together"):
        PORT.CircuitBreaker(clock=lambda: 0.0)
    with pytest.raises(ValueError, match="come together"):
        PORT.CircuitBreaker(cooldown_s=1.0)
    with pytest.raises(ValueError, match="> 0"):
        PORT.CircuitBreaker(clock=lambda: 0.0, cooldown_s=0.0)


def test_breaker_call_count_mode_unchanged_by_default():
    b = PORT.CircuitBreaker(window=8, min_calls=4, failure_threshold=0.5,
                            cooldown=3)
    assert b.clock is None and b.cooldown_s is None
    for _ in range(4):
        b.record_failure()
    assert not b.allow() and not b.allow()
    assert b.allow() and b.state == "half_open"


def test_breaker_random_walk_invariants_deterministic():
    def walk(ns, seed):
        rng = np.random.default_rng(seed)
        b = ns.CircuitBreaker(window=8, min_calls=4, failure_threshold=0.5,
                              cooldown=3)
        trace = []
        for _ in range(300):
            allowed = b.allow()
            if allowed:
                (b.record_failure if rng.random() < 0.4
                 else b.record_success)()
            trace.append((allowed, b.state))
            assert b.state in ("closed", "open", "half_open")
            if not allowed:
                assert b.state in ("open", "half_open")
        return trace, b.n_trips, b.n_denied

    t1 = walk(PORT, 3)
    assert t1 == walk(PORT, 3) == walk(REF, 3)
    assert t1[1] > 0


# --- retriever seams: breaker + fallback + cache guard ----------------------


class FlakyIndex:
    """Index stub whose topk raises (the package's transient error)
    while ``broken``."""

    def __init__(self, texts, error):
        self.texts = texts
        self.error = error
        self.broken = False
        self.calls = 0

    def topk(self, query, k):
        self.calls += 1
        if self.broken:
            raise self.error(f"flaky down ({query!r})")
        ids = np.arange(min(k, len(self.texts)))
        return ids, np.ones(len(ids), np.float32)


def _suite(ns, cache_size=8, chaos=None, **breaker_kw):
    texts = [f"passage {i}" for i in range(6)]
    flaky = FlakyIndex(texts, ns.TransientFaultError)
    retrievers = {
        "bm25": ns.IndexRetriever("bm25",
                                  FlakyIndex(texts, ns.TransientFaultError)),
        "dense": ns.IndexRetriever("dense", flaky)}
    wrapped, cache = ns.resolve_retrievers(
        retrievers, None, cache_size=cache_size, chaos=chaos,
        breaker_kw=dict(window=4, min_calls=2, failure_threshold=0.5,
                        cooldown=2, **breaker_kw))
    return wrapped, cache, flaky


def test_fallback_degrades_and_trips_breaker():
    ns = PORT
    wrapped, cache, flaky = _suite(ns)
    flaky.broken = True
    for i in range(2):
        ps, degraded = ns.retrieve_with_fallback(wrapped, "dense",
                                                 f"q{i}", 2)
        assert degraded and len(ps) == 2
    brk = ns.collect_breakers(wrapped)["dense"]
    assert brk.state == "open" and brk.n_trips == 1
    calls_before = flaky.calls
    _, degraded = ns.retrieve_with_fallback(wrapped, "dense", "q-open", 2)
    assert degraded and flaky.calls == calls_before
    assert brk.n_denied >= 1


def test_failed_lookup_never_cached_fallback_under_own_key():
    ns = PORT
    wrapped, cache, flaky = _suite(ns)
    flaky.broken = True
    ns.retrieve_with_fallback(wrapped, "dense", "q0", 2)
    keys = list(cache._d)
    assert all(k[1] != "dense" for k in keys), keys
    assert any(k[1] == "bm25" for k in keys)
    flaky.broken = False
    for i in range(8):
        ns.retrieve_with_fallback(wrapped, "dense", f"r{i}", 2)
    assert ns.collect_breakers(wrapped)["dense"].state == "closed"
    ps, degraded = ns.retrieve_with_fallback(wrapped, "dense", "fresh", 2)
    assert not degraded
    assert any(k[1] == "dense" for k in cache._d)


def test_fallback_missing_or_self_raises_transient():
    ns = PORT
    wrapped, _, flaky = _suite(ns, cache_size=0)
    flaky.broken = True
    with pytest.raises(ns.TransientFaultError):
        ns.retrieve_with_fallback(wrapped, "dense", "q", 2, fallback="dense")
    with pytest.raises(ns.TransientFaultError):
        ns.retrieve_with_fallback(wrapped, "dense", "q", 2, fallback="nope")


def test_retrieval_cache_hits_bypass_open_breaker():
    ns = PORT
    wrapped, cache, flaky = _suite(ns)
    ps0 = wrapped["dense"].passages("warm", 2)
    flaky.broken = True
    for i in range(3):
        with pytest.raises(Exception):
            wrapped["dense"].passages(f"cold{i}", 2)
    assert ns.collect_breakers(wrapped)["dense"].state == "open"
    assert wrapped["dense"].passages("warm", 2) == ps0


def test_chaos_retriever_seam_innermost():
    """The ``chaos=`` seam of ``resolve_retrievers``: injected faults sit
    under the breaker (they trip it) and are never cached; the schedule,
    the degraded flags and the breaker walk are the reference's."""
    def run(ns):
        inj = ns.ChaosInjector(_plan(ns, dict(site="retriever.dense",
                                              kind="raise", start=1,
                                              count=3)))
        wrapped, cache, _ = _suite(ns, chaos=inj)
        degr = [ns.retrieve_with_fallback(wrapped, "dense", f"q{i}", 2)[1]
                for i in range(8)]
        brk = ns.collect_breakers(wrapped)["dense"]
        return (degr, [r[:3] for r in inj.fire_log], brk.n_trips,
                brk.n_denied, sorted(k[1] for k in cache._d))

    got = run(PORT)
    assert any(got[0]) and got[2] >= 1
    assert got == run(REF)
    unarmed, _, _ = _suite(PORT, chaos=PORT.ChaosInjector(PORT.FaultPlan()))
    assert not any(type(r).__name__ == "ChaosRetriever"
                   for r in unarmed.values())


# --- scheduler: chaos seams, quarantine, watchdog, deadlines ---------------


class FaultableFake(FakeExecutor):
    def deactivate(self, slots):
        for s in slots:
            self._active[s] = False


def chaos_engine(ns, plan, gen_fn=arith_gen, *, clock=None, **kw):
    inj = ns.ChaosInjector(plan, clock=clock)
    eng_kw = {k: kw.pop(k) for k in ("watchdog_syncs", "max_requeues")
              if k in kw}
    fake = FaultableFake(gen_fn, **kw)
    return ns.ContinuousEngine(executor=fake, chaos=inj, clock=clock,
                               **eng_kw), fake, inj


def _stats(eng):
    return dataclasses.astuple(dataclasses.replace(
        eng.stats, concurrency_trace=tuple(eng.stats.concurrency_trace)))


def _gens(done, rids):
    return [(list(done[r].tokens), done[r].failed, done[r].transient,
             done[r].timed_out) for r in rids]


def test_nan_quarantine_peers_token_identical():
    prompts = _prompts([3, 4, 5, 6])

    def run(ns, plan):
        eng, fake, inj = chaos_engine(ns, plan, num_slots=4, sync_every=2)
        rids = [eng.reserve_rid() for _ in prompts]
        for rid, p in zip(rids, prompts):
            eng.submit(rid, p, 8)
        done = eng.run()
        return eng, [done[r] for r in rids], _gens(done, rids)

    spec = dict(site="executor.decode", kind="nan", start=1, count=1,
                slots=(2,))
    eng, outs, got = run(PORT, _plan(PORT, spec))
    _, clean, _ = run(PORT, PORT.FaultPlan())
    assert outs[2].failed and outs[2].transient
    assert eng.stats.n_nan_trips == 1 and eng.stats.n_quarantined == 1
    assert eng.quarantined_slots == {2}
    for i in (0, 1, 3):
        assert list(outs[i].tokens) == list(clean[i].tokens)
    ref_eng, _, want = run(REF, _plan(REF, spec))
    assert got == want and _stats(eng) == _stats(ref_eng)


def test_quarantined_slot_never_readmitted_until_reset():
    def run(ns):
        plan = _plan(ns, dict(site="executor.decode", kind="nan", start=0,
                              count=1, slots=(0,)))
        eng, fake, inj = chaos_engine(ns, plan, num_slots=2, sync_every=2)
        outs = eng.generate_many(_prompts([3, 4, 5, 6]), max_new_tokens=8)
        seen = [eng.quarantined_slots == {0},
                all(not o.failed for o in outs[1:])]
        eng.generate_many(_prompts([4, 4], seed=3), max_new_tokens=4)
        seen += [eng.quarantined_slots == {0},
                 all(c <= 1 for c in list(eng.stats.concurrency_trace)[2:])]
        seen += [eng.reset_quarantine() == [0],
                 eng.quarantined_slots == set()]
        eng.generate_many(_prompts([4, 4], seed=4), max_new_tokens=4)
        seen.append(list(eng.stats.concurrency_trace)[-1] == 2)
        return seen, _stats(eng)

    seen, stats = run(PORT)
    assert all(seen), seen
    assert (seen, stats) == run(REF)


def test_watchdog_quarantines_stalled_slot():
    def run(ns):
        plan = _plan(ns, dict(site="executor.decode", kind="stall",
                              start=0, count=-1))
        eng, fake, inj = chaos_engine(ns, plan, num_slots=1, sync_every=2,
                                      watchdog_syncs=3)
        rid = eng.reserve_rid()
        eng.submit(rid, _prompts([4])[0], 8)
        done = eng.run()
        return eng, done[rid], _gens(done, [rid])

    eng, gen, got = run(PORT)
    assert gen.failed.startswith("watchdog") and gen.transient
    assert eng.stats.n_watchdog_trips == 1
    assert got == run(REF)[2]


def test_all_slots_quarantined_fails_queue_not_hangs():
    def run(ns):
        plan = _plan(ns, dict(site="executor.decode", kind="stall",
                              start=0, count=-1))
        eng, fake, inj = chaos_engine(ns, plan, num_slots=1, sync_every=2,
                                      watchdog_syncs=2)
        r0, r1 = eng.reserve_rid(), eng.reserve_rid()
        eng.submit(r0, _prompts([4])[0], 8)
        eng.submit(r1, _prompts([5])[0], 8)
        return eng.run(), [r0, r1]

    done, (r0, r1) = run(PORT)
    assert done[r0].failed.startswith("watchdog")
    assert done[r1].failed == "all slots quarantined"
    assert done[r1].transient
    ref_done, rids = run(REF)
    assert _gens(done, [r0, r1]) == _gens(ref_done, rids)


def test_decode_fault_requeues_then_succeeds():
    def run(ns):
        plan = _plan(ns, dict(site="executor.decode", kind="raise",
                              start=0, count=1))
        eng, fake, inj = chaos_engine(ns, plan, num_slots=2, sync_every=2,
                                      max_requeues=1)
        return eng, eng.generate_many(_prompts([4, 5]), max_new_tokens=8)

    eng, outs = run(PORT)
    assert eng.stats.n_exec_faults == 1 and eng.stats.n_requeued == 2
    for p, o in zip(_prompts([4, 5]), outs):
        assert not o.failed
        assert list(o.tokens) == expected(arith_gen(p), 8)
    ref_eng, _ = run(REF)
    assert _stats(eng) == _stats(ref_eng)


def test_decode_fault_without_requeue_fails_transient():
    plan = _plan(PORT, dict(site="executor.decode", kind="raise", start=0,
                            count=1))
    eng, fake, inj = chaos_engine(PORT, plan, num_slots=2, sync_every=2)
    outs = eng.generate_many(_prompts([4]), max_new_tokens=8)
    assert outs[0].failed and outs[0].transient
    assert "injected raise at executor.decode" in outs[0].failed


def test_admit_fault_requeues_and_stream_survives():
    def run(ns):
        plan = _plan(ns, dict(site="executor.admit", kind="raise", start=0,
                              count=1))
        eng, fake, inj = chaos_engine(ns, plan, num_slots=2, sync_every=2,
                                      max_requeues=1)
        return eng, eng.generate_many(_prompts([4, 5, 6]), max_new_tokens=6)

    eng, outs = run(PORT)
    assert eng.stats.n_exec_faults == 1
    for p, o in zip(_prompts([4, 5, 6]), outs):
        assert not o.failed, o
        assert list(o.tokens) == expected(arith_gen(p), 6)
    assert _stats(eng) == _stats(run(REF)[0])


def test_random_chaos_every_request_resolves():
    """Liveness under seeded random plans; every trial's results are the
    reference's."""
    rng = np.random.default_rng(0)
    sites = ["executor.decode", "executor.admit"]
    kinds = ["raise", "stall", "nan"]
    for trial in range(6):
        specs = []
        for _ in range(int(rng.integers(1, 3))):
            site = sites[int(rng.integers(len(sites)))]
            k = kinds[int(rng.integers(len(kinds)))]
            specs.append(dict(
                site=site if k == "raise" else "executor.decode", kind=k,
                start=int(rng.integers(0, 4)), count=int(rng.integers(1, 3)),
                slots=(0,) if k == "nan" else None))

        def run(ns):
            eng, fake, inj = chaos_engine(
                ns, _plan(ns, *specs, seed=trial), num_slots=2,
                sync_every=2, watchdog_syncs=2, max_requeues=1)
            prompts = _prompts([3, 4, 5, 6, 4], seed=trial)
            rids = [eng.reserve_rid() for _ in prompts]
            for rid, p in zip(rids, prompts):
                eng.submit(rid, p, 6)
            done = eng.run()
            assert set(done) == set(rids), (trial, specs)
            return _gens(done, rids), _stats(eng)

        assert run(PORT) == run(REF), (trial, specs)


def test_deadline_cancels_resident_mid_stream():
    def run(ns):
        t = [0.0]
        eng, fake, _ = chaos_engine(ns, ns.FaultPlan(), clock=lambda: t[0],
                                    num_slots=2, sync_every=2)
        r0, r1 = eng.reserve_rid(), eng.reserve_rid()
        p0, p1 = _prompts([4, 5])
        eng.submit(r0, p0, 16, deadline_at=0.5)
        eng.submit(r1, p1, 4)
        done = {}
        for _ in range(64):
            if not eng.has_work:
                break
            done.update(eng.poll())
            t[0] += 0.2
        done.update(eng.poll())
        out = eng.generate_many([_prompts([3])[0]], max_new_tokens=2)
        return eng, done, [r0, r1], p1, out

    eng, done, (r0, r1), p1, out = run(PORT)
    assert done[r0].timed_out and done[r0].failed == "deadline exceeded"
    assert not done[r0].transient
    assert not done[r1].failed
    assert list(done[r1].tokens) == expected(arith_gen(p1), 4)
    assert eng.stats.n_timed_out == 1
    assert not out[0].failed
    ref_eng, ref_done, rids, _, _ = run(REF)
    assert _gens(done, [r0, r1]) == _gens(ref_done, rids)
    assert [(d.admitted_at, d.finished_at) for d in done.values()] == \
        [(d.admitted_at, d.finished_at) for d in ref_done.values()]


def test_deadline_expires_queued_request():
    def run(ns):
        t = [0.0]
        eng, fake, _ = chaos_engine(ns, ns.FaultPlan(), clock=lambda: t[0],
                                    num_slots=1, sync_every=2)
        r0, r1 = eng.reserve_rid(), eng.reserve_rid()
        p0, p1 = _prompts([4, 5])
        eng.submit(r0, p0, 8)
        eng.submit(r1, p1, 8, deadline_at=0.1)
        t[0] = 0.2
        return eng, eng.run(), [r0, r1]

    eng, done, (r0, r1) = run(PORT)
    assert not done[r0].failed
    assert done[r1].timed_out
    assert eng.stats.n_timed_out == 1
    _, ref_done, rids = run(REF)
    assert _gens(done, [r0, r1]) == _gens(ref_done, rids)


# --- AsyncGateway: retries, deadline-awareness, fatal-error hardening -------


class ScriptedStreamBackend:
    """Minimal streaming backend over one package's types:
    "ok" / "transient" / "boom" / "pend"."""

    stream_backlog = 0

    def __init__(self, ns, script):
        self.ns = ns
        self.script = list(script)
        self.calls = 0
        self.poll_raise = False

    def execute_batch(self, questions, action):
        raise NotImplementedError

    def stream_submit(self, question, action, *, deadline_at=0.0):
        self.calls += 1
        step = self.script.pop(0) if self.script else "ok"
        if step == "transient":
            raise self.ns.TransientFaultError("scripted transient")
        if step == "boom":
            raise RuntimeError("scripted fatal")
        if step == "pend":
            return self.calls, None
        return None, self.ns.ActionOutcome(
            qid=question.qid, action=action.idx, correct=True,
            refused=False, hallucinated=False, cost_tokens=1.0,
            hit=True, answerable=True, answer="ok")

    def stream_poll(self):
        if self.poll_raise:
            raise RuntimeError("poll blew up")
        return []


def _mk_request(ns, qid=0, deadline_ms=0.0):
    q = ns.Question(qid=qid, text=f"q{qid}", answerable=True,
                    gold_answer="a", gold_pid=0)
    return ns.Request(qid=qid, question=q, slo="quality_first",
                      deadline_ms=deadline_ms)


def _mk_gateway(ns, backend, clock, **kw):
    kw.setdefault("retry", ns.RetryPolicy(max_retries=1, backoff_s=0.05))
    return ns.AsyncGateway(ns.FixedPolicy(1), backend, state_fn=ZERO_STATE,
                           clock=clock.now, **kw)


def _handle(h):
    o = h.outcome
    return (h.done(), h.retries, h.shed, o and o.answer, o and o.transient,
            o and o.refused, h.latency_ms)


def test_stream_retry_transient_then_success():
    def run(ns):
        clock = ns.VirtualClock()
        gw = _mk_gateway(ns, ScriptedStreamBackend(ns, ["transient", "ok"]),
                         clock)
        h = gw.submit_stream(_mk_request(ns))
        gw.pump()
        first = (h.done(), gw.in_flight)
        clock.advance(0.06)
        gw.pump()
        return first, _handle(h), gw.stats.retries, gw.stats.faulted

    got = run(PORT)
    assert got[0] == (False, 1)
    assert got[1][0] and got[1][3] == "ok" and got[1][1] == 1
    assert got[2:] == (1, 0)
    assert got == run(REF)


def test_stream_retry_exhausted_counts_faulted():
    def run(ns):
        clock = ns.VirtualClock()
        gw = _mk_gateway(ns, ScriptedStreamBackend(
            ns, ["transient", "transient"]), clock)
        h = gw.submit_stream(_mk_request(ns))
        gw.pump()
        clock.advance(0.06)
        gw.pump()
        return _handle(h), gw.stats.retries, gw.stats.faulted

    got = run(PORT)
    assert got[0][0] and got[0][4] and got[0][5]
    assert got[1:] == (1, 1)
    assert got == run(REF)


def test_stream_retry_never_past_deadline():
    def run(ns):
        clock = ns.VirtualClock()
        be = ScriptedStreamBackend(ns, ["transient", "ok"])
        gw = _mk_gateway(ns, be, clock,
                         retry=ns.RetryPolicy(max_retries=3, backoff_s=0.2))
        h = gw.submit_stream(_mk_request(ns, deadline_ms=100.0))
        gw.pump()
        return _handle(h), gw.stats.retries, gw.stats.faulted, be.calls

    got = run(PORT)
    assert got[0][0] and got[0][4]
    assert got[1:] == (0, 1, 1)
    assert got == run(REF)


def test_async_gateway_submit_exception_fails_everything():
    ns = PORT
    clock = ns.VirtualClock()
    gw = _mk_gateway(ns, ScriptedStreamBackend(ns, ["boom"]), clock)
    h0 = gw.submit_stream(_mk_request(ns, 0))
    h1 = gw.submit_stream(_mk_request(ns, 1))
    with pytest.raises(RuntimeError, match="scripted fatal"):
        gw.pump()
    assert isinstance(gw.failed, RuntimeError)
    assert h0.done() and h1.done()
    for h in (h0, h1):
        with pytest.raises(RuntimeError, match="scripted fatal"):
            h.result(timeout=0)
    assert gw.in_flight == 0
    gw.drain_stream()
    h2 = gw.submit_stream(_mk_request(ns, 2))
    assert h2.done() and h2.error is gw.failed


def test_async_gateway_thread_death_stops_cleanly():
    ns = PORT
    be = ScriptedStreamBackend(ns, ["pend"])
    be.poll_raise = True
    gw = ns.AsyncGateway(ns.FixedPolicy(1), be, state_fn=ZERO_STATE)
    gw.start(idle_sleep_s=1e-4)
    h = gw.submit_stream(_mk_request(ns))
    deadline = time.monotonic() + 5.0
    while not h.done() and time.monotonic() < deadline:
        time.sleep(1e-3)
    gw.stop(timeout=5.0)
    assert h.done()
    with pytest.raises(RuntimeError, match="poll blew up"):
        h.result(timeout=0)
    assert gw.failed is not None
    assert gw.stats.fatal_errors == 1


def test_no_fault_parity_features_on_vs_off_simulator():
    """Retries on vs off over the simulator with no faults: identical
    outcomes and stats, and identical to the reference's."""
    def run(ns, retry):
        offline = importlib.import_module(f"{ns.pkg}.core.offline_log")
        config = importlib.import_module(f"{ns.pkg}.core.config")
        backends = importlib.import_module(f"{ns.pkg}.routing.backends")
        cfg = config.TestbedConfig(n_train=20, n_eval=8, n_paragraphs=40,
                                   router=config.RouterConfig(n_epochs=1))
        data, index, pipe, *_ = offline.build_testbed(cfg)
        clock = ns.VirtualClock()
        be = backends.SimulatorBackend(pipe, stream_slots=4,
                                       service_polls=2, clock=clock.now)
        gw = ns.AsyncGateway(ns.FixedPolicy(2), be, state_fn=ZERO_STATE,
                             clock=clock.now, deadline_ms=300.0,
                             retry=retry(ns))
        trace = ns.build_trace(data.questions[:8],
                               ns.PoissonProcess(80.0, seed=0), 32,
                               deadline_ms=300.0)
        gen = ns.LoadGenerator(gw, trace)
        rep = gen.run_virtual(clock)
        outcomes = [(h.outcome.answer, h.outcome.correct,
                     h.outcome.refused, h.shed, h.latency_ms)
                    for h in gen.last_handles]
        return rep.as_dict(), outcomes, gw.stats.served, gw.stats.shed

    on = run(PORT, lambda ns: ns.RetryPolicy(max_retries=2))
    off = run(PORT, lambda ns: None)
    assert on == off
    assert on[0]["degraded"] == 0 and on[0]["retries"] == 0
    assert on[0]["faulted"] == 0 and on[2] > 0
    assert on == run(REF, lambda ns: ns.RetryPolicy(max_retries=2))


# --- real executor: device-side NaN detection -------------------------------


@pytest.fixture(scope="module")
def smoke_model():
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
    return dict(ref=(rc, rm, jax.tree_util.tree_map(jnp.asarray, np_params)),
                port=(tc, tm, params_from_numpy(np_params, device="cpu")))


def _nan_params(params):
    from repro_torch.models.schema import tree_map
    return tree_map(lambda t: t * float("nan"), params)


def test_real_executor_nan_detection_quarantines(smoke_model):
    _, model, params = smoke_model["port"]
    eng = PORT.ContinuousEngine(model, _nan_params(params), num_slots=2,
                                max_len=32, max_new_cap=8, sync_every=2)
    rids = [eng.reserve_rid() for _ in range(2)]
    for rid in rids:
        eng.submit(rid, [5, 6, 7], 8)
    done = eng.run()
    assert set(done) == set(rids)
    assert all(done[r].failed and done[r].transient for r in rids)
    assert eng.stats.n_nan_trips == 2
    assert eng.quarantined_slots == {0, 1}


def test_real_executor_health_checks_off_no_quarantine(smoke_model):
    from repro_torch.serving.executor import SingleDeviceExecutor
    _, model, params = smoke_model["port"]
    ex = SingleDeviceExecutor(model, _nan_params(params), num_slots=2,
                              max_len=32, max_new_cap=8, sync_every=2,
                              health_checks=False)
    eng = PORT.ContinuousEngine(executor=ex)
    outs = eng.generate_many([[5, 6, 7]], max_new_tokens=4)
    assert not outs[0].failed
    assert eng.stats.n_nan_trips == 0 and eng.quarantined_slots == set()
    assert not ex.slot_faults().any()


def test_real_executor_healthy_run_parity_with_health_checks(smoke_model):
    from repro.serving.executor import SingleDeviceExecutor as RefExecutor
    from repro_torch.serving.executor import SingleDeviceExecutor
    prompts = [[5, 6, 7], [9, 4, 11, 2]]

    def run(ns, cls, model, params, flag):
        ex = cls(model, params, num_slots=2, max_len=32, max_new_cap=8,
                 sync_every=2, health_checks=flag)
        eng = ns.ContinuousEngine(executor=ex)
        return [list(o.tokens)
                for o in eng.generate_many(prompts, max_new_tokens=6)]

    _, tm, tp = smoke_model["port"]
    _, rm, rp = smoke_model["ref"]
    on = run(PORT, SingleDeviceExecutor, tm, tp, True)
    assert on == run(PORT, SingleDeviceExecutor, tm, tp, False)
    assert on == run(REF, RefExecutor, rm, rp, True)


def test_chaos_executor_on_the_paged_engine(smoke_model):
    """The executor seam over the real paged executor: ``admit_paged``
    shares the admission site's counter, the engine reads the page
    geometry through the wrapper, and an admit fault (requeued) plus a
    NaN burst give the reference's tokens, failures and counters."""
    specs = (dict(site="executor.admit", kind="raise", start=1, count=1),
             dict(site="executor.decode", kind="nan", start=2, count=1,
                  slots=(1,)))
    # the first two share a page of prefix
    prompts = [[5, 6, 7, 8, 9, 10, 11, 12, 13],
               [5, 6, 7, 8, 9, 10, 11, 12, 14], [9, 4, 11, 2], [7, 7, 3]]

    def run(ns, smoke):
        _, model, params = smoke
        eng = ns.ContinuousEngine(
            model, params, num_slots=2, max_len=32, max_new_cap=8,
            sync_every=2, max_requeues=1, paged=True, page_size=8,
            chaos=ns.ChaosInjector(_plan(ns, *specs)))
        assert type(eng.executor).__name__ == "ChaosExecutor"
        assert eng.executor.page_size == 8 and eng.executor.paged
        outs = eng.generate_many(prompts, max_new_tokens=6)
        return ([(list(o.tokens), o.failed, o.transient) for o in outs],
                _stats(eng), sorted(eng.quarantined_slots))

    got = run(PORT, smoke_model["port"])
    assert got[1][eng_field("n_exec_faults")] == 1
    assert got[2] == [1] and any(f for _, f, _ in got[0])
    assert got == run(REF, smoke_model["ref"])


def eng_field(name):
    """Position of an EngineStats field in ``_stats``' tuple."""
    from repro_torch.serving.continuous import EngineStats
    return [f.name for f in dataclasses.fields(EngineStats)].index(name)


def test_executor_dispatch_histograms(smoke_model):
    """``metrics=`` reaches the executor the engine builds: the two
    dispatch histograms of the reference, under its names, count one
    observation per admission and per decode chunk."""
    from repro_torch.obs import MetricsRegistry
    _, model, params = smoke_model["port"]
    for paged in (False, True):
        reg = MetricsRegistry(time.perf_counter)
        eng = PORT.ContinuousEngine(model, params, num_slots=2, max_len=32,
                                    max_new_cap=8, sync_every=2,
                                    paged=paged, page_size=8, metrics=reg)
        eng.generate_many([[5, 6, 7], [9, 4, 11, 2]], max_new_tokens=6)
        text = reg.exposition()
        for name in ("executor_admit_dispatch_ms",
                     "executor_decode_dispatch_ms"):
            assert f"_{name} histogram\n" in text, name
        assert (f"_executor_admit_dispatch_ms_count "
                f"{eng.stats.n_prefills}\n") in text
        assert (f"_executor_decode_dispatch_ms_count "
                f"{eng.stats.n_decode_chunks}\n") in text


def _stream_run(ns, smoke, data, index, hardened):
    """The reference test's open loop over the real continuous engine,
    in one package: hardened (health checks, breakers, retries) or
    features-off (health_checks=False executor, retry=None)."""
    cfg, model, params = smoke
    tok_mod = importlib.import_module(f"{ns.pkg}.data.tokenizer")
    eb = importlib.import_module(f"{ns.pkg}.routing.engine_backend")
    ex_mod = importlib.import_module(f"{ns.pkg}.serving.executor")
    clock = ns.VirtualClock()
    executor = None
    if not hardened:
        executor = ex_mod.SingleDeviceExecutor(
            model, params, num_slots=2, max_len=48 + 4, max_new_cap=4,
            sync_every=2, prefill_batch=2, health_checks=False)
    backend = eb.ContinuousEngineBackend.create(
        model, params, tok_mod.HashTokenizer(cfg.vocab_size), index,
        executor=executor, num_slots=2, max_prompt_len=48,
        max_new_tokens=4, sync_every=2, clock=clock.now)
    gw = ns.AsyncGateway(
        ns.FixedPolicy(2), backend, state_fn=ZERO_STATE, clock=clock.now,
        deadline_ms=500.0,
        retry=(ns.RetryPolicy(max_retries=2, backoff_s=0.02)
               if hardened else None))
    trace = ns.build_trace(data.questions, ns.PoissonProcess(60.0, seed=0),
                           12, deadline_ms=500.0)
    gen = ns.LoadGenerator(gw, trace)
    rep = gen.run_virtual(clock, service_quantum_s=0.01)
    outs = [(h.outcome.answer, h.outcome.correct, h.outcome.refused,
             getattr(h.outcome, "degraded", False), h.shed, h.latency_ms)
            for h in gen.last_handles]
    return rep.as_dict(), outs


def _corpus(ns, n_paragraphs, n_questions):
    squad = importlib.import_module(f"{ns.pkg}.data.synthetic_squad")
    config = importlib.import_module(f"{ns.pkg}.core.config")
    bm25 = importlib.import_module(f"{ns.pkg}.retrieval.bm25")
    data = squad.SyntheticSquad(n_paragraphs=n_paragraphs,
                                n_questions=n_questions, seed=0)
    index = bm25.BM25Index.build([p.text for p in data.paragraphs],
                                 config.RetrievalConfig(vocab_hash_dim=1024))
    return data, index


def test_no_fault_parity_continuous_backend(smoke_model):
    """With no plan armed, the hardened open loop over the real engine
    is outcome- and report-identical to the features-off run, and both
    are the reference's."""
    data, index = _corpus(PORT, 40, 8)
    rep_on, outs_on = _stream_run(PORT, smoke_model["port"], data, index,
                                  True)
    rep_off, outs_off = _stream_run(PORT, smoke_model["port"], data, index,
                                    False)
    assert outs_on == outs_off
    assert rep_on == rep_off
    assert rep_on["degraded"] == rep_on["retries"] == rep_on["faulted"] == 0
    ref_data, ref_index = _corpus(REF, 40, 8)
    assert (rep_on, outs_on) == _stream_run(REF, smoke_model["ref"],
                                            ref_data, ref_index, True)


# --- the chaos bench's four scenarios, both packages ------------------------


CHAOS_REQUESTS = 16


def _chaos_row(ns, smoke, data, index, plan, space):
    """``benchmarks/chaos_bench.py::run_scenario`` at 16 requests (its
    plans' windows scale with the trace), in one package: 4 slots, prompts of 48, 8 new tokens, Poisson
    120/s, deadline 800 ms, virtual time, tracer and metrics attached."""
    cfg, model, params = smoke
    tok_mod = importlib.import_module(f"{ns.pkg}.data.tokenizer")
    eb = importlib.import_module(f"{ns.pkg}.routing.engine_backend")
    obs = importlib.import_module(f"{ns.pkg}.obs")
    clock = ns.VirtualClock()
    injector = ns.ChaosInjector(plan, clock=clock.now, sleep=clock.advance)
    retrievers = {"bm25": ns.IndexRetriever("bm25", index),
                  "dense": ns.IndexRetriever("dense", index)}
    backend = eb.ContinuousEngineBackend.create(
        model, params, tok_mod.HashTokenizer(cfg.vocab_size), index,
        num_slots=4, max_prompt_len=48, max_new_tokens=8, sync_every=4,
        clock=clock.now, retrievers=retrievers, chaos=injector,
        breaker_kw=dict(window=8, min_calls=4, failure_threshold=0.5,
                        cooldown=4))
    gw = ns.AsyncGateway(
        ns.FixedPolicy(2), backend, action_space=space,
        state_fn=ZERO_STATE, clock=clock.now, deadline_ms=800.0,
        admission=ns.AdmissionConfig(max_backlog=16),
        retry=ns.RetryPolicy(max_retries=2, backoff_s=0.02),
        tracer=obs.Tracer(clock.now), metrics=obs.MetricsRegistry(clock.now))
    trace = ns.build_trace(data.questions, ns.PoissonProcess(120.0, seed=0),
                           CHAOS_REQUESTS, deadline_ms=800.0)
    gen = ns.LoadGenerator(gw, trace)
    rep = gen.run_virtual(clock, service_quantum_s=0.01)
    eng = backend.engine.stats
    return {
        **rep.as_dict(), "fire_log": injector.fire_log,
        "engine": (eng.n_quarantined, eng.n_nan_trips, eng.n_watchdog_trips,
                   eng.n_exec_faults, eng.n_timed_out, eng.n_completed),
        "breakers": {n: (b.state, b.n_trips, b.n_denied)
                     for n, b in backend.breakers.items()},
        "handles": [(h.request.qid, h.outcome.answer, h.outcome.refused,
                     getattr(h.outcome, "degraded", False),
                     getattr(h.outcome, "transient", False), h.shed,
                     h.retries, h.latency_ms, h.first_token_ms)
                    for h in gen.last_handles],
    }


@pytest.fixture(scope="module")
def chaos_setup():
    from benchmarks.chaos_bench import CHAOS_SPACE, scenario_plans
    from repro_torch.routing.registry import Action, ActionSpace
    space = ActionSpace(CHAOS_SPACE.name, tuple(
        Action(a.idx, a.k, a.mode, a.retriever) for a in CHAOS_SPACE))
    return dict(plans=scenario_plans(CHAOS_REQUESTS), ref_space=CHAOS_SPACE,
                space=space, ref=_corpus(REF, 120, 24),
                port=_corpus(PORT, 120, 24))


@pytest.mark.parametrize("scenario", ["no_faults", "retriever_brownout",
                                      "executor_fault_burst", "nan_storm"])
def test_chaos_bench_scenario_parity(smoke_model, chaos_setup, scenario):
    ref_plan = chaos_setup["plans"][scenario]
    got = _chaos_row(PORT, smoke_model["port"], *chaos_setup["port"],
                     _port_plan(ref_plan), chaos_setup["space"])
    want = _chaos_row(REF, smoke_model["ref"], *chaos_setup["ref"],
                      ref_plan, chaos_setup["ref_space"])
    assert got == want
    assert got["completed"] == got["offered"] == CHAOS_REQUESTS
    if scenario == "no_faults":
        assert got["degraded"] == got["retries"] == got["faulted"] == 0
        assert got["fire_log"] == []
    if scenario == "retriever_brownout":
        assert got["degraded"] > 0 and got["breakers"]["dense"][1] >= 1
    if scenario == "executor_fault_burst":
        assert got["engine"][3] == len(got["fire_log"]) == 3
    if scenario == "nan_storm":
        assert got["engine"][0] == got["engine"][1] > 0


# --- Gateway (closed loop): deadline-aware retries of transients ------------


class ScriptedBatchBackend:
    """Closed-loop backend over one package's types: every request's
    first ``fails`` executions come back transient, then healthy.  With
    ``mixed`` it offers ``execute_mixed`` (the shared-stream path), else
    only ``execute_batch`` (the bucketed path)."""

    def __init__(self, ns, fails, mixed):
        self.ns = ns
        self.fails = fails
        self.seen = {}
        self.calls = []
        if mixed:
            self.execute_mixed = self._mixed

    def _one(self, q, action):
        n = self.seen.get(q.qid, 0)
        self.seen[q.qid] = n + 1
        bad = n < self.fails
        return self.ns.ActionOutcome(
            qid=q.qid, action=action.idx, correct=not bad, refused=bad,
            hallucinated=False, cost_tokens=1.0, hit=True, answerable=True,
            answer="transient" if bad else "ok", transient=bad)

    def execute_batch(self, questions, action):
        self.calls.append(("batch", [q.qid for q in questions]))
        return [self._one(q, action) for q in questions]

    def _mixed(self, questions, actions):
        self.calls.append(("mixed", [q.qid for q in questions]))
        return [self._one(q, a) for q, a in zip(questions, actions)]


@pytest.mark.parametrize("mixed", [False, True], ids=["batch", "mixed"])
@pytest.mark.parametrize("fails", [1, 3])
def test_gateway_retries_transients_closed_loop(mixed, fails):
    """``Gateway(retry=, sleep=)``: the transient subset is re-executed
    with exponential backoff up to ``max_retries``, then accounted as
    faulted; ``retry=None`` keeps the single pass.  Calls, sleeps,
    outcomes and stats are the reference's."""
    def run(ns, retry):
        be = ScriptedBatchBackend(ns, fails, mixed)
        slept, outs = [], []
        gw = ns.Gateway(
            ns.FixedPolicy(1), be, state_fn=ZERO_STATE, max_batch=8,
            adaptive_refusal=False, retry=retry, sleep=slept.append,
            on_outcome=lambda r, a, o, rew: outs.append(
                (r.qid, o.answer, o.transient, rew)))
        st = gw.serve([_mk_request(ns, i) for i in range(5)])
        return be.calls, slept, outs, st.retries, st.faulted, st.served

    for make in (lambda ns: ns.RetryPolicy(max_retries=2, backoff_s=0.01),
                 lambda ns: None):
        got = run(PORT, make(PORT))
        assert got == run(REF, make(REF))
        calls, slept, outs, retries, faulted, served = got
        assert served == 5
        if make(PORT) is None:
            assert (len(calls), slept, retries, faulted) == (1, [], 0, 5)
        else:
            assert slept == pytest.approx([0.01, 0.02][:min(fails, 2)])
            assert retries == 5 * min(fails, 2)
            assert faulted == (5 if fails > 2 else 0)
