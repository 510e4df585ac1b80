"""Open-loop load generation: seeded arrival processes, a virtual
clock, and the discrete-event replay of traces through
:class:`AsyncGateway`.

Closed-loop benchmarking (submit a batch, wait, submit the next) hides
queueing: the client politely waits for the server, so latency never
compounds.  Open-loop load — the industry-standard serving methodology —
draws arrival times from a stochastic process *independent of service
progress* and holds the server to per-request deadlines, so an
over-offered system visibly melts (queues grow without bound) unless
admission control sheds.  This module provides:

* :class:`PoissonProcess` / :class:`OnOffProcess` — seeded arrival
  processes (exponential inter-arrivals; bursty on-off modulation);
* :class:`VirtualClock` — simulated time, so a sweep over offered loads
  is deterministic and runs as fast as the engine can step, not in
  wall-clock real time;
* :class:`LoadGenerator` — drives an :class:`AsyncGateway` through a
  trace in either virtual time (deterministic: interleaves arrivals
  with ``pump`` calls, no background thread) or real time (the thread
  serves while this sleeps between arrivals);
* :class:`LoadReport` — offered vs completed vs shed, goodput under
  SLO, and latency percentiles from the gateway's reservoir.

Same seed + virtual clock => bit-identical completions, sheds, and
latencies across runs; that's what makes shedding behaviour testable.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Sequence

import numpy as np

from repro_torch.data.synthetic_squad import Question
from repro_torch.routing.gateway import Request
from repro_torch.serving.slo_budget import LatencyReservoir


# ---------------------------------------------------------------------------
# arrival processes
# ---------------------------------------------------------------------------

class PoissonProcess:
    """Homogeneous Poisson arrivals: exponential inter-arrival times at
    ``rate`` requests/second, seeded."""

    def __init__(self, rate: float, *, seed: int = 0):
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.rng = np.random.default_rng(seed)

    def inter_arrivals(self) -> Iterator[float]:
        while True:
            yield float(self.rng.exponential(1.0 / self.rate))


class OnOffProcess:
    """Bursty on-off (interrupted Poisson) arrivals: alternate between
    an ON phase arriving at ``burst_rate`` and an OFF phase of silence,
    with exponentially distributed phase durations.  Mean offered rate
    is ``burst_rate * on_s / (on_s + off_s)`` — the same average load
    as a Poisson process stresses admission control far harder because
    arrivals clump."""

    def __init__(self, burst_rate: float, *, on_s: float = 0.5,
                 off_s: float = 0.5, seed: int = 0):
        if burst_rate <= 0:
            raise ValueError(f"burst_rate must be > 0, got {burst_rate}")
        self.burst_rate = float(burst_rate)
        self.on_s = float(on_s)
        self.off_s = float(off_s)
        self.rng = np.random.default_rng(seed)

    @property
    def mean_rate(self) -> float:
        return self.burst_rate * self.on_s / (self.on_s + self.off_s)

    def inter_arrivals(self) -> Iterator[float]:
        while True:
            # one ON phase of Poisson arrivals...
            phase = float(self.rng.exponential(self.on_s))
            t = 0.0
            while True:
                gap = float(self.rng.exponential(1.0 / self.burst_rate))
                if t + gap > phase:
                    break
                t += gap
                yield gap
            # ...then the residual ON time plus a silent OFF phase is
            # one long gap before the next burst's first arrival
            yield (phase - t) + float(self.rng.exponential(self.off_s))


@dataclass(frozen=True)
class Arrival:
    """One request in a trace: its absolute arrival time (seconds from
    trace start) and payload."""

    t: float
    request: Request


def build_trace(questions: Sequence[Question], process, n: int, *,
                slo: str = "quality_first",
                deadline_ms: float = 0.0) -> List[Arrival]:
    """Materialise ``n`` arrivals from an arrival process, cycling
    through ``questions``.  The trace is a plain list, so the same
    trace can be replayed against different gateways/configs."""
    if not questions:
        raise ValueError("build_trace needs at least one question")
    gaps = process.inter_arrivals()
    t = 0.0
    out: List[Arrival] = []
    for i in range(n):
        t += next(gaps)
        q = questions[i % len(questions)]
        out.append(Arrival(t=t, request=Request(
            qid=i, question=q, slo=slo, deadline_ms=deadline_ms)))
    return out


# ---------------------------------------------------------------------------
# virtual time
# ---------------------------------------------------------------------------

class VirtualClock:
    """Simulated monotonic time.  Pass ``clock.now`` wherever a
    ``time.perf_counter``-style callable is accepted (AsyncGateway,
    ContinuousEngine, SimulatorBackend) and every latency stamp in the
    system becomes virtual-time-consistent and deterministic."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance time backwards (dt={dt})")
        self._t += dt
        return self._t

    def advance_to(self, t: float) -> float:
        if t > self._t:
            self._t = t
        return self._t


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------

@dataclass
class LoadReport:
    """What an open-loop run offered and what the service delivered."""

    offered: int = 0
    completed: int = 0           # got a terminal outcome of any kind
    answered: int = 0            # completed, not refused/shed
    refused: int = 0             # policy or forced refusals
    shed: int = 0                # rejected at the queue by admission
    forced_refusals: int = 0
    depth_clamped: int = 0
    deadline_met: int = 0        # answered within their deadline
    degraded: int = 0            # served on the fallback retriever
    retries: int = 0             # transient-fault resubmissions
    timed_out: int = 0           # cancelled mid-stream past deadline
    faulted: int = 0             # transient failures after retry budget
    duration_s: float = 0.0      # arrival-span of the trace (virtual)
    latency: LatencyReservoir = field(
        default_factory=lambda: LatencyReservoir())
    first_token: LatencyReservoir = field(
        default_factory=lambda: LatencyReservoir())
    # per-stage latency percentiles from the gateway's tracer, keyed
    # stage -> {n, p50_ms, p99_ms}; empty when tracing is disabled
    stages: Dict[str, Dict[str, float]] = field(default_factory=dict)

    @property
    def offered_rate(self) -> float:
        return self.offered / self.duration_s if self.duration_s > 0 else 0.0

    @property
    def goodput(self) -> float:
        """Goodput under SLO: answered-within-deadline per second of
        trace time — the paper-grade serving metric (raw throughput
        counts late and refused work; goodput doesn't)."""
        return (self.deadline_met / self.duration_s
                if self.duration_s > 0 else 0.0)

    @property
    def goodput_fraction(self) -> float:
        return self.deadline_met / max(self.offered, 1)

    @property
    def shed_fraction(self) -> float:
        return self.shed / max(self.offered, 1)

    def as_dict(self) -> Dict[str, float]:
        d = {
            "offered": self.offered, "completed": self.completed,
            "answered": self.answered, "refused": self.refused,
            "shed": self.shed, "forced_refusals": self.forced_refusals,
            "depth_clamped": self.depth_clamped,
            "deadline_met": self.deadline_met,
            "degraded": self.degraded, "retries": self.retries,
            "timed_out": self.timed_out, "faulted": self.faulted,
            "duration_s": round(self.duration_s, 4),
            "offered_rate": round(self.offered_rate, 3),
            "goodput": round(self.goodput, 3),
            "goodput_fraction": round(self.goodput_fraction, 4),
            "shed_fraction": round(self.shed_fraction, 4),
        }
        for k, v in self.latency.percentiles().items():
            d[f"latency_{k}"] = v
        for k, v in self.first_token.percentiles().items():
            d[f"first_token_{k}"] = v
        if self.stages:
            d["stages"] = self.stages
        return d


# ---------------------------------------------------------------------------
# the load generator
# ---------------------------------------------------------------------------

class LoadGenerator:
    """Replays a trace of arrivals against an :class:`AsyncGateway`.

    Two drive modes:

    * :meth:`run_virtual` — discrete-event: no background thread; the
      generator owns the gateway's :class:`VirtualClock`, submits each
      arrival at its trace time, and charges ``service_quantum_s`` of
      virtual time per ``pump``.  Deterministic (same seed, same
      everything) and as fast as the backend can step.
    * :meth:`run_realtime` — the gateway's serving thread runs; the
      generator sleeps out real inter-arrival gaps.  This is the
      honest-wall-clock mode the benchmark's timing rows use.
    """

    def __init__(self, gateway, trace: Sequence[Arrival]):
        self.gateway = gateway
        self.trace = list(trace)
        if not self.trace:
            raise ValueError("empty trace")
        # handles of the most recent run — benches read per-request
        # detail (e.g. recovery time) the aggregate report drops
        self.last_handles: List = []

    # -- shared bookkeeping -------------------------------------------

    def _report(self, handles) -> LoadReport:
        self.last_handles = list(handles)
        rep = LoadReport(offered=len(handles),
                         duration_s=self.trace[-1].t)
        st = self.gateway.stats
        rep.forced_refusals = st.forced_refusals
        rep.depth_clamped = st.depth_clamped
        rep.degraded = getattr(st, "degraded", 0)
        rep.retries = getattr(st, "retries", 0)
        rep.timed_out = getattr(st, "timed_out", 0)
        rep.faulted = getattr(st, "faulted", 0)
        for h in handles:
            if not h.done():
                continue
            rep.completed += 1
            if h.shed:
                rep.shed += 1
                continue
            lat = h.latency_ms
            if lat is not None:
                rep.latency.record(lat)
            ft = h.first_token_ms
            if ft is not None:
                rep.first_token.record(ft)
            if h.outcome.refused:
                rep.refused += 1
            else:
                rep.answered += 1
                if h.deadline_met:
                    rep.deadline_met += 1
        tracer = getattr(self.gateway, "tracer", None)
        if tracer is not None and tracer.enabled:
            rep.stages = tracer.stage_percentiles()
        return rep

    # -- virtual-time (deterministic) ---------------------------------

    def run_virtual(self, clock: VirtualClock, *,
                    service_quantum_s: float = 0.01) -> LoadReport:
        """Discrete-event replay: between arrivals the gateway pumps,
        each pump costing ``service_quantum_s`` virtual seconds; when
        the gateway goes idle the clock jumps to the next arrival.
        Caller must have built the gateway (and its backend/engine)
        with ``clock.now`` so all stamps agree."""
        gw = self.gateway
        handles = []
        i = 0
        n = len(self.trace)
        while i < n or gw.in_flight:
            # submit everything whose arrival time has come
            while i < n and self.trace[i].t <= clock.now():
                handles.append(gw.submit_stream(self.trace[i].request))
                i += 1
            progressed = gw.pump()
            clock.advance(service_quantum_s)
            if progressed == 0 and not gw.in_flight and i < n:
                # idle: jump straight to the next arrival
                clock.advance_to(self.trace[i].t)
        return self._report(handles)

    # -- real-time (background serving thread) ------------------------

    def run_realtime(self, *, timeout_s: float = 120.0) -> LoadReport:
        """Replay the trace in wall-clock time against the gateway's
        background serving thread (started/stopped here).  On a mesh
        every rank replays the trace, and rank 0 alone decides when
        serving ends (drained or ``timeout_s``): a follower's ``stop``
        waits for rank 0's."""
        gw = self.gateway
        handles = []
        gw.start()
        try:
            t0 = time.perf_counter()
            for arr in self.trace:
                lag = arr.t - (time.perf_counter() - t0)
                if lag > 0:
                    # repro: allow[RPL001] real-time pacing IS this method's contract; run() replays on the virtual clock
                    time.sleep(lag)
                handles.append(gw.submit_stream(arr.request))
            deadline = time.perf_counter() + timeout_s
            while (gw.in_flight and getattr(gw, "is_leader", True)
                   and time.perf_counter() < deadline):
                # repro: allow[RPL001] real-time pacing IS this method's contract; run() replays on the virtual clock
                time.sleep(1e-3)
        finally:
            gw.stop(drain=False, timeout=timeout_s)
        return self._report(handles)


def sweep_offered_load(make_gateway, questions: Sequence[Question],
                       rates: Sequence[float], *, n_requests: int = 200,
                       deadline_ms: float = 200.0, seed: int = 0,
                       slo: str = "quality_first",
                       service_quantum_s: float = 0.01
                       ) -> List[Dict[str, float]]:
    """Offered-load sweep: for each rate, build a fresh gateway (via
    ``make_gateway(clock)``), replay a seeded Poisson trace in virtual
    time, and collect one report row.  Fresh gateway per rate so budget
    state never leaks across operating points."""
    rows: List[Dict[str, float]] = []
    for rate in rates:
        clock = VirtualClock()
        gw = make_gateway(clock)
        trace = build_trace(questions, PoissonProcess(rate, seed=seed),
                            n_requests, slo=slo, deadline_ms=deadline_ms)
        rep = LoadGenerator(gw, trace).run_virtual(
            clock, service_quantum_s=service_quantum_s)
        row = {"rate": rate, **rep.as_dict()}
        rows.append(row)
    return rows
