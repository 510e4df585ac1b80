"""Per-request span tracer with Chrome trace-event export.

Mark-based API: instrumentation sites record *completed* intervals
(``mark(qid, stage, t0, t1)``) against an open request started by
``begin_request``; ``finish_request`` closes the request, computes its
:class:`RequestBreakdown`, and (bounded, seeded) samples the span tree
for export.  The clock is injected (RPL007 / RPL001): under the
virtual-time pump every timestamp is virtual, and a Chrome trace of a
virtual run opens in Perfetto like any wall-clock trace.

Why marks instead of begin/end pairs: the serving stack already stamps
the interesting instants (arrival, pop, dispatch, ``admitted_at``,
``finished_at``, account time) on its own structures, so handing the
tracer closed intervals avoids a parallel begin/end bookkeeping state
machine on the hot path and makes "every span closed" trivially true
for everything but the root.

The ``note``/``adopt`` pair handles the one spot where the instrumented
layer does not know the request id: the backend's retrieval step runs
keyed by *question* id while the gateway tracks *request* qids.  The
backend notes an anonymous span; the gateway — single-threaded under
the pump lock — adopts pending notes onto the qid it just submitted.

``NULL_TRACER`` is the disabled path: every method is a constant-return
no-op (no clock reads, no allocation), so instrumented code never
branches on "is tracing on" and the healthy-path parity test can assert
token-identical outputs either way.
"""
from __future__ import annotations

import json
import math
import random
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.obs.attribution import (KINDS, STAGES, TOP_LEVEL,
                                   RequestBreakdown, StageAttribution)

_EPS_S = 1e-9


@dataclass(slots=True)
class Span:
    """One closed interval inside a request tree (seconds, clock domain)."""

    name: str
    t0: float
    t1: float
    attrs: Dict[str, object] = field(default_factory=dict)


@dataclass(slots=True)
class RequestTree:
    """Root request span plus its child stage spans."""

    qid: int
    start: float
    end: Optional[float] = None      # None while the request is open
    kind: str = "open"
    spans: List[Span] = field(default_factory=list)


class _Reservoir:
    """Algorithm-R sample of floats (stdlib RNG; obs stays numpy-free)."""

    __slots__ = ("capacity", "count", "samples", "_rng")

    def __init__(self, capacity: int, rng: random.Random) -> None:
        self.capacity = capacity
        self.count = 0
        self.samples: List[float] = []
        self._rng = rng

    def record(self, v: float) -> None:
        self.count += 1
        if len(self.samples) < self.capacity:
            self.samples.append(v)
        else:
            j = self._rng.randrange(self.count)
            if j < self.capacity:
                self.samples[j] = v

    def percentile(self, q: float) -> float:
        if not self.samples:
            return math.nan
        xs = sorted(self.samples)
        idx = min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))
        return xs[idx]


class Tracer:
    """Span-tree tracer; one instance per gateway, injected clock."""

    enabled = True

    def __init__(self, clock: Callable[[], float], *,
                 max_trees: int = 512, max_breakdowns: int = 4096,
                 stage_reservoir: int = 4096, seed: int = 0) -> None:
        if not callable(clock):
            raise TypeError("Tracer requires an injectable clock "
                            "callable as its first argument")
        self.clock = clock
        self.max_trees = max_trees
        self._rng = random.Random(seed)
        self._active: Dict[int, RequestTree] = {}
        self._trees: List[RequestTree] = []
        self._n_finished = 0           # drives algorithm-R tree sampling
        self._pending: List[Span] = []
        self.engine_spans: Deque[Span] = deque(maxlen=4096)
        self.breakdowns: Deque[RequestBreakdown] = deque(
            maxlen=max_breakdowns)
        self._stage_res: Dict[str, _Reservoir] = {
            s: _Reservoir(stage_reservoir, self._rng) for s in STAGES}
        self._e2e_res = _Reservoir(stage_reservoir, self._rng)

    # -- hot-path API ----------------------------------------------------
    def now(self) -> float:
        return self.clock()

    def begin_request(self, qid: int, t: float) -> None:
        """Open the root span (idempotent: a retry re-begin is a no-op)."""
        if qid not in self._active:
            self._active[qid] = RequestTree(qid=qid, start=t)

    def mark(self, qid: int, stage: str, t0: float, t1: float,
             **attrs: object) -> None:
        """Record stage ``[t0, t1]`` on an open request.  Re-marking a
        stage overwrites it (retries re-enter admission); marking an
        unknown qid is a silent no-op (already-failed victims)."""
        tree = self._active.get(qid)
        if tree is None:
            return
        # kwargs arrive as a fresh dict — no defensive copy needed
        for sp in tree.spans:
            if sp.name == stage:
                sp.t0, sp.t1, sp.attrs = t0, t1, attrs
                return
        tree.spans.append(Span(stage, t0, t1, attrs))

    def note(self, stage: str, t0: float, t1: float,
             **attrs: object) -> None:
        """Record an anonymous span for the next ``adopt`` (backend
        layers that don't know the request qid)."""
        self._pending.append(Span(stage, t0, t1, attrs))

    def adopt(self, qid: int) -> None:
        """Attach all pending noted spans to ``qid`` (or drop them if
        the request is unknown).  Caller serialises note→adopt."""
        pending, self._pending = self._pending, []
        tree = self._active.get(qid)
        if tree is None:
            return
        for sp in pending:
            self.mark(qid, sp.name, sp.t0, sp.t1, **sp.attrs)

    def discard_pending(self) -> None:
        """Drop noted spans that cannot be attributed (batched closed-
        loop execution interleaves notes across requests)."""
        self._pending = []

    def engine_span(self, name: str, t0: float, t1: float,
                    **attrs: object) -> None:
        """Engine-level span not tied to one request (prefill dispatch,
        decode chunk).  Bounded deque; rendered on its own track."""
        self.engine_spans.append(Span(name, t0, t1, attrs))

    def finish_request(self, qid: int, kind: str,
                       t: Optional[float] = None,
                       cost_tokens: float = 0.0,
                       ) -> Optional[RequestBreakdown]:
        """Close the request, compute its breakdown, sample the tree."""
        tree = self._active.pop(qid, None)
        if tree is None:
            return None
        if kind not in KINDS:
            raise ValueError(f"unknown terminal kind {kind!r}")
        end = self.clock() if t is None else t
        tree.end = max(end, tree.start)
        tree.kind = kind
        stages: Dict[str, float] = {}
        for sp in tree.spans:
            dur_ms = max(0.0, sp.t1 - sp.t0) * 1e3
            stages[sp.name] = stages.get(sp.name, 0.0) + dur_ms
        e2e_ms = (tree.end - tree.start) * 1e3
        bd = RequestBreakdown(qid=qid, kind=kind, e2e_ms=e2e_ms,
                              stages=stages, cost_tokens=cost_tokens)
        self.breakdowns.append(bd)
        for s, v in stages.items():
            self._stage_res[s].record(v)
        self._e2e_res.record(e2e_ms)
        # algorithm R over finished trees keeps export bounded at high
        # rate while every request still gets a breakdown above
        self._n_finished += 1
        if len(self._trees) < self.max_trees:
            self._trees.append(tree)
        else:
            j = self._rng.randrange(self._n_finished)
            if j < self.max_trees:
                self._trees[j] = tree
        return bd

    # -- export / inspection --------------------------------------------
    @property
    def n_open(self) -> int:
        return len(self._active)

    @property
    def n_finished(self) -> int:
        return self._n_finished

    @property
    def sampled_trees(self) -> List[RequestTree]:
        return list(self._trees)

    def stage_percentiles(self) -> Dict[str, Dict[str, float]]:
        """Per-stage {n, p50, p99} ms over the seeded reservoirs."""
        out: Dict[str, Dict[str, float]] = {}
        for s in STAGES:
            res = self._stage_res[s]
            if res.count == 0:
                continue
            out[s] = {"n": res.count,
                      "p50_ms": round(res.percentile(0.50), 4),
                      "p99_ms": round(res.percentile(0.99), 4)}
        if self._e2e_res.count:
            out["e2e"] = {"n": self._e2e_res.count,
                          "p50_ms": round(self._e2e_res.percentile(0.50), 4),
                          "p99_ms": round(self._e2e_res.percentile(0.99), 4)}
        return out

    def chrome_trace(self) -> Dict[str, object]:
        """Chrome trace-event JSON (open in Perfetto / chrome://tracing).
        Request trees render as pid 1 with one tid per qid; engine spans
        share pid 0 / tid 0.  ts/dur are microseconds of the injected
        clock domain."""
        events: List[Dict[str, object]] = [
            {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
             "args": {"name": "engine"}},
            {"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
             "args": {"name": "requests"}},
        ]

        def ev(name, t0, t1, pid, tid, args):
            return {"name": name, "ph": "X", "cat": "repro",
                    "ts": round(t0 * 1e6, 3),
                    "dur": round(max(0.0, t1 - t0) * 1e6, 3),
                    "pid": pid, "tid": tid, "args": args}

        for sp in self.engine_spans:
            events.append(ev(sp.name, sp.t0, sp.t1, 0, 0, sp.attrs))
        for tree in self._trees:
            end = tree.end if tree.end is not None else tree.start
            events.append(ev(f"request[{tree.kind}]", tree.start, end,
                             1, tree.qid, {"qid": tree.qid}))
            for sp in tree.spans:
                events.append(ev(sp.name, sp.t0, sp.t1, 1, tree.qid,
                                 sp.attrs))
        events.sort(key=lambda e: (e["pid"], e["tid"],
                                   e.get("ts", -1.0)))
        # otherData is the trace-event format's free-form top-level
        # slot (viewers ignore it): ship the well-formedness audit with
        # the artifact so consumers (the CI obs-smoke job) can assert
        # problems == [] without re-driving the tracer
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"n_finished": self._n_finished,
                              "n_open": len(self._active),
                              "problems": self.problems()}}

    def chrome_trace_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.chrome_trace(), indent=indent)

    def problems(self) -> List[str]:
        """Well-formedness audit: every sampled span closed and inside
        its root interval; no requests left open.  Empty list == clean
        (asserted by the CI obs-smoke job)."""
        out: List[str] = []
        for qid in sorted(self._active):
            out.append(f"request {qid} never finished (span left open)")
        for tree in self._trees:
            if tree.end is None:
                out.append(f"request {tree.qid} sampled while open")
                continue
            for sp in tree.spans:
                if sp.t1 < sp.t0 - _EPS_S:
                    out.append(f"request {tree.qid} span {sp.name} "
                               f"ends before it starts")
                if (sp.t0 < tree.start - _EPS_S
                        or sp.t1 > tree.end + _EPS_S):
                    out.append(f"request {tree.qid} span {sp.name} "
                               f"escapes root interval")
        for sp in self.engine_spans:
            if sp.t1 < sp.t0 - _EPS_S:
                out.append(f"engine span {sp.name} ends before it starts")
        return out


class NullTracer:
    """Disabled tracer: every method is a constant-return no-op.  Kept
    signature-compatible with :class:`Tracer` so hot paths never branch
    on enablement."""

    enabled = False
    engine_spans: Tuple[()] = ()
    breakdowns: Tuple[()] = ()

    def now(self) -> float:
        return 0.0

    def begin_request(self, qid, t) -> None:
        pass

    def mark(self, qid, stage, t0, t1, **attrs) -> None:
        pass

    def note(self, stage, t0, t1, **attrs) -> None:
        pass

    def adopt(self, qid) -> None:
        pass

    def discard_pending(self) -> None:
        pass

    def engine_span(self, name, t0, t1, **attrs) -> None:
        pass

    def finish_request(self, qid, kind, t=None, cost_tokens=0.0) -> None:
        return None

    def stage_percentiles(self) -> Dict[str, Dict[str, float]]:
        return {}

    def problems(self) -> List[str]:
        return []


NULL_TRACER = NullTracer()
