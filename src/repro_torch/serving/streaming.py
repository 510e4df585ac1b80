"""Open-loop streaming gateway: always-on serving over the continuous
engine, with SLO-actuated admission control.

Every serving path before this module was closed-loop: the
:class:`~repro_torch.routing.gateway.Gateway` routes a finished micro-batch,
blocks in ``execute_mixed`` until the engine drains, and harvests.
Real traffic is open-loop — requests arrive whenever they arrive, and
the service's obligation (the SLO) is per-request latency, not batch
throughput.  :class:`AsyncGateway` makes the engine's mid-stream
admission and prefill/decode overlap *always-on*:

* clients call :meth:`AsyncGateway.submit_stream` at any time from any
  thread and get a :class:`StreamHandle` (future) back;
* a background host serving thread (or an external caller of
  :meth:`AsyncGateway.pump` — the deterministic path the virtual-time
  load harness uses) continuously drains the arrival queue, routes
  admitted requests, feeds them into the backend's shared in-flight
  stream, and completes handles as the engine harvests them.

**The control loop.**  The SLO budget tracker stops being a passive
observer here: :class:`AdmissionConfig` maps short-window budget burn
(:meth:`~repro_torch.serving.slo_budget.SLOBudgetTracker.burn_rate`) to three
actuations, applied at the queue in escalating order of severity and
counted separately from policy refusals in ``GatewayStats``:

1. **load-shed** — reject at the queue (typed ``shed`` outcome, the
   request is never routed): backlog beyond ``max_backlog``, the
   request's deadline already expired while queued, or the latency
   budget burning past ``shed_burn``;
2. **force-refuse** — the policy routed an answer but the latency/cost
   budgets burn past ``force_refuse_burn``: the request is served the
   cheap refusal instead (the paper's refusal action as a *load* tool,
   the reconfiguration loop of the SLA-management RAG paper);
3. **depth-clamp** — cost burn past ``clamp_burn``: the routed action
   is swapped for the shallowest same-mode/same-retriever action, so
   retrieval depth (the paper's main cost lever) sheds work without
   refusing anyone.

Determinism: ``pump`` holds one lock and consumes the arrival queue in
submission order; with a virtual clock (see
:mod:`repro_torch.serving.traffic`) and no background thread, the same seed
reproduces the same completions, sheds, and latencies bit-for-bit.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

from collections import deque

from repro_torch.core.errors import TransientFaultError
from repro_torch.obs import RequestBreakdown
from repro_torch.routing.gateway import Gateway, GatewayStats, Request
from repro_torch.routing.registry import Action
from repro_torch.serving.faults import RetryPolicy
from repro_torch.serving.pipeline import ActionOutcome
from repro_torch.serving.slo_budget import BudgetState, latency_target

SHED_TEXT = "<shed: admission control rejected this request>"

# sentinel: "caller didn't say" vs an explicit retry=None (disabled)
_DEFAULT_RETRY = object()


@dataclass(frozen=True)
class AdmissionConfig:
    """Thresholds mapping budget burn to queue-level actuation.

    Burn rates are short-window ``budget_consumed`` values (1.0 = the
    recent window alone is eating exactly the full error budget); the
    defaults engage shedding only under sustained violation."""

    max_backlog: int = 64            # shed beyond this many in flight
    shed_burn: float = 2.0           # latency burn-rate => shed at queue
    force_refuse_burn: float = 1.5   # latency/cost burn => forced refusal
    clamp_burn: float = 1.0          # cost burn => clamp retrieval depth
    burn_window: int = 64            # events in the actuation window
    min_events: int = 16             # no burn actuation before this many
    shed_expired: bool = True        # shed requests already past deadline

    def __post_init__(self):
        if self.max_backlog < 1:
            raise ValueError("max_backlog must be >= 1")


@dataclass
class StreamHandle:
    """Future for one open-loop request.

    ``outcome`` is an :class:`ActionOutcome`; ``shed=True`` marks a
    request admission control rejected at the queue (it was never
    routed or served — typed apart from policy refusals).  Timestamps
    are gateway-clock seconds."""

    request: Request
    arrival_t: float
    outcome: Optional[ActionOutcome] = None
    shed: bool = False
    forced_refusal: bool = False
    first_token_t: Optional[float] = None
    completed_t: Optional[float] = None
    retries: int = 0                  # transient-fault resubmissions
    # set when the gateway itself died (backend raised a non-transient
    # exception): result() re-raises it instead of returning an outcome
    error: Optional[BaseException] = None
    # per-stage latency attribution (queue_wait/admission/retrieval/
    # prefill/decode/harvest) — set at completion when tracing is on
    breakdown: Optional[RequestBreakdown] = None
    _event: threading.Event = field(default_factory=threading.Event)
    # gateway-internal: routed action + whether burn forced the refusal
    _action: int = -1
    _forced: bool = False
    # gateway-internal trace stamps: popped off the arrival queue /
    # handed to the backend stream (gateway-clock seconds; 0 = not yet)
    _pop_t: float = 0.0
    _dispatch_t: float = 0.0

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> ActionOutcome:
        """Block until completed (or raise TimeoutError).  Raises the
        gateway's fatal error if serving died while this was in
        flight — a hung ``wait`` is never the failure mode."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request qid={self.request.qid} still in flight")
        if self.error is not None:
            raise self.error
        return self.outcome

    @property
    def latency_ms(self) -> Optional[float]:
        if self.completed_t is None:
            return None
        return (self.completed_t - self.arrival_t) * 1e3

    @property
    def first_token_ms(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return (self.first_token_t - self.arrival_t) * 1e3

    @property
    def deadline_met(self) -> bool:
        """Completed, answered (not shed/refused), within deadline."""
        if self.outcome is None or self.shed or self.outcome.refused:
            return False
        if self.request.deadline_ms <= 0:
            return True
        return self.latency_ms <= self.request.deadline_ms

    def _complete(self, outcome: ActionOutcome, t: float, *,
                  shed: bool = False, forced: bool = False,
                  first_token_t: Optional[float] = None) -> None:
        self.outcome = outcome
        self.shed = shed
        self.forced_refusal = forced
        self.first_token_t = first_token_t
        self.completed_t = t
        self._event.set()


class AsyncGateway(Gateway):
    """Open-loop serving: thread-safe submission + an always-on pump.

    Subclasses :class:`Gateway`, so the closed-loop ``serve`` /
    ``step`` paths (and all their routing, refusal-cap back-pressure,
    and accounting) are untouched — this class adds the streaming
    entry points on top.  The backend must implement the streaming
    protocol (``stream_submit`` / ``stream_poll`` / ``stream_backlog``
    — :class:`~repro_torch.routing.engine_backend.ContinuousEngineBackend`
    over the real engine, :class:`~repro_torch.routing.backends
    .SimulatorBackend` for the synthetic service model).

    ``clock`` is injectable: pass a virtual clock's ``now`` (and build
    the backend's engine with the same clock) for deterministic
    simulated-time serving; the default is the host monotonic clock.
    """

    def __init__(self, policy, backend, *, admission: Optional[
                     AdmissionConfig] = None,
                 clock: Optional[Callable[[], float]] = None,
                 deadline_ms: float = 0.0,
                 latency_objective: float = 0.90,
                 route_batch: int = 16, retry=_DEFAULT_RETRY,
                 **gateway_kw):
        if not hasattr(backend, "stream_submit"):
            raise TypeError(
                f"AsyncGateway needs a streaming backend (stream_submit/"
                f"stream_poll); {type(backend).__name__} has neither — "
                f"use ContinuousEngineBackend or SimulatorBackend")
        # streaming retries default ON (one deadline-aware resubmission
        # per request): with no faults in play the transient path never
        # fires, so this is parity-safe; pass retry=None to disable
        if retry is _DEFAULT_RETRY:
            retry = RetryPolicy(max_retries=1)
        # the clock goes through the base Gateway so closed-loop spans,
        # the tracer, and open-loop stamps all share one time domain
        super().__init__(policy, backend, retry=retry, clock=clock,
                         **gateway_kw)
        self.admission = admission or AdmissionConfig()
        # default per-request deadline (ms) stamped at submission when
        # the request doesn't carry one; 0 = no deadline
        self.deadline_ms = float(deadline_ms)
        self.route_batch = max(1, route_batch)
        # the latency SLO joins the budget targets so burn-rate
        # actuation has a latency signal to watch (threshold = the
        # default deadline when set, else 1s)
        thr = self.deadline_ms if self.deadline_ms > 0 else 1000.0
        if "latency" not in self.budget.states:
            t = latency_target(thr, objective=latency_objective)
            self.budget.states[t.name] = BudgetState(t)
        self.budget.burn_window = self.admission.burn_window
        self._lock = threading.Lock()
        self._arrivals: Deque[StreamHandle] = deque()
        self._in_flight: Dict[int, StreamHandle] = {}   # rid -> handle
        # transient-fault resubmissions waiting out their backoff:
        # (not-before gateway-clock time, handle), submission order
        self._retry_q: List[Tuple[float, StreamHandle]] = []
        # fatal serving error (backend raised non-transiently): set
        # once, rejects everything in flight, makes drain/stop return
        self._failed: Optional[BaseException] = None
        # handles popped off the queues and being dispatched by the
        # CURRENT pump iteration — they live in pump-local lists, so
        # _fail must see them here or a fatal mid-dispatch exception
        # would strand them pending forever (the silent-hang bug)
        self._processing: List[StreamHandle] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._shallowest: Dict[Tuple[str, str], Action] = {}
        for a in self.space:
            if a.mode == "refuse" or a.k <= 0:
                continue
            key = (a.mode, a.retriever)
            cur = self._shallowest.get(key)
            if cur is None or a.k < cur.k:
                self._shallowest[key] = a

    # -- submission (any thread, any time) -----------------------------

    def submit_stream(self, request: Request) -> StreamHandle:
        """Enqueue one open-loop request; returns its future.  The
        arrival time and deadline are stamped HERE — queueing delay is
        part of the latency the SLO measures."""
        now = self.clock()
        if request.deadline_ms <= 0 and self.deadline_ms > 0:
            request.deadline_ms = self.deadline_ms
        request.arrival_ms = now * 1e3
        handle = StreamHandle(request=request, arrival_t=now)
        with self._lock:
            failed = self._failed
            if failed is None:
                self._arrivals.append(handle)
                # root span opens at arrival: queueing delay is part of
                # what the trace must attribute (tracer state is only
                # ever touched under the pump lock)
                self.tracer.begin_request(request.qid, now)
        if failed is not None:
            # a dead gateway must not hand out handles that never
            # complete: reject immediately with the fatal error
            handle.error = failed
            handle._complete(self._fault_outcome(
                request, -1, f"gateway failed: {failed}"), now)
        return handle

    @property
    def in_flight(self) -> int:
        """Requests somewhere between submission and completion."""
        with self._lock:
            return (len(self._arrivals) + len(self._in_flight)
                    + len(self._retry_q))

    @property
    def failed(self) -> Optional[BaseException]:
        """The fatal serving error, if the gateway has died."""
        return self._failed

    # -- admission control ---------------------------------------------

    def _shed_outcome(self, req: Request) -> ActionOutcome:
        a = self.space.refuse_action
        return ActionOutcome(
            qid=req.qid, action=(a if a is not None else -1),
            correct=False, refused=True, hallucinated=False,
            cost_tokens=0.0, hit=False,
            answerable=req.question.answerable, answer=SHED_TEXT)

    def _should_shed(self, handle: StreamHandle, now: float,
                     backlog: int) -> bool:
        adm = self.admission
        if backlog >= adm.max_backlog:
            return True
        req = handle.request
        if (adm.shed_expired and req.deadline_ms > 0
                and (now - handle.arrival_t) * 1e3 > req.deadline_ms):
            return True     # deadline burned in the queue: serving it
        #                     can only waste slots other requests need
        lat = self.budget.states.get("latency")
        if (lat is not None and len(lat.events) >= adm.min_events
                and lat.burn_rate(adm.burn_window) >= adm.shed_burn):
            return True
        return False

    def _burn(self, name: str) -> float:
        s = self.budget.states.get(name)
        if s is None or len(s.events) < self.admission.min_events:
            return 0.0
        return s.burn_rate(self.admission.burn_window)

    def _actuate_action(self, a: int) -> Tuple[int, str]:
        """Post-route actuation for one request: returns (action_idx,
        "" | "forced_refuse" | "clamped")."""
        action = self.space[a]
        if action.mode == "refuse":
            return a, ""
        adm = self.admission
        hot = max(self._burn("latency"), self._burn("cost"))
        ref = self.space.refuse_action
        if ref is not None and hot >= adm.force_refuse_burn:
            return ref, "forced_refuse"
        if action.k > 0 and self._burn("cost") >= adm.clamp_burn:
            shallow = self._shallowest.get((action.mode, action.retriever))
            if shallow is not None and shallow.k < action.k:
                return shallow.idx, "clamped"
        return a, ""

    # -- fault handling -------------------------------------------------

    def _fault_outcome(self, req: Request, a: int,
                       reason: str) -> ActionOutcome:
        """Terminal transient-failure outcome (typed ``transient`` so
        GatewayStats counts it under ``faulted``, apart from sheds and
        policy refusals)."""
        ref = self.space.refuse_action
        idx = a if a >= 0 else (ref if ref is not None else -1)
        return ActionOutcome(
            qid=req.qid, action=idx, correct=False, refused=True,
            hallucinated=False, cost_tokens=0.0, hit=False,
            answerable=req.question.answerable,
            answer=f"<transient fault: {reason}>", transient=True)

    def _deadline_at(self, h: StreamHandle) -> float:
        """Absolute gateway-clock deadline for the backend to enforce
        mid-stream (0 = none)."""
        if h.request.deadline_ms <= 0:
            return 0.0
        return h.arrival_t + h.request.deadline_ms / 1e3

    def _try_schedule_retry(self, h: StreamHandle, now: float) -> bool:
        """Queue one bounded, deadline-aware resubmission for a
        transient failure.  Never schedules a retry whose backoff alone
        would land past the request's deadline.  Lock held."""
        if self.retry is None or h.retries >= self.retry.max_retries:
            return False
        wait = self.retry.backoff(h.retries)
        dl = h.request.deadline_ms
        if dl > 0 and (now - h.arrival_t + wait) * 1e3 >= dl:
            return False
        h.retries += 1
        self.stats.retries += 1
        self._retry_q.append((now + wait, h))
        return True

    def _submit_handle(self, h: StreamHandle, a: int, now: float, *,
                       forced: bool) -> None:
        """Dispatch one routed handle into the backend stream; a
        transient fault at submit becomes a retry (or a terminal
        ``faulted`` outcome once the budget is spent).  Lock held."""
        h._action = a
        h._forced = forced
        tr = self.tracer
        try:
            rid, immediate = self.backend.stream_submit(
                h.request.question, self.space[a],
                deadline_at=self._deadline_at(h))
        except TransientFaultError as exc:
            # dispatch stamp + adoption of any retrieval note the
            # backend recorded before faulting: the admission span must
            # cover the failed attempt too
            h._dispatch_t = tr.now()
            tr.adopt(h.request.qid)
            if not self._try_schedule_retry(h, now):
                t = self.clock()
                self._account_stream(h, a, self._fault_outcome(
                    h.request, a, str(exc)), t, t, forced=forced)
            return
        # admission ends when the request is IN the backend stream —
        # retrieval ran inside stream_submit, so the retrieval note the
        # backend just recorded nests inside the admission interval.
        # The backend doesn't know our qid (request ids are per-stream),
        # hence note→adopt rather than a direct mark.
        h._dispatch_t = tr.now()
        tr.adopt(h.request.qid)
        if immediate is not None:
            t = self.clock()
            self._account_stream(h, a, immediate, t, t, forced=forced)
        else:
            self._in_flight[rid] = h

    # -- the serving loop body -----------------------------------------

    def pump(self) -> int:
        """One serving iteration: drain arrivals through admission
        control, route + dispatch the admitted batch, advance the
        engine one step, account + complete harvested requests.
        Returns the number of events handled (0 = idle).  Thread-safe;
        the background thread just calls this in a loop.

        A non-transient backend exception marks the whole gateway
        failed (every in-flight handle is rejected with the error so
        no waiter hangs) and re-raises."""
        try:
            return self._pump_once()
        except Exception as exc:
            self._fail(exc)
            raise

    def _pump_once(self) -> int:
        n_events = 0
        with self._lock:
            self._processing = []
            # 0) resubmit retries whose backoff has elapsed (already
            #    routed — they bypass admission and routing)
            now = self.clock()
            if self._retry_q:
                due = [(t, h) for t, h in self._retry_q if t <= now]
                self._retry_q = [(t, h) for t, h in self._retry_q
                                 if t > now]
                self._processing.extend(h for _, h in due)
                for _, h in due:
                    self._submit_handle(h, h._action, now,
                                        forced=h._forced)
                    n_events += 1

            batch: List[StreamHandle] = []
            while self._arrivals and len(batch) < self.route_batch:
                batch.append(self._arrivals.popleft())
            self._processing.extend(batch)

            # 1) queue-level admission: shed before spending any routing
            #    or retrieval work on the request
            admitted: List[StreamHandle] = []
            now = self.clock()
            backlog = self.backend.stream_backlog + len(self._in_flight)
            tr = self.tracer
            for h in batch:
                h._pop_t = now
                if self._should_shed(h, now, backlog + len(admitted)):
                    self.stats.shed += 1
                    # a shed request spent its whole life queued: its
                    # breakdown is pure queue_wait, stage sum == e2e
                    tr.mark(h.request.qid, "queue_wait",
                            h.arrival_t, now)
                    h.breakdown = tr.finish_request(
                        h.request.qid, "shed", t=now)
                    self.budget.record_breakdown(h.breakdown)
                    h._complete(self._shed_outcome(h.request), now,
                                shed=True)
                    n_events += 1
                else:
                    admitted.append(h)

            # 2) route the admitted batch (adaptive refusal cap included)
            if admitted:
                reqs = [h.request for h in admitted]
                decision, cap = self._route(reqs)
                if cap is not None and "refusal_cap" in decision.constraints:
                    self.stats.refusal_cap_history.append(cap)
                self.stats.decisions.append(decision)
                # 3) per-request burn actuation, then into the stream
                for h, a in zip(admitted, decision.actions):
                    a, what = self._actuate_action(int(a))
                    if what == "forced_refuse":
                        self.stats.forced_refusals += 1
                    elif what == "clamped":
                        self.stats.depth_clamped += 1
                    self._submit_handle(h, a, self.clock(),
                                        forced=(what == "forced_refuse"))
                    n_events += 1

            # 4) advance the engine and harvest; transient completions
            #    (executor fault, circuit denial) go back through the
            #    retry budget instead of straight to the caller
            for comp in self.backend.stream_poll():
                h = self._in_flight.pop(comp.rid, None)
                if h is None:
                    continue
                out = comp.outcome
                if (getattr(out, "transient", False)
                        and not getattr(out, "timed_out", False)
                        and self._try_schedule_retry(h, comp.finished_at)):
                    n_events += 1
                    continue
                self._account_stream(h, h._action, out,
                                     comp.finished_at, comp.admitted_at,
                                     forced=h._forced)
                n_events += 1
            self._sync_cache_stats()
            self._processing = []
        return n_events

    def _fail(self, exc: BaseException) -> None:
        """The serving plane died (non-transient backend exception):
        record the error and reject EVERYTHING in flight so no caller
        blocks forever on a handle that can never complete."""
        with self._lock:
            if self._failed is None:
                self._failed = exc
            victims = (list(self._arrivals)
                       + [h for _, h in self._retry_q]
                       + list(self._in_flight.values())
                       + [h for h in self._processing if not h.done()])
            self._arrivals.clear()
            self._retry_q = []
            self._in_flight.clear()
            self._processing = []
        seen: set = set()
        victims = [h for h in victims
                   if not (id(h) in seen or seen.add(id(h)))]
        now = self.clock()
        for h in victims:
            h.error = exc
            # close the victim's trace so no span is left open (the
            # well-formedness audit treats open spans as defects)
            self.tracer.finish_request(h.request.qid, "faulted", t=now)
            # completed-but-errored, NOT accounted: the gateway's stats
            # describe what it served, and it served nothing here
            h._complete(self._fault_outcome(
                h.request, h._action, f"gateway failed: {exc}"), now)

    def _account_stream(self, h: StreamHandle, a: int, out: ActionOutcome,
                        finished_t: float, first_token_t: float, *,
                        forced: bool) -> None:
        """Per-request accounting with TRUE per-request latency
        (arrival -> completion, queueing included) — unlike the
        closed-loop path's per-batch mean."""
        lat_ms = (finished_t - h.arrival_t) * 1e3
        tr = self.tracer
        if tr.enabled:
            # contiguous stage chain: arrival →(queue_wait)→ pop
            # →(admission)→ dispatch →(prefill)→ first token →(decode)→
            # engine finish →(harvest)→ here.  Stamps are clamped into
            # monotone order so a missing stamp (immediate refusal,
            # fault before dispatch) collapses its stage to zero width
            # instead of corrupting the tree — the top-level stage sum
            # equals end-to-end latency by construction.
            qid = h.request.qid
            t_acc = tr.now()
            arr = h.arrival_t
            fin = max(finished_t, arr)
            t_acc = max(t_acc, fin)
            pop = min(max(h._pop_t, arr) if h._pop_t else arr, fin)
            disp = min(max(h._dispatch_t, pop) if h._dispatch_t else pop,
                       fin)
            ft = first_token_t if first_token_t else disp
            ft = min(max(ft, disp), fin)
            tr.mark(qid, "queue_wait", arr, pop)
            tr.mark(qid, "admission", pop, disp)
            tr.mark(qid, "prefill", disp, ft)
            tr.mark(qid, "decode", ft, fin)
            # harvest: the completion sat in the engine's done list
            # until this pump iteration polled it
            tr.mark(qid, "harvest", fin, t_acc)
            if getattr(out, "timed_out", False):
                kind = "timed_out"
            elif getattr(out, "transient", False):
                kind = "faulted"
            else:
                kind = "completed"
            h.breakdown = tr.finish_request(
                qid, kind, t=t_acc, cost_tokens=out.cost_tokens)
            self.budget.record_breakdown(h.breakdown)
        self._account(h.request, a, out, lat_ms)
        h._complete(out, finished_t, forced=forced,
                    first_token_t=first_token_t)

    # -- background serving thread -------------------------------------

    def start(self, *, idle_sleep_s: float = 1e-3) -> "AsyncGateway":
        """Start the always-on host serving thread."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    n = self.pump()
                except Exception:
                    # pump already marked the gateway failed and
                    # rejected every handle; a dead thread must not
                    # keep "serving" — but the death must be countable
                    with self._lock:
                        self.stats.fatal_errors += 1
                    return
                if n == 0:
                    # nothing arrived and nothing finished: yield the
                    # GIL briefly rather than spinning
                    # repro: allow[RPL001] idle GIL yield on the real serving thread; virtual-time tests drive pump() directly
                    time.sleep(idle_sleep_s)

        self._thread = threading.Thread(target=loop, name="async-gateway",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, *, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop the serving thread; with ``drain`` (default) serve out
        everything already submitted first."""
        if drain:
            deadline = time.monotonic() + timeout
            while (self.in_flight and self._failed is None
                   and time.monotonic() < deadline):
                if self._thread is None or not self._thread.is_alive():
                    while (self.in_flight and self._failed is None
                           and time.monotonic() < deadline):
                        try:
                            n = self.pump()
                        except Exception:
                            # handles already rejected by _fail; count
                            # the failed drain so shutdown isn't silent
                            with self._lock:
                                self.stats.fatal_errors += 1
                            break
                        if n == 0:
                            # repro: allow[RPL001] real-time drain pacing at shutdown; virtual-time paths use drain_stream()
                            time.sleep(1e-3)
                    break
                # repro: allow[RPL001] real-time drain pacing at shutdown; virtual-time paths use drain_stream()
                time.sleep(1e-3)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def drain_stream(self) -> GatewayStats:
        """Pump (on the caller's thread) until nothing is in flight.
        Returns immediately once the gateway has failed — ``_fail``
        rejects every outstanding handle, so there is nothing left to
        drain (and nothing to hang on)."""
        while self.in_flight and self._failed is None:
            if self.pump() == 0 and self.in_flight:
                # work exists but didn't advance this tick (e.g. the
                # engine is between chunks) — keep pumping
                continue
        return self.stats

    def __enter__(self) -> "AsyncGateway":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
