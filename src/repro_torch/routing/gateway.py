"""The serving Gateway: one entry point for SLO-routed RAG serving.

  submit -> micro-batch -> RoutingPolicy.route (per-request SLO,
  budget-derived refusal cap) -> action-bucketed batched execution on a
  GenerationBackend -> reward + error-budget accounting.

Anything that implements :class:`~repro_torch.routing.policy.RoutingPolicy`
plugs in (fixed baselines, the trained routing MLP and its constrained
and SLO-conditioned variants).  The execution side is equally
pluggable: the simulator pipeline (a raw ``RAGPipeline`` is wrapped in
a :class:`~repro_torch.routing.backends.SimulatorBackend`), or a
backend with ``execute_mixed`` — the
:class:`~repro_torch.routing.engine_backend.ContinuousEngineBackend` —
serves the whole routed micro-batch as one shared in-flight decode
stream; see :attr:`Gateway.engine_stats` for the engine-side counters.
``retry=`` (a :class:`~repro_torch.serving.faults.RetryPolicy`)
re-executes transient-fault outcomes with backoff, never past a
request's deadline.
"""
from __future__ import annotations

import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.actions import reward
from repro_torch.core.config import RouterConfig
from repro_torch.core.features import state_vector
from repro_torch.core.serving_types import RequestOutcome
from repro_torch.data.synthetic_squad import Question
from repro_torch.obs import NULL_TRACER, MetricsRegistry, Tracer
from repro_torch.routing.backends import GenerationBackend, as_backend
from repro_torch.routing.policy import RoutingContext, RoutingDecision, RoutingPolicy
from repro_torch.routing.registry import (ActionSpace, get_action_space,
                                    get_slo_profile)
from repro_torch.serving.slo_budget import (DEFAULT_TARGETS, LatencyReservoir,
                                      SLOBudgetTracker)


def _perf_counter() -> float:
    """``time.perf_counter()``, looked up at the call."""
    return time.perf_counter()


@dataclass
class Request:
    qid: int
    question: Question
    slo: str = "quality_first"
    arrival_ms: float = 0.0
    # per-request completion-latency SLO (0 = none): stamped at arrival
    # by the open-loop AsyncGateway, measured at first token and
    # completion, and consulted by admission control (a request whose
    # deadline already passed while queued is shed, not served)
    deadline_ms: float = 0.0


@dataclass
class GatewayStats:
    served: int = 0
    # engine capacity rejections (ActionOutcome.rejected) — counted
    # apart from policy refusals so a misconfigured engine doesn't
    # masquerade as deliberate refusal behaviour
    rejected: int = 0
    # SLO-actuated admission-control counters (AsyncGateway) — each
    # actuation is tallied separately from policy refusals so the
    # control loop's interventions are auditable:
    #   shed            — rejected at the queue, never routed/served
    #   forced_refusals — policy chose to answer, burn forced refuse
    #   depth_clamped   — routed retrieval depth clamped shallower
    shed: int = 0
    forced_refusals: int = 0
    depth_clamped: int = 0
    # fault-tolerance counters — zero on a healthy run:
    #   degraded  — served, but the action's retriever was rewritten to
    #               the bm25 fallback (open breaker / retriever fault);
    #               counted apart from sheds and forced refusals so load
    #               degradation and fault degradation stay auditable
    #   timed_out — cancelled mid-stream past the request deadline
    #   retries   — transient-fault resubmissions (bounded, never past
    #               the deadline)
    #   faulted   — requests that still failed transiently after the
    #               retry budget (or with retries disabled)
    degraded: int = 0
    timed_out: int = 0
    retries: int = 0
    faulted: int = 0
    # serving-thread deaths / failed shutdown drains (AsyncGateway) —
    # the gateway has already failed by then, but the death itself must
    # be visible on a dashboard, not only as a dead thread
    fatal_errors: int = 0
    total_reward: float = 0.0
    # mirrors of the backend's shared retrieval LRU counters (0/0 when
    # the backend serves uncached) — repeated queries in a stream stop
    # re-scoring the corpus, and the hit rate shows up here
    retrieval_cache_hits: int = 0
    retrieval_cache_lookups: int = 0
    action_counts: Dict[int, int] = field(default_factory=lambda: defaultdict(int))
    refusal_cap_history: List[float] = field(default_factory=list)
    # bounded ring of recent decisions (O(1) trim in long runs)
    decisions: Deque[RoutingDecision] = field(
        default_factory=lambda: deque(maxlen=256))
    # bounded reservoir of per-request completion latencies — the one
    # home for serving percentiles (p50/p95/p99), O(capacity) forever
    latency: LatencyReservoir = field(default_factory=LatencyReservoir)

    @property
    def avg_reward(self) -> float:
        return self.total_reward / max(self.served, 1)

    def latency_percentiles(self) -> Dict[str, float]:
        """p50/p95/p99 (+ mean/max) over the recorded latencies."""
        return self.latency.percentiles()


class Gateway:
    """Queue → route → execute → account, for any policy × backend."""

    def __init__(self, policy: RoutingPolicy, backend: GenerationBackend, *,
                 router_cfg: Optional[RouterConfig] = None, index=None,
                 state_fn: Optional[Callable[[Sequence[Question]], np.ndarray]] = None,
                 action_space: Optional[ActionSpace] = None,
                 max_batch: int = 16, adaptive_refusal: bool = True,
                 base_refusal_share: float = 0.6, budget_targets=None,
                 on_outcome: Optional[Callable] = None, retry=None,
                 sleep: Optional[Callable[[float], None]] = None,
                 clock: Optional[Callable[[], float]] = None,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.policy = policy
        self.backend = as_backend(backend)
        # injectable clock for per-request latency spans (perf_counter
        # default: monotonic, immune to NTP steps); the AsyncGateway
        # passes its virtual/real clock through here so closed- and
        # open-loop timing share one domain.  When the backend serves on
        # a mesh, every rank reads rank 0's clock (``self.clock``), since
        # latencies feed the budgets and so the routed actions;
        # ``local_clock`` is this rank's own, for stamps no rank decides
        # on.  In a world of one, and off a mesh, the two are one.
        self.local_clock = clock if clock is not None else time.perf_counter
        mesh = getattr(self.backend, "mesh", None)
        self.clock = (self.local_clock if mesh is None
                      else mesh.agreed_clock(self.local_clock))
        # the retry budget's clock: the host's perf_counter, as the
        # reference reads it, but rank 0's on a mesh
        self._retry_clock = (_perf_counter if mesh is None
                             else mesh.agreed_clock(_perf_counter))
        # telemetry plane: a no-op tracer keeps the hot path branchless
        # and allocation-free when tracing is off (see repro_torch.obs.trace)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # bounded deadline-aware resubmission of transient-fault
        # outcomes (a repro_torch.serving.faults.RetryPolicy; None
        # disables — the closed-loop default, keeping pre-fault
        # behaviour bit-identical).  `sleep` is the backoff sleeper
        # (injectable for virtual-time tests).
        self.retry = retry
        self._sleep = sleep if sleep is not None else time.sleep
        self.space = action_space or get_action_space()
        if state_fn is None:
            index = index if index is not None else getattr(self.backend,
                                                            "index", None)
            if index is None or router_cfg is None:
                raise ValueError(
                    "Gateway needs state_fn, or index+router_cfg to build "
                    "the default state_vector featurizer")
            state_fn = lambda qs: np.stack(
                [state_vector(q.text, index, router_cfg) for q in qs])
        self.state_fn = state_fn
        self.max_batch = max_batch
        self.adaptive = adaptive_refusal
        self.base_share = base_refusal_share
        self.budget = SLOBudgetTracker(budget_targets or DEFAULT_TARGETS)
        # observability hook: called with (request, action, outcome, reward)
        # after every served request — replaces hand-rolled serve loops in
        # examples/drivers that only wanted per-request reporting
        self.on_outcome = on_outcome
        self.stats = GatewayStats()
        self.queue: List[Request] = []
        # hand the tracer to layers below the gateway (backend retrieval
        # spans, engine prefill/decode-chunk spans)
        install = getattr(self.backend, "install_tracer", None)
        if install is not None and self.tracer.enabled:
            install(self.tracer)
        self.metrics = metrics
        self._lat_hist = None
        if metrics is not None:
            self._bind_metrics(metrics)

    def _bind_metrics(self, reg: MetricsRegistry) -> None:
        """Register this gateway's stat blocks as scrape-time views over
        one shared registry (GatewayStats, engine stats, page pool,
        breakers, retrieval cache)."""
        self._lat_hist = reg.histogram(
            "gateway_request_latency_ms",
            "end-to-end per-request latency (ms)")
        fields = ("served", "rejected", "shed", "forced_refusals",
                  "depth_clamped", "degraded", "timed_out", "retries",
                  "faulted", "fatal_errors")
        counters = {f: reg.counter(f"gateway_{f}_total") for f in fields}
        reward_g = reg.gauge("gateway_avg_reward",
                             "mean reward over served requests")
        cap_g = reg.gauge("gateway_refusal_cap",
                          "latest budget-actuated refusal cap")
        queue_g = reg.gauge("gateway_queue_depth",
                            "requests waiting in the submit queue")

        def scrape() -> None:
            st = self.stats
            for f, inst in counters.items():
                inst.set_total(getattr(st, f))
            reward_g.set(st.avg_reward)
            if st.refusal_cap_history:
                cap_g.set(st.refusal_cap_history[-1])
            queue_g.set(len(self.queue))

        reg.register_collector(scrape)
        bind = getattr(self.backend, "bind_metrics", None)
        if bind is not None:
            bind(reg)

    # ------------------------------------------------------------------
    def submit(self, reqs: Sequence[Request]) -> None:
        self.queue.extend(reqs)

    def _route(self, batch: List[Request]):
        states = self.state_fn([r.question for r in batch])
        cap = None
        if self.adaptive:
            cap = self.budget.refusal_cap_adjustment(self.base_share)
        ctx = RoutingContext(refusal_cap=cap, action_space=self.space)
        slos = [r.slo for r in batch]
        return self.policy.route(states, slos, ctx), cap

    def _account(self, r: Request, a: int, out, lat_ms: float) -> None:
        """Reward + error-budget bookkeeping for one served request."""
        action = self.space[a]
        profile = get_slo_profile(r.slo)
        rew = reward(profile, correct=out.correct,
                     cost_tokens=out.cost_tokens,
                     hallucinated=out.hallucinated,
                     refused=out.refused,
                     answerable=out.answerable,
                     pre_retrieval=(a == self.space.refuse_action))
        outcome = RequestOutcome(
            qid=r.qid, action=a, correct=out.correct,
            refused=out.refused, hallucinated=out.hallucinated,
            cost_tokens=out.cost_tokens,
            answerable=out.answerable, latency_ms=lat_ms)
        self.budget.record(outcome)
        self.stats.served += 1
        self.stats.latency.record(lat_ms)
        if self._lat_hist is not None:
            self._lat_hist.observe(lat_ms)
        if getattr(out, "rejected", False):
            self.stats.rejected += 1
        if getattr(out, "degraded", False):
            self.stats.degraded += 1
        if getattr(out, "timed_out", False):
            self.stats.timed_out += 1
        elif getattr(out, "transient", False):
            self.stats.faulted += 1
        self.stats.total_reward += rew
        self.stats.action_counts[a] += 1
        if self.on_outcome is not None:
            self.on_outcome(r, action, out, rew)

    def _sync_cache_stats(self) -> None:
        cache = getattr(self.backend, "retrieval_cache", None)
        if cache is not None:
            self.stats.retrieval_cache_hits = cache.hits
            self.stats.retrieval_cache_lookups = cache.lookups

    def _retry_transients(self, batch: List[Request], acts: List[int],
                          outs: List, execute) -> List:
        """Closed-loop bounded retries: re-execute the transient-fault
        subset of a served micro-batch (with backoff), never past a
        request's ``deadline_ms`` budget.  ``execute(questions,
        actions)`` runs the subset; healthy outcomes are kept as-is.
        The deadline test reads the host's perf_counter, as the
        reference's does, not the injected clock; on a mesh it reads
        rank 0's perf_counter, so every rank retries the same subset."""
        if self.retry is None or self.retry.max_retries <= 0:
            return outs
        t0 = self._retry_clock()
        for attempt in range(self.retry.max_retries):
            idxs = [i for i, o in enumerate(outs)
                    if getattr(o, "transient", False)
                    and not getattr(o, "timed_out", False)]
            if not idxs:
                break
            wait = self.retry.backoff(attempt)
            elig = []
            for i in idxs:
                dl = batch[i].deadline_ms
                if dl > 0 and (self._retry_clock() - t0 + wait) * 1e3 >= dl:
                    continue     # cannot finish inside the deadline
                elig.append(i)
            if not elig:
                break
            if wait > 0:
                self._sleep(wait)
            self.stats.retries += len(elig)
            redo = execute([batch[i].question for i in elig],
                           [self.space[acts[i]] for i in elig])
            for i, o in zip(elig, redo):
                outs[i] = o
        return outs

    def _finish_trace(self, r: Request, out, t_disp: float,
                      t_done: float) -> None:
        """Mark engine-stamped stages + close one request's span tree.
        ``admitted_at``/``finished_at`` are engine-clock stamps; when
        the engine shares the gateway clock (the default) they slice
        dispatch→done into prefill/decode/harvest, otherwise they are
        clamped into the dispatch window rather than trusted."""
        tr = self.tracer
        fin = getattr(out, "finished_at", 0.0)
        adm = getattr(out, "admitted_at", 0.0)
        fin = fin if t_disp < fin <= t_done else t_done
        adm = min(max(adm, t_disp), fin)
        tr.mark(r.qid, "prefill", t_disp, adm)
        tr.mark(r.qid, "decode", adm, fin)
        tr.mark(r.qid, "harvest", fin, t_done)
        if getattr(out, "timed_out", False):
            kind = "timed_out"
        elif getattr(out, "transient", False):
            kind = "faulted"
        else:
            kind = "completed"
        tr.finish_request(r.qid, kind, t=t_done,
                          cost_tokens=out.cost_tokens)

    def step(self) -> Optional[GatewayStats]:
        """Serve one micro-batch off the queue."""
        if not self.queue:
            return None
        batch, self.queue = self.queue[: self.max_batch], \
            self.queue[self.max_batch:]
        tr = self.tracer
        t_pop = tr.now()
        decision, cap = self._route(batch)
        # only log the cap when the policy actually enforced it — a
        # logit-less policy (e.g. FixedPolicy) cannot demote refusals,
        # and the history must not claim back-pressure that was a no-op
        if cap is not None and "refusal_cap" in decision.constraints:
            self.stats.refusal_cap_history.append(cap)
        self.stats.decisions.append(decision)

        if hasattr(self.backend, "execute_mixed"):
            # continuous backend: the whole routed micro-batch — every
            # action bucket — feeds one shared in-flight decode stream.
            acts = [int(a) for a in decision.actions]
            # self.clock defaults to perf_counter: monotonic — wall
            # clock can step backwards under NTP adjustment and produce
            # negative latency_ms
            t_disp = self.clock()
            if tr.enabled:
                for r in batch:
                    tr.begin_request(r.qid, t_pop)
                    tr.mark(r.qid, "queue_wait", t_pop, t_pop)
                    tr.mark(r.qid, "admission", t_pop, t_disp)
            outs = self.backend.execute_mixed(
                [r.question for r in batch],
                [self.space[a] for a in acts])
            outs = self._retry_transients(batch, acts, outs,
                                          self.backend.execute_mixed)
            t_done = self.clock()
            # retrieval notes from batched _prep calls interleave across
            # the micro-batch and cannot be attributed per-request here
            # (the streaming path adopts them per submit)
            tr.discard_pending()
            wall_ms = (t_done - t_disp) * 1e3
            for r, a, out in zip(batch, acts, outs):
                # true per-request completion span when the engine
                # stamped one (dispatch → finished_at); full batch wall
                # otherwise — never the old wall/len smear, which under-
                # reported every request in a slow micro-batch
                fin = getattr(out, "finished_at", 0.0)
                lat_ms = ((fin - t_disp) * 1e3
                          if t_disp < fin <= t_done else wall_ms)
                if tr.enabled:
                    self._finish_trace(r, out, t_disp, t_done)
                self._account(r, a, out, lat_ms)
            self._sync_cache_stats()
            return self.stats

        # bucket by action so each retrieval depth / generation mode
        # runs as one batched backend call (serial across buckets)
        buckets: Dict[int, List[int]] = defaultdict(list)
        for i, a in enumerate(decision.actions):
            buckets[int(a)].append(i)

        for a, idxs in sorted(buckets.items()):
            action = self.space[a]
            t_disp = self.clock()
            outs = self.backend.execute_batch(
                [batch[i].question for i in idxs], action)
            if self.retry is not None:
                outs = self._retry_transients(
                    [batch[i] for i in idxs], [a] * len(idxs), outs,
                    lambda qs, actions: self.backend.execute_batch(
                        qs, actions[0]))
            t_done = self.clock()
            tr.discard_pending()
            # each request in the bucket experienced the full bucket
            # call, so it gets the full wall — not wall/len
            wall_ms = (t_done - t_disp) * 1e3
            for i, out in zip(idxs, outs):
                r = batch[i]
                if tr.enabled:
                    tr.begin_request(r.qid, t_pop)
                    tr.mark(r.qid, "queue_wait", t_pop, t_pop)
                    tr.mark(r.qid, "admission", t_pop, t_disp)
                    self._finish_trace(r, out, t_disp, t_done)
                self._account(r, a, out, wall_ms)
        self._sync_cache_stats()
        return self.stats

    def drain(self) -> GatewayStats:
        while self.queue:
            self.step()
        return self.stats

    def serve(self, reqs: Sequence[Request]) -> GatewayStats:
        """Convenience: submit + drain."""
        self.submit(reqs)
        return self.drain()

    @property
    def engine_stats(self):
        """The backend engine's serving counters (or None for backends
        without an engine, e.g. the simulator) — decode chunks,
        prefills, slot concurrency; what serve drivers print alongside
        routing stats."""
        engine = getattr(self.backend, "engine", None)
        return getattr(engine, "stats", None)

    @property
    def refusal_share(self) -> float:
        ref = self.space.refuse_action
        if ref is None:
            return 0.0
        return self.stats.action_counts.get(ref, 0) / max(self.stats.served, 1)
