"""SLO compliance tracking with SRE-style error budgets.

The paper frames routing against service-level *objectives* and cites
Beyer et al.'s SRE book; this module closes that loop operationally:
each SLO becomes a target + window + error budget, the serving layer
records per-request outcomes, and the budget state can drive the router
(e.g. tighten the refusal cap when the refusal budget burns hot).

:class:`repro_torch.routing.gateway.Gateway` owns a tracker instance
and threads ``refusal_cap_adjustment`` into every
``RoutingPolicy.route`` call as the batch's refusal cap (closed-loop
back-pressure).  The short-window **burn rate**
(:meth:`SLOBudgetTracker.burn_rate`) is the signal open-loop admission
control actuates on.

:class:`LatencyReservoir` lives here too: the bounded reservoir sample
behind ``GatewayStats`` latency percentiles (p50/p95/p99), shared by
the serving benchmarks instead of per-bench percentile math.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.core.serving_types import RequestOutcome
from repro_torch.obs.attribution import RequestBreakdown, StageAttribution

# ``refusal_cap_adjustment`` shape constants (previously inline magic
# numbers) — overridable per tracker:
#   burn <= KNEE            : cap untouched
#   KNEE < burn <= CLIP     : cap scaled by (1 - SLOPE * (burn - KNEE))
#   burn clipped at CLIP, and the cap never drops below FLOOR.
REFUSAL_CAP_FLOOR = 0.05
BURN_KNEE = 0.5
BURN_SLOPE = 0.5
BURN_CLIP = 2.0

# default short window (requests) for burn-rate actuation signals — a
# fraction of the budget window so admission control reacts to the
# last few micro-batches, not the whole sliding history
DEFAULT_BURN_WINDOW = 64


@dataclass(frozen=True)
class SLOTarget:
    name: str
    metric: str              # refusal | hallucination | cost_tokens | error | latency
    threshold: float         # per-request bad-event definition for costs
    objective: float         # e.g. 0.95 = "≤5% of requests may violate"
    window: int = 500        # sliding window (requests)

    @property
    def error_budget(self) -> float:
        return 1.0 - self.objective


@dataclass(frozen=True)
class BudgetReport:
    """One target's budget state — a typed row, not a loosely-typed
    dict mixing bools into float values."""

    name: str
    violation_rate: float
    budget_consumed: float   # >1 = SLO breached
    burn_rate: float         # short-window budget_consumed (actuation signal)
    window_n: int            # events currently in the sliding window
    healthy: bool

    def as_dict(self) -> Dict[str, object]:
        """JSON-ready row (drivers print these)."""
        return {"violation_rate": round(self.violation_rate, 4),
                "budget_consumed": round(self.budget_consumed, 3),
                "burn_rate": round(self.burn_rate, 3),
                "window_n": self.window_n,
                "healthy": self.healthy}


@dataclass
class BudgetState:
    target: SLOTarget
    events: Deque[bool] = field(default_factory=deque)  # True = violation

    def record(self, outcome: RequestOutcome) -> None:
        m = self.target.metric
        if m == "refusal":
            bad = outcome.refused and outcome.answerable
        elif m == "hallucination":
            bad = outcome.hallucinated
        elif m == "cost_tokens":
            bad = outcome.cost_tokens > self.target.threshold
        elif m == "error":
            bad = (not outcome.correct) and (not outcome.refused)
        elif m == "latency":
            bad = outcome.latency_ms > self.target.threshold
        else:
            raise ValueError(m)
        self.events.append(bool(bad))
        while len(self.events) > self.target.window:
            self.events.popleft()

    @property
    def violation_rate(self) -> float:
        return (sum(self.events) / len(self.events)) if self.events else 0.0

    @property
    def budget_consumed(self) -> float:
        """Fraction of the error budget burned (>1 = SLO breached)."""
        eb = self.target.error_budget
        return self.violation_rate / eb if eb > 0 else float("inf")

    def burn_rate(self, window: int = DEFAULT_BURN_WINDOW) -> float:
        """Budget consumption over only the most recent ``window``
        events — the fast signal admission control actuates on.  0.0
        with an empty window (no traffic = no burn)."""
        if not self.events or window <= 0:
            return 0.0
        recent = list(self.events)[-window:]
        rate = sum(recent) / len(recent)
        eb = self.target.error_budget
        return rate / eb if eb > 0 else float("inf")

    @property
    def healthy(self) -> bool:
        return self.budget_consumed <= 1.0


class SLOBudgetTracker:
    """Tracks several targets; exposes router back-pressure signals.

    The refusal-cap shape constants are configurable (defaults are the
    module-level named constants, previously inline literals)."""

    def __init__(self, targets: List[SLOTarget], *,
                 burn_window: int = DEFAULT_BURN_WINDOW,
                 refusal_cap_floor: float = REFUSAL_CAP_FLOOR,
                 burn_knee: float = BURN_KNEE,
                 burn_slope: float = BURN_SLOPE,
                 burn_clip: float = BURN_CLIP):
        self.states: Dict[str, BudgetState] = {
            t.name: BudgetState(t) for t in targets}
        self.burn_window = burn_window
        self.refusal_cap_floor = refusal_cap_floor
        self.burn_knee = burn_knee
        self.burn_slope = burn_slope
        self.burn_clip = burn_clip
        # windowed per-stage latency attribution (fed by the tracer):
        # lets a burn-rate report say WHERE the latency went, not only
        # that the budget burned
        self.attribution = StageAttribution()

    def record(self, outcome: RequestOutcome) -> None:
        for s in self.states.values():
            s.record(outcome)

    def record_breakdown(self, bd: Optional[RequestBreakdown]) -> None:
        """Attach one request's per-stage breakdown (None-safe: the
        disabled tracer produces no breakdowns)."""
        if bd is not None:
            self.attribution.record(bd)

    def report(self) -> Dict[str, BudgetReport]:
        return {name: BudgetReport(
                    name=name,
                    violation_rate=s.violation_rate,
                    budget_consumed=s.budget_consumed,
                    burn_rate=s.burn_rate(self.burn_window),
                    window_n=len(s.events),
                    healthy=s.healthy)
                for name, s in self.states.items()}

    def report_dict(self) -> Dict[str, Dict[str, object]]:
        """JSON-serializable form of :meth:`report`, plus the windowed
        latency attribution (which stage dominates recent requests)
        when any breakdowns have been recorded."""
        out = {name: rep.as_dict() for name, rep in self.report().items()}
        if len(self.attribution):
            out["latency_attribution"] = self.attribution.report()
        return out

    def burn_rate(self, name: str, window: Optional[int] = None) -> float:
        """Short-window burn for one target (0.0 if untracked)."""
        s = self.states.get(name)
        if s is None:
            return 0.0
        return s.burn_rate(self.burn_window if window is None else window)

    def refusal_cap_adjustment(self, base_cap: float) -> float:
        """Back-pressure hook: tighten the policy's refusal cap as the
        wrong-refusal budget burns (the §7.1 mitigation made adaptive).
        Piecewise-linear in the clipped burn; monotonically
        non-increasing in burn, floored at ``refusal_cap_floor``."""
        s = self.states.get("refusal")
        if s is None or not s.events:
            return base_cap
        burn = min(s.budget_consumed, self.burn_clip)
        scale = 1.0 - self.burn_slope * max(0.0, burn - self.burn_knee)
        return max(self.refusal_cap_floor, base_cap * scale)


def latency_target(deadline_ms: float, *, objective: float = 0.90,
                   window: int = 500) -> SLOTarget:
    """A per-request completion-latency SLO: at most ``1 - objective``
    of requests may finish later than ``deadline_ms``."""
    return SLOTarget("latency", "latency", float(deadline_ms),
                     objective=objective, window=window)


DEFAULT_TARGETS = [
    SLOTarget("refusal", "refusal", 0.0, objective=0.90),
    SLOTarget("hallucination", "hallucination", 0.0, objective=0.70),
    SLOTarget("cost", "cost_tokens", 800.0, objective=0.95),
    SLOTarget("error", "error", 0.0, objective=0.60),
]


class LatencyReservoir:
    """Bounded uniform reservoir of latency samples (Vitter algorithm
    R, seeded — deterministic for a given insert sequence).

    Keeps percentile estimates O(capacity) in arbitrarily long serving
    runs; below capacity it is exact.  This is the one home for the
    p50/p95/p99 math that used to be re-derived ad hoc per benchmark.
    """

    __slots__ = ("capacity", "count", "_samples", "_rng")

    def __init__(self, capacity: int = 2048, seed: int = 0):
        self.capacity = int(capacity)
        self.count = 0
        self._samples: List[float] = []
        self._rng = np.random.default_rng(seed)

    def record(self, value_ms: float) -> None:
        self.count += 1
        if len(self._samples) < self.capacity:
            self._samples.append(float(value_ms))
            return
        j = int(self._rng.integers(0, self.count))
        if j < self.capacity:
            self._samples[j] = float(value_ms)

    def extend(self, values_ms) -> None:
        for v in values_ms:
            self.record(float(v))

    def __len__(self) -> int:
        return len(self._samples)

    def percentile(self, p: float) -> float:
        if not self._samples:
            return float("nan")
        return float(np.percentile(self._samples, p))

    def percentiles(self) -> Dict[str, float]:
        """The standard serving latency row: p50/p95/p99 (+ mean/max)."""
        if not self._samples:
            return {"n": 0, "mean_ms": float("nan"), "p50_ms": float("nan"),
                    "p95_ms": float("nan"), "p99_ms": float("nan"),
                    "max_ms": float("nan")}
        arr = np.asarray(self._samples)
        return {"n": self.count,
                "mean_ms": round(float(arr.mean()), 2),
                "p50_ms": round(float(np.percentile(arr, 50)), 2),
                "p95_ms": round(float(np.percentile(arr, 95)), 2),
                "p99_ms": round(float(np.percentile(arr, 99)), 2),
                "max_ms": round(float(arr.max()), 2)}
