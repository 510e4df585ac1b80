"""SLO latency attribution: per-request stage breakdowns.

The serving stack marks every request with a contiguous top-level stage
chain — ``queue_wait → admission → prefill → decode → harvest`` — whose
durations sum to the end-to-end latency *by construction* (each stage
ends where the next begins).  ``retrieval`` is a child interval inside
``admission`` (the gateway performs retrieval while preparing the
submit), so it attributes without double-counting.

``SLOBudgetTracker`` consumes ``RequestBreakdown`` rows so a burn-rate
report can name the dominant stage: "p99 is burning and 70% of it is
queue_wait" is actionable where a bare end-to-end reservoir is not.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Tuple

# Top-level stages are contiguous and sum to end-to-end latency.
TOP_LEVEL: Tuple[str, ...] = (
    "queue_wait", "admission", "prefill", "decode", "harvest")
# All stage names a breakdown may carry (retrieval nests in admission).
STAGES: Tuple[str, ...] = TOP_LEVEL + ("retrieval",)

# Terminal kinds a breakdown can describe.
KINDS: Tuple[str, ...] = ("completed", "shed", "timed_out", "faulted")


@dataclass(slots=True)
class RequestBreakdown:
    """Per-request latency + token-cost attribution.  Treat as
    immutable — rows are shared between the tracer's deque and the
    budget tracker's window.  (Not ``frozen=True``: hot-path
    construction cost; frozen fields init via object.__setattr__.)"""

    qid: int
    kind: str                      # one of KINDS
    e2e_ms: float
    stages: Dict[str, float]       # stage -> duration ms
    cost_tokens: float = 0.0

    @property
    def stage_sum_ms(self) -> float:
        return sum(self.stages.get(s, 0.0) for s in TOP_LEVEL)

    @property
    def dominant_stage(self) -> str:
        """Largest attributed interval.  retrieval competes directly:
        its parent (admission) is reduced by the nested retrieval time
        so one of them wins on its own merits."""
        weights = {s: self.stages.get(s, 0.0) for s in TOP_LEVEL}
        retr = self.stages.get("retrieval", 0.0)
        if retr > 0.0:
            weights["admission"] = max(
                0.0, weights.get("admission", 0.0) - retr)
            weights["retrieval"] = retr
        if not any(weights.values()):
            return "queue_wait"
        return max(weights, key=lambda s: (weights[s], s))

    def as_dict(self) -> Dict[str, object]:
        return {"qid": self.qid, "kind": self.kind,
                "e2e_ms": round(self.e2e_ms, 4),
                "stages": {k: round(v, 4)
                           for k, v in sorted(self.stages.items())},
                "cost_tokens": self.cost_tokens,
                "dominant_stage": self.dominant_stage}


@dataclass
class StageAttribution:
    """Windowed aggregate of breakdowns for burn-rate reporting."""

    window: int = 512
    _rows: Deque[RequestBreakdown] = field(default_factory=deque)

    def record(self, bd: RequestBreakdown) -> None:
        self._rows.append(bd)
        while len(self._rows) > self.window:
            self._rows.popleft()

    def __len__(self) -> int:
        return len(self._rows)

    def report(self) -> Dict[str, object]:
        """Mean per-stage ms + share of total attributed time, plus the
        stage that dominates the window (admission net of retrieval)."""
        if not self._rows:
            return {"n": 0, "dominant_stage": None,
                    "stage_ms": {}, "stage_share": {}}
        sums: Dict[str, float] = {s: 0.0 for s in STAGES}
        for bd in self._rows:
            for s in STAGES:
                sums[s] += bd.stages.get(s, 0.0)
        n = len(self._rows)
        retr = sums["retrieval"]
        weights = {s: sums[s] for s in TOP_LEVEL}
        weights["admission"] = max(0.0, weights["admission"] - retr)
        weights["retrieval"] = retr
        total = sum(weights.values()) or 1.0
        dominant = max(weights, key=lambda s: (weights[s], s))
        return {
            "n": n,
            "dominant_stage": dominant,
            "stage_ms": {s: round(sums[s] / n, 4) for s in STAGES
                         if sums[s] > 0.0},
            "stage_share": {s: round(w / total, 4)
                            for s, w in weights.items() if w > 0.0},
        }
