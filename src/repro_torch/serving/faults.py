"""Deterministic chaos injection for the serving plane.

The paper's routing story is about *graceful degradation*: under
pressure the router should refuse, clamp depth, or cheapen the action
rather than fail.  The open-loop gateway
(:mod:`repro_torch.serving.streaming`) has that behaviour under *load*;
this module gives the rest of the stack the same behaviour under
*faults* — and makes every failure scenario reproducible, so the
fault-tolerance tests and the chaos benchmark are as deterministic as
the greedy decode they wrap.

* :class:`FaultSpec` / :class:`FaultPlan` — declarative fault
  schedules: each spec names a **site** (an injection seam, e.g.
  ``"retriever.dense"`` or ``"executor.decode"``), a fault **kind**,
  and an invocation window ``[start, start+count)`` of that site's
  call counter, optionally thinned by a seeded per-invocation
  probability.  Same plan + same call sequence ⇒ bit-identical faults.
* :class:`ChaosInjector` — the runtime: owns the per-site counters and
  the seeded RNG, answers ``fire(site)`` with the matching spec (or
  ``None``).  When no plan is armed the seams are **never installed**
  (the wrappers below are only constructed for an armed injector), so
  the no-fault serving path is byte-identical to pre-chaos code.
* :class:`ChaosRetriever` — wraps any retrieval-protocol object; fault
  kinds ``raise`` / ``timeout`` (both surface as transient errors the
  circuit breaker records) and ``latency`` (sleeps, virtual or real).
* :class:`ChaosExecutor` — wraps an executor of the
  :mod:`repro_torch.serving.executor` protocol; ``raise``/``timeout``
  on ``executor.admit`` / ``executor.decode``, ``stall`` (the decode
  chunk silently makes no progress — the scheduler's watchdog must
  catch it), and ``nan`` (marks slots poisoned via ``slot_faults`` —
  the same signal the real executors raise from device-side
  NaN/inf detection on decode logits).

Retry policy lives here too (:class:`RetryPolicy`): the gateway-level
knob for bounded, deadline-aware retries of transient faults.

Only stdlib + numpy — importable from the retrieval layer and the host
scheduler without dragging torch in.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# Canonical home is repro_torch.core.errors (shared with the retrieval
# layer without a serving<->retrieval import cycle); re-exported here
# because this module is the chaos API surface.
from repro_torch.core.errors import (CircuitOpenError, FaultError,
                               FaultTimeoutError, TransientFaultError)

FAULT_KINDS = ("raise", "timeout", "latency", "nan", "stall")


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: *what* happens *where*, and *when*.

    ``site`` is matched exactly against the seam's ``fire`` site
    string.  The fault is eligible on invocations ``start <= n <
    start + count`` of that site's counter (``count=-1`` = open-ended),
    and actually fires with probability ``prob`` (seeded draw in the
    injector, taken only on eligible invocations — so the schedule is
    replayable)."""

    site: str
    kind: str                       # one of FAULT_KINDS
    start: int = 0
    count: int = 1                  # -1 = every invocation from start
    prob: float = 1.0
    latency_s: float = 0.0          # for kind == "latency"
    slots: Optional[Tuple[int, ...]] = None   # for kind == "nan"
    message: str = ""

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; one of {FAULT_KINDS}")
        if self.count == 0 or self.count < -1:
            raise ValueError(f"count must be >= 1 or -1, got {self.count}")
        if not (0.0 < self.prob <= 1.0):
            raise ValueError(f"prob must be in (0, 1], got {self.prob}")

    def eligible(self, n: int) -> bool:
        if n < self.start:
            return False
        return self.count == -1 or n < self.start + self.count


@dataclass(frozen=True)
class FaultPlan:
    """A seeded set of fault specs — the unit the chaos bench and the
    chaos tests are parameterised by."""

    specs: Tuple[FaultSpec, ...] = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "specs", tuple(self.specs))


class ChaosInjector:
    """Deterministic fault scheduler over a :class:`FaultPlan`.

    ``fire(site)`` increments the site's invocation counter and returns
    the first spec whose window covers this invocation (and whose
    seeded coin came up), else ``None``.  ``clock`` (optional,
    ``perf_counter``-style) timestamps ``fire_log`` rows so benches can
    measure recovery time; ``sleep`` (optional, defaults to
    ``time.sleep``) is what ``latency`` faults call — pass a
    :class:`~repro_torch.serving.traffic.VirtualClock`'s ``advance`` for
    virtual-time chaos runs.
    """

    def __init__(self, plan: Optional[FaultPlan] = None, *,
                 clock: Optional[Callable[[], float]] = None,
                 sleep: Optional[Callable[[float], None]] = None):
        self.plan = plan
        self.clock = clock
        if sleep is None:
            import time
            sleep = time.sleep
        self.sleep = sleep
        self._rng = np.random.default_rng(plan.seed if plan else 0)
        self._counters: Dict[str, int] = {}
        # (site, kind, invocation_index, clock_t) per fired fault
        self.fire_log: List[Tuple[str, str, int, float]] = []

    @property
    def armed(self) -> bool:
        return self.plan is not None and len(self.plan.specs) > 0

    def calls(self, site: str) -> int:
        return self._counters.get(site, 0)

    def fire(self, site: str) -> Optional[FaultSpec]:
        if not self.armed:
            return None
        n = self._counters.get(site, 0)
        self._counters[site] = n + 1
        for spec in self.plan.specs:
            if spec.site != site or not spec.eligible(n):
                continue
            if spec.prob < 1.0 and self._rng.random() >= spec.prob:
                continue
            # a stamp for fire_log only: no decision reads it, so it
            # needs no agreement across a mesh's ranks
            t = self.clock() if self.clock is not None else 0.0
            self.fire_log.append((site, spec.kind, n, t))
            return spec
        return None

    def last_fire_t(self) -> Optional[float]:
        return self.fire_log[-1][3] if self.fire_log else None

    # -- shared kind application --------------------------------------

    def apply_error_kind(self, spec: FaultSpec, site: str) -> bool:
        """Handle the kinds every seam supports.  Raises for ``raise``/
        ``timeout``; sleeps and returns True (proceed) for ``latency``;
        returns False for kinds the caller must handle itself."""
        msg = spec.message or f"injected {spec.kind} at {site}"
        if spec.kind == "raise":
            raise TransientFaultError(msg)
        if spec.kind == "timeout":
            raise FaultTimeoutError(msg)
        if spec.kind == "latency":
            self.sleep(spec.latency_s)
            return True
        return False


# ---------------------------------------------------------------------------
# injection seams
# ---------------------------------------------------------------------------


class ChaosRetriever:
    """Fault seam around one retrieval-protocol object.  Site:
    ``retriever.<name>`` (topk and passages share the counter — one
    logical lookup, one fault opportunity)."""

    def __init__(self, inner, injector: ChaosInjector):
        self.inner = inner
        self.name = inner.name
        self.injector = injector
        self.site = f"retriever.{self.name}"

    def _maybe_fault(self) -> None:
        spec = self.injector.fire(self.site)
        if spec is None:
            return
        if not self.injector.apply_error_kind(spec, self.site):
            raise ValueError(
                f"fault kind {spec.kind!r} not supported at {self.site}")

    def topk(self, query: str, k: int):
        self._maybe_fault()
        return self.inner.topk(query, k)

    def passages(self, query: str, k: int):
        self._maybe_fault()
        return self.inner.passages(query, k)


class ChaosExecutor:
    """Fault seam around the executor protocol.

    Sites: ``executor.admit`` (``raise``/``timeout``/``latency``) and
    ``executor.decode`` (those plus ``stall`` — the chunk call is
    swallowed, so no slot makes progress and the scheduler watchdog
    must fire — and ``nan`` — the spec's slots are flagged in
    ``slot_faults``, the same poisoned-slot signal real executors
    produce from device-side NaN/inf detection)."""

    def __init__(self, inner, injector: ChaosInjector):
        self._inner = inner
        self._injector = injector
        S = inner.num_slots
        self._injected_bad = np.zeros(S, bool)

    def __getattr__(self, name):
        # everything else the engine reads from its executor (the
        # device, the page geometry, cache_allocations, ...) is the
        # wrapped executor's
        return getattr(self._inner, name)

    def admit(self, tokens, slot_idx, limits) -> None:
        spec = self._injector.fire("executor.admit")
        if spec is not None:
            self._injector.apply_error_kind(spec, "executor.admit")
        self._inner.admit(tokens, slot_idx, limits)

    def admit_paged(self, tokens, slot_idx, limits, pos0, tables,
                    write_mask, gather_src) -> None:
        # same seam/counter as admit: one admission, one fault chance
        spec = self._injector.fire("executor.admit")
        if spec is not None:
            self._injector.apply_error_kind(spec, "executor.admit")
        self._inner.admit_paged(tokens, slot_idx, limits, pos0, tables,
                                write_mask, gather_src)

    def decode_chunk(self) -> None:
        spec = self._injector.fire("executor.decode")
        if spec is not None:
            if spec.kind == "stall":
                return                    # silently no progress
            if spec.kind == "nan":
                slots = (spec.slots if spec.slots is not None
                         else range(self._inner.num_slots))
                for s in slots:
                    self._injected_bad[s] = True
                self._inner.decode_chunk()
                return
            self._injector.apply_error_kind(spec, "executor.decode")
        self._inner.decode_chunk()

    def sync_control(self):
        return self._inner.sync_control()

    def fetch_outputs(self):
        return self._inner.fetch_outputs()

    def slot_faults(self) -> Optional[np.ndarray]:
        inner = getattr(self._inner, "slot_faults", None)
        bad = self._injected_bad.copy()
        if inner is not None:
            got = inner()
            if got is not None:
                bad |= got
        return bad

    def clear_slot_faults(self, slots: Sequence[int]) -> None:
        for s in slots:
            self._injected_bad[s] = False
        inner = getattr(self._inner, "clear_slot_faults", None)
        if inner is not None:
            inner(slots)

    def deactivate(self, slots: Sequence[int]) -> None:
        inner = getattr(self._inner, "deactivate", None)
        if inner is not None:
            inner(slots)


def chaos_wrap_retrievers(retrievers: Dict[str, object],
                          injector: Optional[ChaosInjector]
                          ) -> Dict[str, object]:
    """Install retriever fault seams (innermost — inside breakers and
    the cache, so injected failures trip breakers and are never
    cached).  No-op (same dict) when the injector is unarmed."""
    if injector is None or not injector.armed:
        return dict(retrievers)
    return {name: ChaosRetriever(r, injector)
            for name, r in retrievers.items()}


# ---------------------------------------------------------------------------
# retry policy
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff for transient faults.  The gateways
    never retry past a request's deadline, and every retry is counted
    (``GatewayStats.retries``).  ``max_retries=0`` disables."""

    max_retries: int = 1
    backoff_s: float = 0.05
    multiplier: float = 2.0

    def backoff(self, attempt: int) -> float:
        """Backoff before retry number ``attempt + 1`` (0-based)."""
        return self.backoff_s * (self.multiplier ** attempt)
