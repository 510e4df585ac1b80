"""Typed metrics registry with Prometheus-style exposition.

One ``MetricsRegistry`` is shared across the serving stack so the
formerly disconnected stat blocks (``GatewayStats``, ``EngineStats``,
``PagePool`` occupancy, breaker trip counts, chaos fire counts) become
views over a single exportable surface.  Two usage modes:

* **Direct instruments** — ``registry.counter(...)``, ``.gauge(...)``,
  ``.histogram(...)`` hand back mutable instruments updated on the hot
  path (e.g. per-request latency histograms).
* **Collectors** — ``registry.register_collector(fn)`` registers a
  callback run at scrape time (``collect()``).  The hot path keeps
  mutating its cheap dataclass counters; the callback copies them into
  gauges only when someone actually asks for an exposition/snapshot.
  This is the standard Prometheus client pattern and keeps the
  instrumented loops allocation-free.

Stdlib-only by design: the linter's ``static-analysis`` CI job runs
reprolint with no third-party installs, and reprolint imports nothing
from here — but tests for this module must run everywhere.
"""
from __future__ import annotations

import json
import math
import re
from bisect import bisect_left
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")

# Default latency-ish bucket upper bounds (ms).  Callers can pass their
# own; merge() requires identical bounds.
DEFAULT_BUCKETS_MS: Tuple[float, ...] = (
    1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
    1000.0, 2000.0, 5000.0)


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(
            f"metric name {name!r} is not lowercase_snake "
            f"(must match {_NAME_RE.pattern})")
    return name


class Counter:
    """Monotonic counter.  ``set_total`` exists for collector views that
    mirror an externally-maintained running total at scrape time."""

    __slots__ = ("name", "help", "value")
    kind = "counter"

    def __init__(self, name: str, help_text: str = "") -> None:
        self.name = _check_name(name)
        self.help = help_text
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def set_total(self, total: float) -> None:
        self.value = float(total)

    def sample_lines(self, prefix: str) -> List[str]:
        return [f"{prefix}{self.name} {_fmt(self.value)}"]

    def as_dict(self) -> Dict[str, float]:
        return {"value": self.value}


class Gauge:
    """Point-in-time value (occupancy, share, queue depth)."""

    __slots__ = ("name", "help", "value")
    kind = "gauge"

    def __init__(self, name: str, help_text: str = "") -> None:
        self.name = _check_name(name)
        self.help = help_text
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def sample_lines(self, prefix: str) -> List[str]:
        return [f"{prefix}{self.name} {_fmt(self.value)}"]

    def as_dict(self) -> Dict[str, float]:
        return {"value": self.value}


class Histogram:
    """Fixed-bucket histogram with cumulative Prometheus exposition.

    Bucket ``i`` counts observations ``<= bounds[i]``; an implicit
    ``+Inf`` bucket catches the tail.  ``merge`` is associative and
    commutative over histograms with identical bounds, so shards can be
    combined in any grouping (exercised by the registry tests).
    """

    __slots__ = ("name", "help", "bounds", "counts", "inf_count",
                 "total", "count")
    kind = "histogram"

    def __init__(self, name: str, help_text: str = "",
                 bounds: Sequence[float] = DEFAULT_BUCKETS_MS) -> None:
        self.name = _check_name(name)
        self.help = help_text
        bounds = tuple(float(b) for b in bounds)
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"histogram bounds must be strictly "
                             f"increasing: {bounds}")
        self.bounds = bounds
        self.counts = [0] * len(bounds)
        self.inf_count = 0
        self.total = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        i = bisect_left(self.bounds, value)
        if i < len(self.counts):
            self.counts[i] += 1
        else:
            self.inf_count += 1
        self.total += value
        self.count += 1

    def merge(self, other: "Histogram") -> "Histogram":
        """Return a NEW histogram with summed buckets (inputs unchanged)."""
        if self.bounds != other.bounds:
            raise ValueError(
                f"cannot merge histograms with different bounds: "
                f"{self.bounds} vs {other.bounds}")
        out = Histogram(self.name, self.help, self.bounds)
        out.counts = [a + b for a, b in zip(self.counts, other.counts)]
        out.inf_count = self.inf_count + other.inf_count
        out.total = self.total + other.total
        out.count = self.count + other.count
        return out

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile; nan when empty."""
        if self.count == 0:
            return math.nan
        target = q * self.count
        seen = 0
        lo = 0.0
        for ub, c in zip(self.bounds, self.counts):
            if seen + c >= target and c > 0:
                frac = (target - seen) / c
                return lo + frac * (ub - lo)
            seen += c
            lo = ub
        return self.bounds[-1] if self.bounds else math.nan

    def sample_lines(self, prefix: str) -> List[str]:
        lines = []
        cum = 0
        for ub, c in zip(self.bounds, self.counts):
            cum += c
            lines.append(f'{prefix}{self.name}_bucket{{le="{_fmt(ub)}"}} '
                         f"{cum}")
        cum += self.inf_count
        lines.append(f'{prefix}{self.name}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{prefix}{self.name}_sum {_fmt(self.total)}")
        lines.append(f"{prefix}{self.name}_count {self.count}")
        return lines

    def as_dict(self) -> Dict[str, object]:
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "inf_count": self.inf_count, "sum": self.total,
                "count": self.count}


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


class MetricsRegistry:
    """Namespace of uniquely-named instruments plus scrape collectors.

    The clock is a required constructor argument (injectable, RPL007):
    snapshots stamp ``clock_s`` with it, so virtual-time runs produce
    virtual-time-stamped snapshots instead of smuggling wall time in.
    """

    def __init__(self, clock: Callable[[], float], *,
                 prefix: str = "repro_") -> None:
        if not callable(clock):
            raise TypeError("MetricsRegistry requires an injectable "
                            "clock callable as its first argument")
        self.clock = clock
        self.prefix = prefix
        self._metrics: Dict[str, object] = {}
        self._collectors: List[Callable[[], None]] = []

    # -- registration -----------------------------------------------------
    def _register(self, metric):
        if metric.name in self._metrics:
            raise ValueError(
                f"metric {metric.name!r} registered twice — each name "
                f"may be registered exactly once per registry")
        self._metrics[metric.name] = metric
        return metric

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._register(Counter(name, help_text))

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._register(Gauge(name, help_text))

    def histogram(self, name: str, help_text: str = "",
                  bounds: Sequence[float] = DEFAULT_BUCKETS_MS,
                  ) -> Histogram:
        return self._register(Histogram(name, help_text, bounds))

    def get(self, name: str) -> Optional[object]:
        return self._metrics.get(name)

    def register_collector(self, fn: Callable[[], None]) -> None:
        """``fn`` runs at every scrape; it should copy externally-held
        counters into instruments via ``set_total``/``set``."""
        self._collectors.append(fn)

    # -- scrape -----------------------------------------------------------
    def collect(self) -> None:
        for fn in self._collectors:
            fn()

    def exposition(self) -> str:
        """Prometheus text exposition (# HELP / # TYPE / samples)."""
        self.collect()
        out: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            full = f"{self.prefix}{name}"
            if m.help:
                out.append(f"# HELP {full} {m.help}")
            out.append(f"# TYPE {full} {m.kind}")
            out.extend(m.sample_lines(self.prefix))
        return "\n".join(out) + "\n"

    def snapshot(self) -> Dict[str, object]:
        """JSON-ready dict of every instrument, stamped with clock_s."""
        self.collect()
        return {
            "clock_s": self.clock(),
            "metrics": {
                name: {"kind": m.kind, "help": m.help, **m.as_dict()}
                for name, m in sorted(self._metrics.items())},
        }

    def snapshot_json(self, indent: int = 2) -> str:
        return json.dumps(self.snapshot(), indent=indent)
