"""RPL001 clock-discipline: no wall-clock calls outside the seam.

The serving plane is virtual-time-replayable end to end: every
latency-bearing component (Gateway, AsyncGateway, ContinuousEngine,
ChaosInjector, CircuitBreaker) takes an injectable ``clock``/``sleep``
and the traffic harness replays seeded runs bit-for-bit on a
``VirtualClock``.  A stray ``time.time()`` breaks replay *and* measures
the wrong thing — wall time jumps under NTP step/slew, so latency
accounting must be ``time.perf_counter()``, as the Gateway times it.

Flagged: *calls* to ``time.time``, ``time.sleep``, ``datetime.now``,
``datetime.utcnow``, ``datetime.today``.  Referencing ``time.sleep``
without calling it (e.g. as an injectable default:
``self._sleep = sleep or time.sleep``) is the seam itself and is fine;
``time.perf_counter`` / ``time.monotonic`` are always fine.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.base import Finding, Rule
from repro_torch.analysis.walker import dotted_name, qualified

_BANNED = {
    "time.time": "wall-clock timestamp",
    "time.time_ns": "wall-clock timestamp",
    "time.sleep": "wall-clock sleep",
    "datetime.datetime.now": "wall-clock timestamp",
    "datetime.datetime.utcnow": "wall-clock timestamp",
    "datetime.datetime.today": "wall-clock timestamp",
    "datetime.date.today": "wall-clock timestamp",
}


class ClockDisciplineRule(Rule):
    id = "RPL001"
    name = "clock-discipline"
    summary = ("wall-clock time.time()/time.sleep()/datetime.now() call "
               "outside the injectable-clock seam")

    def check(self, ctx) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = qualified(dotted_name(node.func), ctx.imports)
            # `from datetime import datetime; datetime.now()` resolves
            # to datetime.datetime.now via the import table; a bare
            # `datetime.now()` on `import datetime` does not exist, so
            # both spellings land on the qualified key.
            what = _BANNED.get(name)
            if what is None:
                continue
            fix = ("time.perf_counter() for intervals, or thread the "
                   "injectable clock/sleep seam through"
                   if name.startswith("time.") else
                   "an injected clock (wall timestamps break replay)")
            yield self.finding(
                ctx, node,
                f"{what} `{name}()` — use {fix}")
