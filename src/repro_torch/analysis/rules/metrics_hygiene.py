"""RPL007 metric-hygiene: telemetry names and clock injection.

The telemetry plane (:mod:`repro_torch.obs`) has three invariants the
runtime enforces late (at registration / construction) that are much
cheaper to catch at lint time:

* **Names are ``lowercase_snake``.**  Prometheus exposition mangles
  anything else, and mixed-case metric families fragment dashboards.
  Checked on every literal first argument of a
  ``.counter(...)`` / ``.gauge(...)`` / ``.histogram(...)`` call.
  f-string names (``f"breaker_{name}_trips_total"``) are validated at
  runtime by the registry instead — the static rule skips them.
* **A name registers exactly once per registry.**  Two literal
  registrations of the same name on the same receiver in one scope
  would raise at runtime on the SECOND call — after the first already
  mutated the registry; the linter flags it before anything runs.
* **Every ``Tracer``/``MetricsRegistry`` construction injects a
  clock.**  A zero-arg construction would either crash (both raise
  TypeError) or — were the default ever relaxed — silently fall back
  to wall time and break virtual-time replay (the RPL001 invariant).
  ``NullTracer()`` is exempt: the no-op tracer never reads a clock.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Tuple

from repro_torch.analysis.base import Finding, Rule
from repro_torch.analysis.walker import root_name, walk_scope

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")
_BINDERS = ("counter", "gauge", "histogram")
_CLOCKED = ("Tracer", "MetricsRegistry")


def _literal_metric_call(node: ast.Call):
    """(receiver_root, name) when ``node`` is ``<recv>.counter("x", ...)``
    (or gauge/histogram) with a literal string name, else None."""
    fn = node.func
    if not (isinstance(fn, ast.Attribute) and fn.attr in _BINDERS):
        return None
    if not node.args:
        return None
    arg = node.args[0]
    if not (isinstance(arg, ast.Constant) and isinstance(arg.value, str)):
        return None
    return (root_name(fn.value) or "?", arg.value)


class MetricsHygieneRule(Rule):
    id = "RPL007"
    name = "metric-hygiene"
    summary = ("metric name not lowercase_snake, duplicate registration "
               "on one registry, or Tracer/MetricsRegistry built "
               "without an injected clock")

    def check(self, ctx) -> Iterator[Finding]:
        scopes: List[ast.AST] = [ctx.tree] + [
            n for n in ast.walk(ctx.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for scope in scopes:
            # (receiver root, name) -> first registration node, per
            # scope: different scopes usually mean different registries
            seen: Dict[Tuple[str, str], ast.AST] = {}
            for node in walk_scope(scope):
                if not isinstance(node, ast.Call):
                    continue
                lit = _literal_metric_call(node)
                if lit is not None:
                    recv, name = lit
                    if not _NAME_RE.match(name):
                        yield self.finding(
                            ctx, node,
                            f"metric name {name!r} is not "
                            f"lowercase_snake ([a-z][a-z0-9_]*) — "
                            f"Prometheus exposition requires it")
                    elif lit in seen:
                        yield self.finding(
                            ctx, node,
                            f"metric {name!r} registered twice on "
                            f"`{recv}` (first at line "
                            f"{seen[lit].lineno}) — each name may be "
                            f"registered exactly once per registry")
                    else:
                        seen[lit] = node
                # clock injection on tracer/registry construction
                fn = node.func
                ctor = (fn.id if isinstance(fn, ast.Name)
                        else fn.attr if isinstance(fn, ast.Attribute)
                        else None)
                if ctor in _CLOCKED:
                    has_clock = bool(node.args) or any(
                        kw.arg == "clock" or kw.arg is None  # **kw
                        for kw in node.keywords)
                    if not has_clock:
                        yield self.finding(
                            ctx, node,
                            f"`{ctor}()` constructed without an "
                            f"injectable clock — pass the gateway's "
                            f"clock (e.g. `{ctor}(clock.now)`) so "
                            f"telemetry replays in virtual time")
