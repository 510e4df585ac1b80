"""RPL006 exception-hygiene: no silently swallowed broad catches.

The fault-tolerance plane is built on exceptions carrying
semantic weight: ``core.errors`` defines the taxonomy
(``TransientFaultError`` retries, ``FaultTimeoutError`` charges the
deadline, ``CircuitOpenError`` sheds), the gateway's retry/quarantine
logic dispatches on it, and every SLO metric downstream of a swallowed
exception silently under-counts failures.  A bare ``except Exception:
pass``-shaped handler in serving/retrieval turns a failing dependency
into invisible wrong answers — the worst failure mode a measurement
paper's codebase can have.

A broad handler (``except Exception``/``BaseException``/bare
``except:``) is compliant when its body does at least one of:

* **re-raise** — ``raise`` / ``raise X from exc`` (mapping into the
  ``core.errors`` taxonomy is a raise, so it's covered);
* **count it** — an ``AugAssign`` onto an attribute (the
  ``self.stats.<counter> += 1`` idiom) so dashboards see the loss;
* **record it** — a call whose name starts with ``record`` or routes
  through a ``.stats``/``.metrics`` object.

Narrow catches (``except KeyError``) are out of scope — catching a
specific exception is a statement of intent.  Intentional swallows
(e.g. best-effort cleanup on shutdown) get an inline
``# repro: allow[RPL006] <why>``.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.base import Finding, Rule
from repro_torch.analysis.walker import dotted_name

_BROAD = {"Exception", "BaseException"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True                       # bare `except:`
    if isinstance(t, ast.Tuple):
        return any((dotted_name(e) or "").rsplit(".", 1)[-1] in _BROAD
                   for e in t.elts)
    return (dotted_name(t) or "").rsplit(".", 1)[-1] in _BROAD


def _is_compliant(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.AugAssign) and isinstance(
                node.target, ast.Attribute):
            return True
        if isinstance(node, ast.Call):
            d = dotted_name(node.func) or ""
            leaf = d.rsplit(".", 1)[-1]
            if leaf.startswith("record") or ".stats." in d \
                    or ".metrics." in d:
                return True
    return False


class ExceptionHygieneRule(Rule):
    id = "RPL006"
    name = "exception-hygiene"
    summary = ("broad `except Exception` that neither re-raises, maps "
               "into core.errors, nor increments a stats counter")

    def check(self, ctx) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _is_broad(node) or _is_compliant(node):
                continue
            yield self.finding(
                ctx, node,
                "broad exception handler swallows the failure — "
                "re-raise, map it into the core.errors taxonomy, or "
                "increment a stats counter so SLO accounting sees it")
