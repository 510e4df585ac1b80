"""RPL005 thread-shared-state: cross-thread attribute writes hold the lock.

The AsyncGateway runs its decode loop on a background
``threading.Thread`` while public methods (``submit``/``cancel``/
``stop``/``snapshot``) mutate the same object from the caller's thread.
Python's GIL makes single bytecodes atomic but nothing larger: a
check-then-set on ``self._inflight`` or a multi-field stats update torn
across threads produces counts that never add up — the exact class of
bug the loadtest suite can only catch probabilistically.  The repo
contract is simple: any attribute written BOTH inside a thread-target
scope AND inside a public method must be written under ``with
self._lock`` (any ``self.*lock*``/``*cond*``/``*cv*`` context manager)
on both sides.

The rule resolves ``threading.Thread(target=...)`` targets — a closure
defined in the spawning method, or a bound method ``self._run`` — then
intersects the attributes they write with the attributes public methods
write, and flags every write site of a shared attribute that is not
lexically under a lock ``with``.  Single-writer attributes (touched by
only one side) are not flagged; neither are reads — lock discipline for
reads is a judgment call the linter leaves to review.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.analysis.base import Finding, Rule
from repro_torch.analysis.walker import dotted_name, qualified

_LOCKISH = ("lock", "cond", "cv", "mutex", "sem")


def _is_lock_ctx(expr: ast.AST) -> bool:
    d = dotted_name(expr) or ""
    if not d.startswith("self."):
        return False
    leaf = d.rsplit(".", 1)[-1].lower()
    return any(frag in leaf for frag in _LOCKISH)


def _self_attr(target: ast.AST) -> Optional[str]:
    """The first attribute name of a ``self.x[...].y = ...`` write."""
    node = target
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return node.attr
        node = node.value
    return None


def _collect_writes(fn: ast.AST) -> List[Tuple[str, ast.AST, bool]]:
    """(attr, node, under_lock) for every ``self.<attr>`` write in one
    scope, not descending into nested defs (they are their own
    potential thread targets)."""
    out: List[Tuple[str, ast.AST, bool]] = []

    def visit(node: ast.AST, locked: bool) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            locked = locked or any(
                _is_lock_ctx(item.context_expr) for item in node.items)
        targets: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            attr = _self_attr(t)
            if attr is not None:
                out.append((attr, node, locked))
        for child in ast.iter_child_nodes(node):
            visit(child, locked)

    for stmt in getattr(fn, "body", []):
        visit(stmt, False)
    return out


def _thread_targets(cls: ast.ClassDef,
                    imports: Dict[str, str]) -> List[ast.AST]:
    """Function nodes handed to ``threading.Thread(target=...)``
    anywhere in the class: closures in the spawning method, bound
    methods of the class, or module functions are resolved by name."""
    methods = {m.name: m for m in cls.body
               if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
    closures = {n.name: n for n in ast.walk(cls)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                and n.name not in methods}
    out: List[ast.AST] = []
    for node in ast.walk(cls):
        if not isinstance(node, ast.Call):
            continue
        name = qualified(dotted_name(node.func), imports)
        if not (name == "threading.Thread" or name.endswith(".Thread")
                or name == "Thread"):
            continue
        for kw in node.keywords:
            if kw.arg != "target":
                continue
            d = dotted_name(kw.value) or ""
            leaf = d.rsplit(".", 1)[-1]
            fn = None
            if d.startswith("self."):
                fn = methods.get(leaf)
            else:
                fn = closures.get(leaf) or methods.get(leaf)
            if fn is not None:
                out.append(fn)
    return out


class ThreadSharedStateRule(Rule):
    id = "RPL005"
    name = "thread-shared-state"
    summary = ("attribute written by both the background thread and a "
               "public method without holding self._lock")

    def check(self, ctx) -> Iterator[Finding]:
        if "Thread" not in ctx.source:
            return
        for cls in ast.walk(ctx.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            targets = _thread_targets(cls, ctx.imports)
            if not targets:
                continue
            target_writes: List[Tuple[str, ast.AST, bool]] = []
            for fn in targets:
                target_writes.extend(_collect_writes(fn))
            public_writes: List[Tuple[str, ast.AST, bool]] = []
            target_ids = {id(t) for t in targets}
            for m in cls.body:
                if not isinstance(m, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    continue
                if m.name.startswith("_") or id(m) in target_ids:
                    continue        # __init__ runs before the spawn
                public_writes.extend(_collect_writes(m))
            shared = ({a for a, _, _ in target_writes}
                      & {a for a, _, _ in public_writes})
            for attr, node, locked in target_writes + public_writes:
                if attr in shared and not locked:
                    yield self.finding(
                        ctx, node,
                        f"`self.{attr}` is written by both the "
                        f"background thread target and a public method "
                        f"of `{cls.name}` — this write does not hold "
                        f"the lock; wrap it in `with self._lock`")
