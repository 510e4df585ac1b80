"""reprolint walker: file discovery, parsing, suppressions, shared AST
helpers, and the run loop.

Suppressions
------------

A finding is silenced by an inline comment::

    x = time.time()  # repro: allow[RPL001] bench labels are wall-clock

or by a comment-only line immediately above the offending line::

    # repro: allow[RPL001] real-time pacing is the point of this loop
    time.sleep(lag)

In a CUDA source (``.cu`` / ``.cuh``) the comment is C++'s::

    // repro: allow[RPL004] <reason>

The rule id list is comma-separable (``allow[RPL001,RPL006]``) and the
reason is REQUIRED: a bare ``allow[...]`` with no justification does
not suppress anything (and is itself reported), so every suppression in
the tree documents *why* the invariant doesn't apply.  Suppressed
findings stay in the report (``suppressed`` block of the JSON output)
— they are auditable, not invisible.

Files
-----

:func:`discover` yields ``.py`` files and the CUDA kernel sources
(``.cu``, ``.cuh``).  A ``.py`` file is parsed into a
:class:`ModuleContext` (its AST) and reaches the Python rules; a CUDA
source becomes a :class:`CudaContext` (its text, no AST) and reaches
only the rules whose ``language`` is ``"cuda"`` (RPL004).  ``n_files``
counts both kinds, where the JAX package's linter counts ``.py`` only.
"""
from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.base import Finding, LintResult, all_rules
from repro_torch.analysis.lintconfig import DEFAULT_CONFIG, LintConfig

_ALLOW_RE = re.compile(
    r"#\s*repro:\s*allow\[([A-Za-z0-9_,\s-]+)\]\s*(.*)")
_CUDA_ALLOW_RE = re.compile(
    r"//\s*repro:\s*allow\[([A-Za-z0-9_,\s-]+)\]\s*(.*)")

#: suffixes of the CUDA kernel sources the walker reads as text
CUDA_SUFFIXES = (".cu", ".cuh")
_SUFFIXES = (".py",) + CUDA_SUFFIXES


# ---------------------------------------------------------------------------
# Shared AST helpers (used by every rule)
# ---------------------------------------------------------------------------


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def root_name(node: ast.AST) -> Optional[str]:
    """The leftmost Name of any attribute/subscript/call chain:
    ``table.to(torch.int32)`` -> ``table``."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else None


def assigned_names(target: ast.AST) -> List[str]:
    """Dotted names written by one assignment target (tuples/lists/
    starred unpacked; subscript writes count as writes to the base)."""
    out: List[str] = []
    if isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            out.extend(assigned_names(elt))
    elif isinstance(target, ast.Starred):
        out.extend(assigned_names(target.value))
    elif isinstance(target, ast.Subscript):
        d = dotted_name(target.value)
        if d:
            out.append(d)
    else:
        d = dotted_name(target)
        if d:
            out.append(d)
    return out


def walk_scope(fn: ast.AST):
    """Yield every node in one function/module scope WITHOUT descending
    into nested function / class definitions (those are their own
    scopes).  The nested def/class node itself is yielded."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(node))


def import_table(tree: ast.Module) -> Dict[str, str]:
    """Local name -> fully qualified name for module-level imports
    (``import numpy as np`` -> {"np": "numpy"}; ``from time import
    sleep`` -> {"sleep": "time.sleep"})."""
    table: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                table[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                if a.name == "*":
                    continue
                table[a.asname or a.name] = f"{node.module}.{a.name}"
    return table


def qualified(name: Optional[str], imports: Dict[str, str]) -> str:
    """Rewrite the chain root through the import table:
    ``np.random.rand`` -> ``numpy.random.rand``."""
    if not name:
        return ""
    head, _, rest = name.partition(".")
    head = imports.get(head, head)
    return f"{head}.{rest}" if rest else head


# ---------------------------------------------------------------------------
# Contexts
# ---------------------------------------------------------------------------


@dataclass
class _Suppressions:
    """The allow[] comments of one file."""

    path: str                      # posix path as scanned
    source: str
    # line -> {rule_id -> reason} for valid (justified) suppressions
    suppressions: Dict[int, Dict[str, str]] = field(default_factory=dict)
    # lines carrying an allow[] comment with NO reason (reported)
    bare_allows: List[Tuple[int, str]] = field(default_factory=list)

    def _allow(self, m: re.Match, line: int, code: str) -> None:
        ids = [s.strip() for s in m.group(1).split(",") if s.strip()]
        reason = m.group(2).strip()
        if not reason:
            self.bare_allows.append((line, ",".join(ids)))
            return
        # a comment-only line suppresses the NEXT line; an inline
        # comment suppresses its own line.  Registering both is safe: a
        # comment-only line has no code to flag.
        target = line + 1 if not code.strip() else line
        slot = self.suppressions.setdefault(target, {})
        for rid in ids:
            slot[rid] = reason

    def suppression_for(self, rule_id: str, line: int) -> Optional[str]:
        return self.suppressions.get(line, {}).get(rule_id)


@dataclass
class ModuleContext(_Suppressions):
    """One parsed Python source file handed to every Python rule."""

    language = "python"
    tree: Optional[ast.Module] = None
    imports: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def parse(cls, path: Path, display_path: str) -> "ModuleContext":
        source = path.read_text()
        tree = ast.parse(source, filename=display_path)
        ctx = cls(path=display_path, source=source, tree=tree)
        ctx.imports = import_table(tree)
        ctx._scan_comments()
        return ctx

    def _scan_comments(self) -> None:
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO(self.source).readline))
        except tokenize.TokenError:
            return
        lines = self.source.splitlines()
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _ALLOW_RE.search(tok.string)
            if m:
                line = tok.start[0]
                self._allow(m, line, lines[line - 1][:tok.start[1]])


@dataclass
class CudaContext(_Suppressions):
    """One CUDA kernel source (``.cu`` / ``.cuh``), as text, handed to
    the rules whose ``language`` is ``"cuda"``."""

    language = "cuda"

    @classmethod
    def parse(cls, path: Path, display_path: str) -> "CudaContext":
        ctx = cls(path=display_path, source=path.read_text())
        for i, text in enumerate(ctx.source.splitlines(), 1):
            m = _CUDA_ALLOW_RE.search(text)
            if m:
                ctx._allow(m, i, text[:m.start()])
        return ctx


# ---------------------------------------------------------------------------
# Run loop
# ---------------------------------------------------------------------------


def discover(paths: Sequence[str]) -> List[Tuple[Path, str]]:
    """Expand files/dirs into (filesystem path, display path) pairs:
    every ``.py``, ``.cu`` and ``.cuh`` file."""
    out: List[Tuple[Path, str]] = []
    for raw in paths:
        p = Path(raw)
        if p.is_dir():
            for f in sorted(p.rglob("*")):
                if f.suffix in _SUFFIXES and f.is_file() \
                        and "__pycache__" not in f.parts:
                    out.append((f, f.as_posix()))
        elif p.suffix in _SUFFIXES:
            out.append((p, p.as_posix()))
    return out


def run_lint(paths: Sequence[str],
             config: Optional[LintConfig] = None) -> LintResult:
    """Lint every ``.py``, ``.cu`` and ``.cuh`` under ``paths``; returns
    the full result with suppressed findings separated out (exit-code
    policy is the CLI's)."""
    cfg = config or DEFAULT_CONFIG
    result = LintResult()
    rules = []
    for rid, cls in all_rules().items():
        rc = cfg.rule(rid)
        if rc.enabled:
            rules.append((cls(rc.options), rc))
    for fs_path, display in discover(paths):
        result.n_files += 1
        if fs_path.suffix in CUDA_SUFFIXES:
            ctx = CudaContext.parse(fs_path, display)
        else:
            try:
                ctx = ModuleContext.parse(fs_path, display)
            except SyntaxError as exc:
                result.findings.append(Finding(
                    rule="RPLERR", path=display, line=exc.lineno or 0,
                    col=exc.offset or 0,
                    message=f"syntax error: {exc.msg}"))
                continue
        for line, ids in ctx.bare_allows:
            result.findings.append(Finding(
                rule="RPLERR", path=display, line=line, col=0,
                message=f"suppression allow[{ids}] has no reason — "
                        f"every allow must carry a justification"))
        for rule, rc in rules:
            if rule.language != ctx.language or not rc.applies_to(display):
                continue
            for f in rule.check(ctx):
                reason = ctx.suppression_for(f.rule, f.line)
                if reason is not None:
                    result.suppressed.append(Finding(
                        **{**f.to_dict(), "suppressed": True,
                           "suppress_reason": reason}))
                else:
                    result.findings.append(f)
    result.findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    result.suppressed.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return result
