"""reprolint core types: findings, the rule protocol, the registry.

A rule is a class with a unique ``id`` (``RPLnnn``), a one-line
``summary`` (what invariant it enforces), and a ``check(ctx)`` method
yielding :class:`Finding` objects for one parsed module.  Rules are
stdlib-only (ast + tokenize + re) so the linter runs without the repo's
runtime dependencies installed: it imports neither torch nor jax.

A rule reads one kind of source, named by its ``language``: the Python
rules (``"python"``) get a parsed module, RPL004 (``"cuda"``) the text
of a ``.cu`` / ``.cuh`` kernel source.  The walker never hands a rule
the other kind.

Registration is import-time: defining a subclass of :class:`Rule` with
an ``id`` adds it to the registry (``all_rules()``).  The rule modules
in :mod:`repro_torch.analysis.rules` are imported by the walker, so
user code only needs :func:`repro_torch.analysis.run_lint`.  The
registry is this package's own: a process that also imports the JAX
package's linter keeps the two rule sets apart.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Type

#: severity is informational only — every unsuppressed finding fails a
#: ``--fail-on-findings`` run; the tiers just order human output.
SEVERITIES = ("error", "warning")


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str                 # "RPL001"
    path: str                 # posix path as scanned (src/repro_torch/...)
    line: int                 # 1-based
    col: int                  # 0-based
    message: str
    severity: str = "error"
    suppressed: bool = False
    suppress_reason: str = ""

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col}"

    def to_dict(self) -> Dict:
        return {
            "rule": self.rule, "path": self.path, "line": self.line,
            "col": self.col, "message": self.message,
            "severity": self.severity, "suppressed": self.suppressed,
            "suppress_reason": self.suppress_reason,
        }


@dataclass
class LintResult:
    """Everything one lint run produced."""

    findings: List[Finding] = field(default_factory=list)   # active
    suppressed: List[Finding] = field(default_factory=list)
    n_files: int = 0

    @property
    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def to_dict(self) -> Dict:
        return {
            "n_files": self.n_files,
            "counts": self.counts,
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
        }


_REGISTRY: Dict[str, Type["Rule"]] = {}


class Rule:
    """Base class; subclasses self-register by ``id``.

    ``check`` receives a :class:`~repro_torch.analysis.walker.ModuleContext`
    (a :class:`~repro_torch.analysis.walker.CudaContext` for a
    ``language = "cuda"`` rule) and yields findings for that file only
    — rules never hold state across files, which is what lets the
    walker scan files in any order.  ``options`` come from the rule's
    :class:`~repro_torch.analysis.lintconfig.RuleConfig` (budget bytes,
    template bindings, path scopes live in the config, not the rule).
    """

    id: str = ""
    name: str = ""
    summary: str = ""
    language: str = "python"    # or "cuda": the sources the rule reads

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if cls.id:
            if cls.id in _REGISTRY and _REGISTRY[cls.id] is not cls:
                raise ValueError(f"duplicate rule id {cls.id!r}")
            _REGISTRY[cls.id] = cls

    def __init__(self, options: Optional[Dict] = None):
        self.options = dict(options or {})

    def check(self, ctx) -> Iterator[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(self, ctx, node, message: str, *,
                severity: str = "error") -> Finding:
        return Finding(rule=self.id, path=ctx.path,
                       line=getattr(node, "lineno", 0),
                       col=getattr(node, "col_offset", 0),
                       message=message, severity=severity)


def all_rules() -> Dict[str, Type[Rule]]:
    """id -> rule class, importing the bundled rule modules first."""
    import repro_torch.analysis.rules  # noqa: F401  (registers the rules)
    return dict(sorted(_REGISTRY.items()))
