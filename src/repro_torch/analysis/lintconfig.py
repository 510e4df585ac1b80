"""reprolint configuration: rule enablement, path scopes, options.

Path scoping is substring-based over the posix display path: a rule
with ``include=("repro_torch/serving",)`` only runs on files whose path
contains that fragment, and ``exclude`` wins over ``include``.  That is
the per-module allowlist mechanism — e.g. the determinism rule only
polices core/serving/retrieval/routing/data/kernels (a notebook-style
launch script may legitimately use ad-hoc RNG), and the shared-memory
rule only reads the kernel sources under ``repro_torch/kernels/csrc``.

``DEFAULT_CONFIG`` is the port's contract, checked by its test gate.  A
JSON file passed via ``--config`` overlays it::

    {"rules": {"RPL004": {"options": {"budget_bytes": 101376},
               "exclude": ["kernels/csrc/experimental"]}}}
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Tuple

#: a block's shared memory on Hopper (sm_90) with the opt-in
#: (``cudaFuncAttributeMaxDynamicSharedMemorySize``): 227 KiB
SMEM_BUDGET_BYTES = 232448
#: a block's static shared memory (and its dynamic without the opt-in)
STATIC_SMEM_LIMIT_BYTES = 48 * 1024

#: the values each template parameter of the port's kernels is
#: instantiated with (a kernel is bounded under every combination of the
#: parameters its ``__shared__`` sizes name): head dims 64 / 96 / 128 /
#: 256 and K1's warps a block (``flash_decode.cu``), K2's group buckets,
#: K3's list slots and stage columns, K7 / K8's operand layouts.
#: Tests override these per case.
DEFAULT_TEMPLATE_BINDINGS: Dict[str, Tuple[int, ...]] = {
    # attention / decode (K1, K2, K4)
    "D": (64, 96, 128, 256), "kWarps": (4, 8), "MAXG": (1, 2, 4, 8),
    # dense retrieval (K3)
    "kSlots": (16, 32, 64), "kCC": (32, 64),
    # grouped GEMM (K7, K8): bools bind as 0 / 1
    "GROUP_RED": (0, 1), "A_MN": (0, 1), "B_MN": (0, 1),
}


@dataclass
class RuleConfig:
    enabled: bool = True
    include: Tuple[str, ...] = ()     # empty = everywhere
    exclude: Tuple[str, ...] = ()
    options: Dict[str, Any] = field(default_factory=dict)

    def applies_to(self, path: str) -> bool:
        if any(frag in path for frag in self.exclude):
            return False
        if self.include and not any(f in path for f in self.include):
            return False
        return True


@dataclass
class LintConfig:
    rules: Dict[str, RuleConfig] = field(default_factory=dict)

    def rule(self, rule_id: str) -> RuleConfig:
        return self.rules.setdefault(rule_id, RuleConfig())

    def overlay(self, data: Dict[str, Any]) -> "LintConfig":
        """Merge a ``--config`` JSON dict (shallow per rule)."""
        for rid, spec in (data.get("rules") or {}).items():
            rc = self.rule(rid)
            if "enabled" in spec:
                rc.enabled = bool(spec["enabled"])
            if "include" in spec:
                rc.include = tuple(spec["include"])
            if "exclude" in spec:
                rc.exclude = tuple(spec["exclude"])
            rc.options.update(spec.get("options") or {})
        return self

    @classmethod
    def from_file(cls, path: str) -> "LintConfig":
        return make_default_config().overlay(
            json.loads(Path(path).read_text()))


def make_default_config() -> LintConfig:
    return LintConfig(rules={
        # wall-clock discipline: everywhere (the serving plane is
        # virtual-time-replayable end to end; launch scripts time with
        # perf_counter like the Gateway does)
        "RPL001": RuleConfig(),
        # unseeded RNG only polices the deterministic serving core —
        # bit-for-bit replay is a tested invariant there
        "RPL002": RuleConfig(include=(
            "repro_torch/core", "repro_torch/serving",
            "repro_torch/retrieval", "repro_torch/routing",
            "repro_torch/data", "repro_torch/kernels")),
        # (no RPL003: the port has no jit, donation or out_shardings)
        "RPL004": RuleConfig(
            include=("repro_torch/kernels/csrc",),
            options={
                "budget_bytes": SMEM_BUDGET_BYTES,
                "static_limit_bytes": STATIC_SMEM_LIMIT_BYTES,
                "bindings": {k: list(v) for k, v in
                             DEFAULT_TEMPLATE_BINDINGS.items()},
            }),
        "RPL005": RuleConfig(),
        # exception hygiene polices the paths where a swallowed
        # exception silently erodes SLO accounting
        "RPL006": RuleConfig(include=(
            "repro_torch/serving", "repro_torch/retrieval",
            "repro_torch/routing")),
        # metric hygiene: names, single registration, injected clocks
        # (everywhere — bench/launch scripts bind metrics too)
        "RPL007": RuleConfig(),
    })


DEFAULT_CONFIG = make_default_config()
