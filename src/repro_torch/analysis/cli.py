"""reprolint CLI: ``python -m repro_torch.analysis src/ [options]``.

The JAX package's flags, exit codes and JSON schema; ``--budget-mib``
sets RPL004's ``budget_bytes`` (a block's dynamic shared memory,
fractions accepted) and ``--rules`` knows the port's six ids (no
RPL003).

Exit codes: 0 clean (or findings present but ``--fail-on-findings`` not
given — useful for survey runs), 1 unsuppressed findings with the flag,
2 usage errors.  Suppressed findings never affect the exit code but are
always reported (human: a separate section; json: the ``suppressed``
list) so the allow-list stays auditable.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.analysis.base import all_rules
from repro_torch.analysis.lintconfig import LintConfig, make_default_config
from repro_torch.analysis.walker import run_lint


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="reprolint: invariant checks for the PyTorch / "
                    "CUDA serving stack")
    p.add_argument("paths", nargs="*", default=["src"],
                   help="files or directories to lint (default: src)")
    p.add_argument("--format", choices=("human", "json"),
                   default="human", help="output format")
    p.add_argument("--fail-on-findings", action="store_true",
                   help="exit 1 if any unsuppressed finding remains")
    p.add_argument("--config", metavar="JSON",
                   help="JSON config file overlaying the defaults")
    p.add_argument("--rules", metavar="IDS",
                   help="comma-separated rule ids to run (others off)")
    p.add_argument("--budget-mib", type=float, metavar="MIB",
                   help="override the RPL004 shared-memory budget, "
                        "in MiB")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    return p


def _list_rules() -> None:
    for rid, cls in all_rules().items():
        print(f"{rid}  {cls.name:<22} {cls.summary}")


def _human(result) -> None:
    for f in result.findings:
        print(f"{f.location()}: {f.rule} {f.message}")
    if result.suppressed:
        print(f"-- {len(result.suppressed)} suppressed "
              f"(allow[] with reason) --")
        for f in result.suppressed:
            print(f"{f.location()}: {f.rule} [allowed: "
                  f"{f.suppress_reason}]")
    counts = ", ".join(f"{k}={v}" for k, v in result.counts.items())
    print(f"{result.n_files} files, {len(result.findings)} findings"
          + (f" ({counts})" if counts else "")
          + f", {len(result.suppressed)} suppressed")


def build_config(args) -> LintConfig:
    cfg = (LintConfig.from_file(args.config) if args.config
           else make_default_config())
    if args.rules:
        wanted = {r.strip() for r in args.rules.split(",") if r.strip()}
        unknown = wanted - set(all_rules())
        if unknown:
            raise SystemExit(
                f"unknown rule id(s): {', '.join(sorted(unknown))}")
        for rid in all_rules():
            cfg.rule(rid).enabled = rid in wanted
    if args.budget_mib is not None:
        cfg.rule("RPL004").options["budget_bytes"] = int(
            args.budget_mib * 2 ** 20)
    return cfg


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.list_rules:
        _list_rules()
        return 0
    result = run_lint(args.paths, config=build_config(args))
    if args.format == "json":
        print(json.dumps(result.to_dict(), indent=2))
    else:
        _human(result)
    if args.fail_on_findings and result.findings:
        return 1
    return 0


if __name__ == "__main__":   # pragma: no cover
    sys.exit(main())
