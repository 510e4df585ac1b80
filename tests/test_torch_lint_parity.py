"""The port's linter (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``): the rules they share find the same
things on every fixture of ``tests/fixtures/lint/``, and the CLI answers
the same argv with the same exit code and JSON.

RPL001, RPL002, RPL005, RPL006 and RPL007 are shared.  RPL003 has no
counterpart in the port (no jit donation), and the port's RPL004 reads
CUDA sources, not Pallas calls: so on ``rpl003_donate.py`` and
``rpl004_vmem.py`` the port reports nothing at all.
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import json
from pathlib import Path

import pytest

import repro.analysis as ref
import repro.analysis.cli as ref_cli
import repro_torch.analysis as port
import repro_torch.analysis.cli as port_cli

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "lint"
SHARED = ("RPL001", "RPL002", "RPL005", "RPL006", "RPL007")
SHARED_FIXTURES = ("clean.py", "rpl001_clock.py", "rpl002_rng.py",
                   "rpl005_threads.py", "rpl006_except.py",
                   "rpl007_metrics.py", "suppressions.py")


def _opened(pkg, rules=SHARED):
    """Only ``rules`` enabled, every scope opened."""
    cfg = pkg.LintConfig()
    for rid in pkg.all_rules():
        cfg.rule(rid).enabled = rid in rules
    return cfg


def _key(findings):
    return [(f.rule, f.line, f.col, f.message, f.suppressed,
             f.suppress_reason) for f in findings]


@pytest.mark.parametrize("name", SHARED_FIXTURES)
def test_shared_rules_find_the_same(name):
    path = [str(FIXTURES / name)]
    a = ref.run_lint(path, config=_opened(ref))
    b = port.run_lint(path, config=_opened(port))
    assert _key(b.findings) == _key(a.findings)
    assert _key(b.suppressed) == _key(a.suppressed)
    assert b.n_files == a.n_files == 1
    if name != "clean.py":
        assert a.findings or a.suppressed   # the comparison is not empty


@pytest.mark.parametrize("name", ("rpl003_donate.py", "rpl004_vmem.py"))
def test_port_reports_nothing_on_jax_only_fixtures(name):
    # every port rule on, every scope open: RPL003 does not exist in the
    # port and its RPL004 reads only .cu / .cuh, so the JAX-only
    # fixtures hold nothing for it
    res = port.run_lint([str(FIXTURES / name)],
                        config=_opened(port, tuple(port.all_rules())))
    assert res.findings == [] and res.suppressed == []
    assert ref.run_lint([str(FIXTURES / name)],
                        config=_opened(ref, ("RPL003", "RPL004"))).findings


CLI_CASES = {
    "flag exits 1": [str(FIXTURES / "rpl001_clock.py"),
                     "--fail-on-findings"],
    "no flag exits 0": [str(FIXTURES / "rpl001_clock.py")],
    "rules filter": [str(FIXTURES / "rpl001_clock.py"), "--rules",
                     "RPL002", "--fail-on-findings"],
    "json": [str(FIXTURES / "rpl001_clock.py"), "--format", "json"],
    "json suppressions": [str(FIXTURES / "suppressions.py"), "--format",
                          "json", "--fail-on-findings"],
    "list rules": ["--list-rules"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_same_exit_code_and_output(case, capsys):
    argv = CLI_CASES[case]
    rc_ref = ref_cli.main(list(argv))
    out_ref = capsys.readouterr().out
    rc_port = port_cli.main(list(argv))
    out_port = capsys.readouterr().out
    assert rc_port == rc_ref
    if "json" in argv:
        a, b = json.loads(out_ref), json.loads(out_port)
        assert set(b) == set(a) == {"n_files", "counts", "findings",
                                    "suppressed"}
        for f in b["findings"] + b["suppressed"]:
            assert set(f) == {"rule", "path", "line", "col", "message",
                              "severity", "suppressed", "suppress_reason"}
        assert b == a
    elif case == "list rules":
        ids = {line.split()[0] for line in out_port.splitlines()}
        assert ids == {line.split()[0]
                       for line in out_ref.splitlines()} - {"RPL003"}
    else:
        assert out_port == out_ref


def test_cli_unknown_rule_exits_in_both():
    argv = [str(FIXTURES / "rpl001_clock.py"), "--rules", "RPL999"]
    for main in (ref_cli.main, port_cli.main):
        with pytest.raises(SystemExit):
            main(list(argv))


def test_cli_budget_override_flags_every_kernel_source(capsys):
    # the JAX package's case: a 0.001 MiB budget puts every Pallas site
    # over; in the port it puts every static_assert bound over, so each
    # extern __shared__ kernel outside a host opt-in check is unbounded
    argv = ["--budget-mib", "0.001", "--rules", "RPL004",
            "--fail-on-findings"]
    assert ref_cli.main([str(ROOT / "src" / "repro" / "kernels")]
                        + argv) == 1
    assert "exceeds" in capsys.readouterr().out
    assert port_cli.main([str(ROOT / "src" / "repro_torch" / "kernels"
                              / "csrc")] + argv) == 1
    assert "exceeds" in capsys.readouterr().out
