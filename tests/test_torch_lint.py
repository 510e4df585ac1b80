"""The port's linter on its own: RPL002's torch draws, RPL004
``cuda-smem-budget`` on hand-computed CUDA fixtures and on the port's
seven kernel sources, suppressions in a ``.cu`` file, the ``__main__``
guard, and the port's gate: ``python -m repro_torch.analysis
src/repro_torch chip_smoke.py --fail-on-findings`` exits 0.

Fixtures live under ``tests/fixtures/lint_torch/``; they are parsed,
never imported or compiled.
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import LintConfig, all_rules, run_lint
from repro_torch.analysis.cli import main
from repro_torch.analysis.lintconfig import (DEFAULT_CONFIG,
                                             SMEM_BUDGET_BYTES,
                                             STATIC_SMEM_LIMIT_BYTES)
from repro_torch.analysis.rules.cuda_smem import (CudaUnit, UnboundSymbol,
                                                  _instantiations,
                                                  estimate_static_smem)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "lint_torch"
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
SOURCES = ("bm25", "dense_topk", "flash_attention", "flash_decode",
           "grouped_gemm", "paged_flash_decode", "ssd_scan")


def everywhere_config(**rpl004) -> LintConfig:
    cfg = LintConfig()
    for rid in all_rules():
        cfg.rule(rid)          # default RuleConfig: enabled, no scoping
    cfg.rule("RPL004").options.update(rpl004)
    return cfg


def lint(name: str, **rpl004):
    return run_lint([str(FIXTURES / name)],
                    config=everywhere_config(**rpl004))


def src_line(name: str, lineno: int) -> str:
    return (FIXTURES / name).read_text().splitlines()[lineno - 1]


def test_registry_is_the_ports_six_rules():
    assert sorted(all_rules()) == [
        "RPL001", "RPL002", "RPL004", "RPL005", "RPL006", "RPL007"]
    assert all_rules()["RPL004"].name == "cuda-smem-budget"
    assert {r.language for r in all_rules().values()} == {"python", "cuda"}


def test_rules_flag_rpl003_as_unknown():
    with pytest.raises(SystemExit):
        main([str(FIXTURES / "rpl002_torch_rng.py"), "--rules", "RPL003"])


# -- RPL002: torch's global generator ---------------------------------------


def test_rpl002_flags_torch_global_draws_not_generators():
    res = lint("rpl002_torch_rng.py")
    hits = [f for f in res.findings if f.rule == "RPL002"]
    srcs = [src_line("rpl002_torch_rng.py", f.line) for f in hits]
    assert len(hits) == 6
    for call in ("torch.randn(n)", "torch.randint(", "torch.rand_like(",
                 "torch.manual_seed(0)", "torch.cuda.manual_seed_all(",
                 ".normal_()"):
        assert any(call in s for s in srcs), call
    assert not any("generator=g" in s for s in srcs)


def test_rpl002_default_scope_is_the_ports_core():
    rc = DEFAULT_CONFIG.rule("RPL002")
    assert rc.applies_to("src/repro_torch/serving/engine.py")
    assert rc.applies_to("src/repro_torch/kernels/bm25.py")
    assert not rc.applies_to("src/repro_torch/launch/train.py")
    assert not rc.applies_to("src/repro/serving/engine.py")


# -- RPL004 (a): static shared memory ---------------------------------------


@pytest.mark.parametrize("bindings, templ", [
    ({"D": 64, "kWarps": 4}, 2 * 64 + 4 * 32 * 4),        # 640
    ({"D": 256, "kWarps": 8}, 2 * 256 + 4 * 32 * 8),      # 1536
])
def test_static_bytes_by_hand(bindings, templ):
    got = estimate_static_smem(FIXTURES / "smem_static.cu", bindings)
    # tile 32 x 65 floats + an 8-byte flag + the helper's 16 ints
    assert got["padded_tile_kernel"] == 32 * 65 * 4 + 8 + 16 * 4 == 8392
    assert got["templ_kernel"] == templ
    assert got["big_kernel"] == 3200 * 16 == 51200


def test_static_over_48k_is_a_finding():
    res = lint("smem_static.cu", bindings={"D": [64, 256],
                                           "kWarps": [4, 8]})
    assert [f.message.split("`")[1] for f in res.findings] == ["big_kernel"]
    assert "51,200 B" in res.findings[0].message
    assert "__global__" in src_line("smem_static.cu", res.findings[0].line)


def test_template_kernel_bounded_under_every_binding():
    unit = CudaUnit((FIXTURES / "smem_static.cu").read_text(),
                    str(FIXTURES / "smem_static.cu"))
    templ = next(k for k in unit.kernels if k.name == "templ_kernel")
    got = {tuple(sorted(env.items())): n for env, n in _instantiations(
        unit, templ, {"D": [64, 256], "kWarps": [4, 8]})}
    assert got == {(("D", 64), ("kWarps", 4)): 640,
                   (("D", 64), ("kWarps", 8)): 1152,
                   (("D", 256), ("kWarps", 4)): 1024,
                   (("D", 256), ("kWarps", 8)): 1536}
    # a lower limit catches the one instantiation over it, named
    res = lint("smem_static.cu", static_limit_bytes=1200,
               bindings={"D": [64, 256], "kWarps": [4, 8]})
    msgs = [f.message for f in res.findings if "templ_kernel" in f.message]
    assert len(msgs) == 1 and "at D=256, kWarps=8 declares 1,536 B" in msgs[0]


def test_unbound_template_parameter_is_named():
    res = lint("smem_static.cu", bindings={"D": [64]})
    msgs = [f.message for f in res.findings if "templ_kernel" in f.message]
    assert len(msgs) == 1 and "`kWarps` has no value" in msgs[0]


def test_unbound_symbol_is_a_finding_and_raises():
    res = lint("smem_unbound.cu")
    assert len(res.findings) == 1
    assert "`kMystery` has no value" in res.findings[0].message
    with pytest.raises(UnboundSymbol) as exc:
        estimate_static_smem(FIXTURES / "smem_unbound.cu", {})
    assert exc.value.symbol == "kMystery"


# -- RPL004 (b): dynamic shared memory --------------------------------------


@pytest.mark.parametrize("name, expect", [
    ("dyn_no_optin.cu", ["no `cudaFuncSetAttribute(no_optin_kernel"]),
    ("dyn_no_bound.cu", ["`unbounded_kernel`'s dynamic shared memory has "
                         "no bound"]),
    ("dyn_assert.cu", []),          # a local and a launcher's parameter
    ("dyn_optin_check.cu", []),     # the host check against the opt-in
])
def test_dynamic_opt_in_and_bound(name, expect):
    res = lint(name)
    assert len(res.findings) == len(expect)
    for f, want in zip(res.findings, expect):
        assert f.rule == "RPL004" and want in f.message


def test_static_assert_limit_over_the_budget_is_no_bound():
    res = lint("dyn_assert.cu", budget_bytes=100 * 1024)
    assert len(res.findings) == 2          # both kernels of the file
    assert all("232,448 B exceeds the 102,400 B budget" in f.message
               for f in res.findings)
    # the host check reads the card's own maximum: no budget applies
    assert lint("dyn_optin_check.cu", budget_bytes=1).findings == []


# -- suppressions and file kinds --------------------------------------------


def test_cuda_suppression_and_bare_allow():
    res = lint("suppress.cu")
    assert [(f.rule, f.suppress_reason) for f in res.suppressed] == [
        ("RPL004", "fixture: a preceding-line suppression")]
    assert sorted(f.rule for f in res.findings) == ["RPL004", "RPLERR"]
    errs = [f for f in res.findings if f.rule == "RPLERR"]
    assert "no reason" in errs[0].message
    # the bare allow suppresses nothing on its own line
    assert {f.line for f in res.findings} == {errs[0].line}


def test_python_rules_never_see_cuda_and_rpl004_never_sees_python():
    # suppress.cu holds `time.time()` as text: RPL001 does not read it
    res = lint("suppress.cu")
    assert {f.rule for f in res.findings + res.suppressed} <= {
        "RPL004", "RPLERR"}
    res = lint("rpl002_torch_rng.py")
    assert {f.rule for f in res.findings} == {"RPL002"}


def test_n_files_counts_cuda_sources():
    res = run_lint([str(FIXTURES)], config=everywhere_config())
    assert res.n_files == len(list(FIXTURES.glob("*.py"))) + len(
        list(FIXTURES.glob("*.cu")))


def test_budget_mib_accepts_fractions(capsys, tmp_path):
    # 0.05 MiB = 52,428 B: under every static_assert limit of 232,448
    opened = tmp_path / "open.json"     # RPL004 outside kernels/csrc
    opened.write_text(json.dumps({"rules": {"RPL004": {"include": []}}}))
    rc = main([str(FIXTURES / "dyn_assert.cu"), "--budget-mib", "0.05",
               "--config", str(opened), "--rules", "RPL004",
               "--fail-on-findings", "--format", "json"])
    assert rc == 1
    data = json.loads(capsys.readouterr().out)
    assert data["counts"] == {"RPL004": 2}
    assert all("52,428 B budget" in f["message"] for f in data["findings"])


# -- the port's seven kernel sources ----------------------------------------


#: static bytes by hand from each source's `__shared__` arrays
HAND_STATIC = {
    "bm25_csr_kernel": 64 * 33 * 4,                 # tile[kQTile * kLd]
    "dense_topk_kernel": 0,
    "flash_attention_kernel": 0,
    "flash_decode_kernel": 4,                       # s_last
    "gg_bf16_kernel": 0,
    "gg_f32_kernel": 2 * 16 * 65 * 4 + 3 * 4,       # sA, sB, schedule's found
    "paged_flash_decode_kernel": 8,                 # s_last, s_slot
    "chunk_state_kernel": 0, "state_pass_kernel": 0, "chunk_scan_kernel": 0,
}


def test_every_kernel_of_the_seven_sources_is_bounded():
    bindings = DEFAULT_CONFIG.rule("RPL004").options["bindings"]
    seen = {}
    for src in SOURCES:
        unit = CudaUnit((CSRC / f"{src}.cu").read_text(),
                        str(CSRC / f"{src}.cu"))
        for k in unit.kernels:
            sizes = {n for _, n in _instantiations(unit, k, bindings)}
            assert len(sizes) == 1, k.name     # no size names a parameter
            seen[k.name] = sizes.pop()
            if any(d.extern for d in k.shared):
                assert k.name in unit.opted_in()
        if any(any(d.extern for d in k.shared) for k in unit.kernels):
            ok, over = unit.smem_asserts(SMEM_BUDGET_BYTES)
            assert (ok and not over) or unit.optin_checks(), src
    assert seen == HAND_STATIC
    assert max(seen.values()) <= STATIC_SMEM_LIMIT_BYTES


def test_default_budget_is_hoppers_opt_in_maximum():
    opts = DEFAULT_CONFIG.rule("RPL004").options
    assert opts["budget_bytes"] == SMEM_BUDGET_BYTES == 227 * 1024
    assert opts["static_limit_bytes"] == 48 * 1024
    assert DEFAULT_CONFIG.rule("RPL004").include == (
        "repro_torch/kernels/csrc",)


# -- the entry point and the gate -------------------------------------------


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PYTHONDONTWRITEBYTECODE="1")
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120, **kw)


def test_main_module_import_does_not_run():
    proc = _run(["-c", "import repro_torch.analysis.__main__; print('ok')"])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["ok"]


def test_port_gate_has_zero_unsuppressed_findings():
    """The port's gate: ``python -m repro_torch.analysis src/repro_torch
    chip_smoke.py --fail-on-findings`` exits 0 with every rule active,
    over the .py files and the CUDA sources."""
    proc = _run(["-m", "repro_torch.analysis", "src/repro_torch",
                 "chip_smoke.py", "--fail-on-findings", "--format", "json"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    data = json.loads(proc.stdout)
    assert data["findings"] == []
    files = [f for f in (ROOT / "src" / "repro_torch").rglob("*")
             if f.suffix in (".py", ".cu", ".cuh")
             and "__pycache__" not in f.parts]
    assert data["n_files"] == len(files) + 1 > 100       # + chip_smoke.py
    assert sum(f.suffix in (".cu", ".cuh") for f in files) >= 8
    # the allow-list is auditable: every suppression carries a reason
    assert all(f["suppress_reason"] for f in data["suppressed"])
    assert not any(f["path"].endswith((".cu", ".cuh"))
                   for f in data["suppressed"])
