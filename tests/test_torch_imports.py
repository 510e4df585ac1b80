"""The PyTorch port (``src/repro_torch``), ``chip_smoke.py`` and the
port's card scripts import neither JAX nor any module of the reference
package ``repro``."""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_every_port_module_imports_without_jax_or_reference():
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.path.insert(0, {str(ROOT / "src")!r})
        sys.modules["jax"] = None          # any `import jax` now fails
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        leaked = sorted(m for m in sys.modules
                        if m == "repro" or m.startswith("repro."))
        assert not leaked, leaked
        print(len(names))
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 30      # every subpackage walked


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "paged_decode_sweep.py",
    ROOT / "scripts" / "grouped_gemm_ab.py",
    ROOT / "scripts" / "admission_ab.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_statement_names_jax_or_reference(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, roots
