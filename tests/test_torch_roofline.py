"""``repro_torch.analysis.roofline`` against the reference's
``analysis/roofline.py``.

* The closed forms (``forward_flops``, ``model_flops``, ``hbm_bytes``,
  ``_cache_bytes``, ``collective_bytes_model``, the parameter counts)
  equal the reference's for every arch x input shape
  ``shape_supported`` allows x both production meshes, within 1e-12
  relative; ``pick_microbatches`` equals the reference's (its source
  taken from ``repro/launch/dryrun.py`` alone: importing that module
  would set ``XLA_FLAGS`` for this process).
* ``analyse`` on one synthetic dry-run record: each term is the
  reference's times the ratio of the two cards' rates (TPU v5e over
  H100), and the counted FLOPs are the record's x cards, not scaled by
  microbatches x blocks as the reference's HLO count is.
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import ast
from pathlib import Path

import pytest

import repro.analysis.roofline as RR
from repro.configs import get_config as ref_config
from repro.launch import mesh as ref_mesh
from repro.models.transformer import layer_structure as ref_layers
from repro_torch.analysis import roofline as PR
from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, get_config,
                                 shape_supported)
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as port_mesh

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
RTOL = 1e-12


def _ref_pick_microbatches():
    """The reference's ``pick_microbatches``, compiled from its source."""
    path = ROOT / "src" / "repro" / "launch" / "dryrun.py"
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "pick_microbatches")
    ns = {}
    exec(compile(ast.Module([fn], []), str(path), "exec"), ns)
    return ns["pick_microbatches"]


def _close(a, b):
    assert a == pytest.approx(b, rel=RTOL, abs=0), (a, b)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_closed_forms_match_reference(arch):
    cfg, rc = get_config(arch, "full"), ref_config(arch, "full")
    _close(PR.n_params(cfg), rc.n_params())
    _close(PR.n_active_params(cfg), rc.n_active_params())
    ref_pick = _ref_pick_microbatches()
    shapes = [s for s in INPUT_SHAPES if shape_supported(arch, s)]
    assert shapes
    for shape in shapes:
        sh = INPUT_SHAPES[shape]
        B, S = sh["global_batch"], sh["seq_len"]
        assert PR.model_flops(cfg, shape) == pytest.approx(
            RR.model_flops(rc, shape), rel=RTOL)
        _close(PR.forward_flops(cfg, B, S, S), RR.forward_flops(rc, B, S, S))
        _close(PR._cache_bytes(cfg, B, S), RR._cache_bytes(rc, B, S))
        for kind, mesh in MESHES.items():
            nb = mesh["data"] * mesh.get("pod", 1)
            n_mb = D.pick_microbatches(cfg, B, S, nb)
            assert n_mb == ref_pick(rc, B, S, nb), (shape, kind)
            chips = 256 * mesh.get("pod", 1)
            _close(PR.hbm_bytes(cfg, shape, chips, n_mb),
                   RR.hbm_bytes(rc, shape, chips, n_mb))
            _close(PR.collective_bytes_model(cfg, shape, mesh, n_mb),
                   RR.collective_bytes_model(rc, shape, mesh, n_mb))


def test_card_constants_replace_the_tpu_ones():
    assert port_mesh.PEAK_FLOPS_BF16 == 989e12
    assert port_mesh.HBM_BW == 3.35e12
    assert port_mesh.LINK_BW == 450e9


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch,shape", [("qwen1.5-32b", "train_4k"),
                                        ("dbrx-132b", "decode_32k"),
                                        ("gemma3-12b", "long_500k"),
                                        ("phi-3-vision-4.2b", "prefill_32k")])
def test_analyse_scales_by_the_cards_rates(arch, shape, mesh_kind):
    chips = 512 if mesh_kind == "multi" else 256
    record = {"n_devices": chips, "info": {"microbatches": 4},
              "flops": 3.5e13}
    got = PR.analyse(arch, shape, mesh_kind, record=record)
    want = RR.analyse(arch, shape, mesh_kind, record=record)
    _close(got.compute_s, want.compute_s * ref_mesh.PEAK_FLOPS_BF16
           / port_mesh.PEAK_FLOPS_BF16)
    _close(got.memory_s, want.memory_s * ref_mesh.HBM_BW / port_mesh.HBM_BW)
    _close(got.collective_s, want.collective_s * ref_mesh.ICI_BW
           / port_mesh.LINK_BW)
    _close(got.model_flops, want.model_flops)
    # the record's count is every executed op: no scan scaling
    _close(got.hlo_flops_scaled, record["flops"] * chips)
    _, _, n_blocks = ref_layers(ref_config(arch, "full"))
    _close(want.hlo_flops_scaled, got.hlo_flops_scaled * 4 * n_blocks)
    terms = {"compute": got.compute_s, "memory": got.memory_s,
             "collective": got.collective_s}
    assert got.dominant == max(terms, key=terms.get)
    assert got.note == PR._NOTES[got.dominant]
    assert got.as_dict()["chips"] == chips


def test_main_prints_the_table_of_the_records(tmp_path, monkeypatch, capsys):
    record = {"n_devices": 256, "info": {"microbatches": 1}, "flops": 1e12}
    (tmp_path / "dbrx-132b__decode_32k__single.json").write_text(
        __import__("json").dumps(record))
    monkeypatch.setattr(PR, "DRYRUN_DIR", tmp_path)
    out = PR.main(["--mesh", "single"])
    assert out["n_pairs"] == 1 and sum(out["dominant_histogram"].values()) == 1
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["arch", "shape", "compute_s", "memory_s",
                                "coll_s", "dominant", "useful"]
    assert lines[1].split()[:2] == ["dbrx-132b", "decode_32k"]
    assert PR.main(["--mesh", "multi"])["n_pairs"] == 0
