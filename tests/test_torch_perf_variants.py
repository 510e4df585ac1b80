"""The twin of ``benchmarks/perf_variants.py``: the §Perf before/after
table from the port's dry-run records
(``repro_torch.benchmarks.perf_variants``).

On hand-made records in a ``tmp_path`` ``RESULTS_DIR``: the twelve
``PAIRS`` are the reference's, the rows the reference's ``main`` makes
of the same records (plus each record's device), the columns, a pair
skipped where either record is missing, no rows at all returning
cleanly (where the reference's ``max()`` raises), the artifact and the
printed header naming the records as fake-tensor models.  Every tag of
``PAIRS`` maps to ``dryrun.run_one``'s flags.  ``--make`` on one cheap
real pair (gemma3-12b's long_500k and its ring cache, traced on the
CPU, ~8 s each) writes both records and their row, and ``run.py perf``
reads them.
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import json
import sys
from pathlib import Path

import pytest

from repro_torch.benchmarks import common
from repro_torch.benchmarks import perf_variants as PV
from repro_torch.benchmarks import run
from repro_torch.launch import dryrun

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks import perf_variants as ref_pv  # noqa: E402


@pytest.fixture
def dirs(tmp_path, monkeypatch):
    """The records and the artifacts under ``tmp_path``."""
    rec, art = tmp_path / "records", tmp_path / "artifacts"
    rec.mkdir()
    monkeypatch.setattr(dryrun, "RESULTS_DIR", rec)
    monkeypatch.setattr(common, "ART_DIR", art)
    return rec, art


def _record(rec_dir, name, temp, coll, flops, device="cpu"):
    (rec_dir / f"{name}.json").write_text(json.dumps({
        "temp_size_in_bytes": temp, "flops": flops, "device": device,
        "collective_bytes": {"all-gather": coll, "all-reduce": 2 * coll,
                             "reduce-scatter": 0, "all-to-all": 0,
                             "collective-permute": 0}}))


def test_pairs_are_the_reference_pairs_and_every_tag_has_flags():
    assert PV.PAIRS == ref_pv.PAIRS
    for _, base, var in PV.PAIRS:
        assert PV._parse(base)[3] == {}
        arch, shape, mesh, flags = PV._parse(var)
        assert flags and (arch, shape, mesh) == PV._parse(base)[:3]
    assert PV._parse("deepseek-v3-671b__train_4k__single_cf10_bf16_scat")[
        3] == {"capacity_factor": 1.0, "moe_comm_bf16": True,
               "moe_scatter_down": True}
    assert PV._parse("qwen1.5-32b__train_4k__single_padheads")[3] == {
        "pad_heads": 16}


def test_table_on_hand_made_records(dirs, monkeypatch, capsys):
    """Three pairs' records: both of pair 1 and pair 3; pair 2's variant
    missing (skipped, as the reference skips it) and pair 4's base
    missing (skipped; the reference would raise).  The rows equal the
    reference's on the same records, plus each record's device."""
    rec, art = dirs
    (l1, b1, v1), (_, b2, _), (l3, b3, v3), (_, _, v4) = PV.PAIRS[2:6]
    _record(rec, b1, 3 * 2**30, 1e9, 5e14)
    _record(rec, b2, 4 * 2**30, 1e9, 5e14)
    _record(rec, v1, 2 * 2**30, 2e9, 4e14, device="cuda")
    _record(rec, b3, 6 * 2**30, 3e9, 1e15)
    _record(rec, v3, 2 * 2**30, 3e9, 9e14)
    _record(rec, v4, 1 * 2**30, 1e9, 1e14)
    got = PV.main()
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"# {PV.SOURCE}" and "fake-tensor models" in out[0]
    assert "not measurements" in out[0]
    assert out[1].split() == ["iteration", "temp", "GiB", "coll", "B",
                              "FLOPs"]
    assert [ln[:32].strip() for ln in out[2:]] == [l1, l3]
    art_rows = json.loads((art / "perf_variants.json").read_text())
    assert art_rows["source"] == PV.SOURCE
    rows = art_rows["rows"]
    assert [r["iteration"] for r in rows] == [l1, l3]
    assert rows[0] == {"iteration": l1, "temp_gib": [3.0, 2.0],
                       "coll_bytes": [3e9, 6e9], "flops": [5e14, 4e14],
                       "device": ["cpu", "cuda"]}
    assert got == {"n_variants": 2, "biggest_temp_reduction": l3}
    # the reference's main on the same records (pair 4's base given, so
    # that it does not raise)
    _record(rec, PV.PAIRS[5][1], 1 * 2**30, 1e9, 1e14)
    saved = {}
    monkeypatch.setattr(ref_pv, "DRYRUN", rec)
    monkeypatch.setattr(ref_pv, "save_artifact",
                        lambda name, obj: saved.update({name: obj}))
    ref = ref_pv.main()
    mine = PV.main()
    assert [{k: v for k, v in r.items() if k != "device"} for r in
            json.loads((art / "perf_variants.json").read_text())["rows"]] \
        == saved["perf_variants"]
    assert mine == ref


def test_no_records_returns_cleanly(dirs, capsys):
    rec, art = dirs
    assert PV.main() == {"n_variants": 0, "biggest_temp_reduction": None}
    assert json.loads((art / "perf_variants.json").read_text()) == {
        "source": PV.SOURCE, "rows": []}
    assert capsys.readouterr().out.startswith(f"# {PV.SOURCE}\n")


def test_make_traces_a_missing_pair_and_run_reads_it(dirs, monkeypatch,
                                                     capsys):
    """gemma3-12b at long_500k, base and ring cache, traced on the CPU
    by ``--make``; ``run.py perf`` then reads the two records."""
    rec, art = dirs
    pair = next(p for p in PV.PAIRS if p[0].startswith("H4"))
    monkeypatch.setattr(PV, "PAIRS", [pair])
    got = PV.main(device="cpu", make=True)
    assert got == {"n_variants": 1, "biggest_temp_reduction": pair[0]}
    base, ring = (json.loads((rec / f"{n}.json").read_text())
                  for n in pair[1:])
    assert base["info"].get("window_ring") is None
    assert ring["info"]["window_ring"] is True
    assert base["device"] == ring["device"] == "cpu"
    # the ring holds a window of rows where the full cache holds 500k
    assert ring["argument_size_in_bytes"] < base["argument_size_in_bytes"]
    capsys.readouterr()
    rows = run.main(["perf", "--device", "cpu"])
    assert [r[0] for r in rows] == ["perf"] and rows[0][2] == got
    assert pair[0] in capsys.readouterr().out
