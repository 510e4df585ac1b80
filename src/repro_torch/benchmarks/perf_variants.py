"""§Perf before/after table, from the port's dry-run records.

The twin of the repository's ``benchmarks/perf_variants.py``: the same
twelve ``PAIRS`` (a base record and a variant of one arch, input shape
and layout), the same labels and columns (temp GiB, collective bytes,
FLOPs), read from ``repro_torch.launch.dryrun.RESULTS_DIR``
(``experiments/dryrun_torch/``).  Those records are fake-tensor models:
``python -m repro_torch.launch.dryrun`` runs each step once as rank 0 of
a fake world on fake tensors (the card's route or the CPU's) and counts
its storages, collectives and operations.  Nothing here is a
measurement: no time, and no byte a device moved.

    PYTHONPATH=src python -m repro_torch.benchmarks.perf_variants
    PYTHONPATH=src python -m repro_torch.benchmarks.perf_variants --make \\
        --device cpu

Without ``--make`` a pair whose records are missing is skipped, as the
reference skips it; with ``--make`` each missing record is traced first
(:func:`make_record`, the flags of its tag from :data:`TAG_FLAGS`).
``python -m repro_torch.benchmarks.run perf`` reads the records.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.benchmarks.common import save_artifact
from repro_torch.launch import dryrun

SOURCE = ("records of python -m repro_torch.launch.dryrun: fake-tensor "
          "models traced on the CPU or the card's route, not measurements")

PAIRS = [
    ("H1 it1 cf=1.0", "deepseek-v3-671b__train_4k__single",
     "deepseek-v3-671b__train_4k__single_cf10"),
    ("H1 it3 scatter-down", "deepseek-v3-671b__train_4k__single",
     "deepseek-v3-671b__train_4k__single_cf10_bf16_scat"),
    ("H2 pad-heads qwen prefill", "qwen1.5-32b__prefill_32k__single",
     "qwen1.5-32b__prefill_32k__single_padheads"),
    ("H2 pad-heads qwen train", "qwen1.5-32b__train_4k__single",
     "qwen1.5-32b__train_4k__single_padheads"),
    ("H2 pad-heads minicpm3 prefill", "minicpm3-4b__prefill_32k__single",
     "minicpm3-4b__prefill_32k__single_padheads"),
    ("H2 pad-heads minicpm3 train", "minicpm3-4b__train_4k__single",
     "minicpm3-4b__train_4k__single_padheads"),
    ("H2 pad-heads whisper train", "whisper-large-v3__train_4k__single",
     "whisper-large-v3__train_4k__single_padheads"),
    ("H2 pad-heads whisper prefill", "whisper-large-v3__prefill_32k__single",
     "whisper-large-v3__prefill_32k__single_padheads"),
    ("H3 mla-absorb minicpm3 decode", "minicpm3-4b__decode_32k__single",
     "minicpm3-4b__decode_32k__single_absorb"),
    ("H3 mla-absorb deepseek decode", "deepseek-v3-671b__decode_32k__single",
     "deepseek-v3-671b__decode_32k__single_absorb"),
    ("H4 window-ring gemma3 500k", "gemma3-12b__long_500k__single",
     "gemma3-12b__long_500k__single_ring"),
    ("H6 one-hot embed (REFUTED)", "command-r-35b__train_4k__single",
     "command-r-35b__train_4k__single_onehot"),
]

# The reference's record names end in a free-form ``--tag``
# (src/repro/launch/dryrun.py's ``name = f"{arch}__{shape}__{mk}{tag}"``);
# these are the flags of ``dryrun.run_one`` each tag stands for, read off
# its label: "cf=1.0" the MoE capacity factor, "scatter-down" with the
# "bf16" of its tag the expert exchange's bf16 wire and scatter-down,
# "pad-heads" the heads padded to a multiple of the model axis (16),
# "mla-absorb", "window-ring" and "one-hot embed".
TAG_FLAGS = {
    "_cf10": {"capacity_factor": 1.0},
    "_cf10_bf16_scat": {"capacity_factor": 1.0, "moe_comm_bf16": True,
                        "moe_scatter_down": True},
    "_padheads": {"pad_heads": 16},
    "_absorb": {"mla_absorb": True},
    "_ring": {"window_ring": True},
    "_onehot": {"embed_one_hot": True},
}


def _path(name: str):
    return dryrun.RESULTS_DIR / f"{name}.json"


def _parse(name: str):
    """``arch__shape__<mesh><tag>`` -> (arch, shape, mesh, run_one's
    flags)."""
    arch, shape, rest = name.split("__")
    mesh = next(m for m in ("single", "multi") if rest.startswith(m))
    return arch, shape, mesh, TAG_FLAGS[rest[len(mesh):]] if rest != mesh \
        else {}


def make_record(name: str, device=None) -> dict:
    """Trace the record ``name`` (``dryrun.run_one`` with its tag's
    flags) and write it where :func:`main` reads it."""
    arch, shape, mesh, flags = _parse(name)
    rec = dryrun.run_one(arch, shape, mesh, device=device, **flags)
    dryrun.RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    _path(name).write_text(json.dumps(rec, indent=1))
    return rec


def main(device="cuda", make: bool = False) -> dict:
    """The table over ``PAIRS`` whose records exist (with ``make``, each
    missing one traced on ``device`` first); the artifact
    ``perf_variants.json`` holds the rows and their source."""
    print(f"# {SOURCE}")
    print(f"{'iteration':>32s} {'temp GiB':>18s} {'coll B':>22s} "
          f"{'FLOPs':>22s}")
    rows = []
    for label, base, var in PAIRS:
        if make:
            for name in (base, var):
                if not _path(name).exists():
                    make_record(name, device)
        if not (_path(base).exists() and _path(var).exists()):
            continue
        b, v = (json.loads(_path(n).read_text()) for n in (base, var))
        tb = b["temp_size_in_bytes"] / 2**30
        tv = v["temp_size_in_bytes"] / 2**30
        cb = sum(b["collective_bytes"].values())
        cv = sum(v["collective_bytes"].values())
        fb, fv = b["flops"], v["flops"]
        rows.append({"iteration": label,
                     "temp_gib": [round(tb, 2), round(tv, 2)],
                     "coll_bytes": [cb, cv],
                     "flops": [fb, fv],
                     "device": [b["device"], v["device"]]})
        print(f"{label:>32s} {tb:8.2f}→{tv:8.2f} {cb:10.3g}→{cv:10.3g} "
              f"{fb:10.3g}→{fv:10.3g}")
    save_artifact("perf_variants", {"source": SOURCE, "rows": rows})
    best = max(rows, default=None,
               key=lambda r: r["temp_gib"][0] / max(r["temp_gib"][1], 1e-9))
    return {"n_variants": len(rows),
            "biggest_temp_reduction": best and best["iteration"]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--make", action="store_true",
                    help="trace each missing record first")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="the traces' fake tensors' device (default: "
                         "launch/dryrun.py's)")
    args = ap.parse_args()
    print(main(device=args.device, make=args.make))
