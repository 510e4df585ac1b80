"""Benchmark harness — one function per paper table/figure.

Prints ``name,us_per_call,derived`` CSV (one row per benchmark) after
each benchmark's own report.  Artifacts land in
``src/repro_torch/benchmarks/artifacts/``.  Every policy trains on
``--device`` (the card unless ``--device cpu``).

    PYTHONPATH=src python -m repro_torch.benchmarks.run             # all
    PYTHONPATH=src python -m repro_torch.benchmarks.run table1 ope  # a subset
    PYTHONPATH=src python -m repro_torch.benchmarks.run --device cpu

The ten paper benches, and ``perf``: the §Perf before/after table from
the records of ``python -m repro_torch.launch.dryrun`` (fake-tensor
models, not measurements; :mod:`repro_torch.benchmarks.perf_variants`,
whose ``--make`` traces the missing ones).  The repository's
``benchmarks/run.py`` also lists benches without a twin here:
``kernels``, ``serving``, ``retrieval`` and ``chaos`` write the JAX
package's measurement rows and wait for a benchmark of the port
(ROADMAP.md queue 1, item 10); ``roofline`` is no paper bench: the
port's twin is ``python -m repro_torch.analysis.roofline`` over the
dry run's records (H100 constants).
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.benchmarks import (conditioned_policy, fig1_action_dist,
                                    fig2_cost_quality, fig3_reward,
                                    mitigation, objectives_ablation, ope,
                                    pareto_sweep, perf_variants,
                                    seeds_ablation, table1_slo_grid)

BENCHMARKS = {
    "table1": table1_slo_grid.main,     # paper Table 1
    "fig1": fig1_action_dist.main,      # paper Figure 1
    "fig2": fig2_cost_quality.main,     # paper Figure 2
    "fig3": fig3_reward.main,           # paper Figure 3
    "mitigation": mitigation.main,      # paper §7.1 mitigation
    "objectives": objectives_ablation.main,  # paper's objective ablation
    "ope": ope.main,                    # beyond paper (§8 future work)
    "conditioned": conditioned_policy.main,  # beyond paper
    "pareto": pareto_sweep.main,        # beyond paper: collapse onset
    "seeds": seeds_ablation.main,       # beyond paper: §8 uncertainty
    "perf": perf_variants.main,         # §Perf before/after from the dry
                                        # run's records (fake tensors)
}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*", metavar="NAME",
                    help=f"benchmarks to run (default all): "
                         f"{' '.join(BENCHMARKS)}")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    unknown = [n for n in args.names if n not in BENCHMARKS]
    if unknown:
        ap.error(f"unknown benchmark(s) {unknown}; choose from "
                 f"{list(BENCHMARKS)}")
    rows = []
    for name in args.names or list(BENCHMARKS):
        print(f"\n===== {name} =====")
        t0 = time.perf_counter()
        derived = BENCHMARKS[name](device=args.device)
        us = (time.perf_counter() - t0) * 1e6
        rows.append((name, us, derived))
    print("\nname,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.0f},{json.dumps(derived)}")
    return rows


if __name__ == "__main__":
    main()
