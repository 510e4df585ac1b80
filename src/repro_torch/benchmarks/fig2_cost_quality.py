"""Paper Figure 2: average token cost vs accuracy per method."""
from repro_torch.benchmarks.common import canonical_results, save_artifact


def main(device="cuda", init_params=None) -> dict:
    _, res, _, _ = canonical_results(device, init_params)
    pts = [{"slo": r["slo"], "method": r["method"], "cost": r["cost"],
            "acc": r["acc"]} for r in res.rows]
    save_artifact("fig2_cost_quality", pts)
    print(f"{'slo':>14s} {'method':>16s} {'cost':>8s} {'acc':>6s}")
    for p in pts:
        print(f"{p['slo']:>14s} {p['method']:>16s} {p['cost']:8.1f} "
              f"{p['acc']:6.3f}")
    # derived: pareto check — learned quality policy should not be
    # dominated (higher cost AND lower acc) by the best fixed action
    rows = {(r["slo"], r["method"]): r for r in res.rows}
    ce = rows[("quality_first", "argmax_ce")]
    bf = [r for (s, m), r in rows.items()
          if s == "quality_first" and m.startswith("best-fixed")][0]
    dominated = ce["cost"] > bf["cost"] and ce["acc"] < bf["acc"]
    return {"quality_ce_cost": ce["cost"], "quality_ce_acc": ce["acc"],
            "dominated_by_best_fixed": dominated}


if __name__ == "__main__":
    print(main())
