"""Paper Table 1: {SLO} × {baseline, best-fixed, Argmax-CE, Argmax-CE-WT}
(+ beyond-paper constrained objective) on the N=200 eval split."""
from repro_torch.benchmarks.common import canonical_results, save_artifact


def main(device="cuda", init_params=None) -> dict:
    cfg, res, extras, logs = canonical_results(device, init_params)
    save_artifact("table1_slo_grid", res.rows)
    print(res.table())
    rows = {(r["slo"], r["method"]): r for r in res.rows}
    bf_q = [r for (s, m), r in rows.items()
            if s == "quality_first" and m.startswith("best-fixed")][0]
    ce_q = rows[("quality_first", "argmax_ce")]
    ce_c = rows[("cheap", "argmax_ce")]
    bf_c = [r for (s, m), r in rows.items()
            if s == "cheap" and m.startswith("best-fixed")][0]
    return {
        "quality_ce_minus_bestfixed_reward":
            round(ce_q["reward"] - bf_q["reward"], 4),
        "cheap_ce_refusal": ce_c["refuse"],
        "cheap_collapse_reward_gap": round(ce_c["reward"] - bf_c["reward"], 4),
        "best_fixed_quality": bf_q["method"],
        "best_fixed_cheap": bf_c["method"],
    }


if __name__ == "__main__":
    print(main())
