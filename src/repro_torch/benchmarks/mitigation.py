"""Paper §7.1 mitigation: Lagrangian refusal cap vs vanilla Argmax-CE
under the cheap SLO — the practical fix for refusal collapse."""
from repro_torch.benchmarks.common import canonical_results, save_artifact


def main(device="cuda", init_params=None) -> dict:
    _, res, extras, _ = canonical_results(device, init_params)
    rows = {(r["slo"], r["method"]): r for r in res.rows}
    ce = rows[("cheap", "argmax_ce")]
    con = rows.get(("cheap", "constrained"))
    if con is None:
        raise RuntimeError("constrained objective missing from experiment")
    out = {
        "cheap_argmax_ce": {k: ce[k] for k in
                            ("acc", "cost", "reward", "refuse")},
        "cheap_constrained": {k: con[k] for k in
                              ("acc", "cost", "reward", "refuse")},
        "lagrange_final": extras["train_hist"]
        .get("cheap/constrained", {}).get("lambda"),
    }
    save_artifact("mitigation", out)
    print(f"{'method':>22s} {'acc':>6s} {'cost':>8s} {'reward':>8s} {'refuse':>7s}")
    for name, r in (("argmax_ce (collapsed)", ce), ("constrained", con)):
        print(f"{name:>22s} {r['acc']:6.3f} {r['cost']:8.1f} "
              f"{r['reward']:+8.4f} {r['refuse']:7.3f}")
    return {"refusal_reduction": round(ce["refuse"] - con["refuse"], 3),
            "acc_recovered": round(con["acc"] - ce["acc"], 3)}


if __name__ == "__main__":
    print(main())
