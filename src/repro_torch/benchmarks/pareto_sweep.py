"""Beyond paper: where does refusal collapse begin?

Sweep interpolated SLO profiles from quality_first (t=0) to cheap (t=1)
and track the learned policy's refusal rate and reward — locating the
collapse onset the paper observes only at the endpoints."""
from repro_torch.benchmarks.common import (bar, canonical_results, initial,
                                           save_artifact)
from repro_torch.core.conditioned import interpolate
from repro_torch.core.metrics import evaluate_actions
from repro_torch.routing import MLPPolicy, get_slo_profile

TS = [0.0, 0.2, 0.4, 0.6, 0.8, 1.0]


def main(device="cuda", init_params=None) -> dict:
    cfg, _, _, (train_log, eval_log) = canonical_results(device, init_params)
    a, b = get_slo_profile("quality_first"), get_slo_profile("cheap")
    rows = []
    for t in TS:
        p = interpolate(a, b, t)
        policy = MLPPolicy.train(train_log, train_log.rewards(p), cfg.router,
                                 objective="argmax_ce",
                                 init_params=initial(init_params, cfg.router),
                                 device=device)
        acts = policy.actions(eval_log.states)
        rep = evaluate_actions(eval_log, acts, p, f"t={t}")
        rows.append({"t": t, "refusal": rep.refusal_rate, "acc": rep.acc,
                     "reward": rep.reward, "cost": rep.cost,
                     "refuse_share": float(rep.action_dist[4])})
    save_artifact("pareto_sweep", rows)
    print("  t   refusal  a4-share  acc    cost")
    for r in rows:
        print(f"{r['t']:4.1f}  {r['refusal']:6.3f}  {r['refuse_share']:6.3f} "
              f" {r['acc']:5.3f} {r['cost']:7.1f}  {bar(r['refuse_share'], 30)}")
    onset = next((r["t"] for r in rows if r["refuse_share"] > 0.5), None)
    return {"collapse_onset_t": onset,
            "endpoint_refusals": [rows[0]["refusal"], rows[-1]["refusal"]]}


if __name__ == "__main__":
    print(main())
