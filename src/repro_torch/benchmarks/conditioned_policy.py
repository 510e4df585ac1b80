"""Beyond paper: one SLO-conditioned policy vs per-profile policies,
including generalization to an UNSEEN interpolated profile."""
import dataclasses

from repro_torch.benchmarks.common import (canonical_results, initial,
                                           save_artifact)
from repro_torch.core.conditioned import interpolate, profile_vector
from repro_torch.core.metrics import best_fixed_action, evaluate_actions
from repro_torch.routing import (ConditionedPolicy, MLPPolicy,
                                 get_slo_profile, list_slo_profiles)


def main(device="cuda", init_params=None) -> dict:
    cfg, _, _, (train_log, eval_log) = canonical_results(device, init_params)
    profiles = [get_slo_profile("quality_first"), get_slo_profile("cheap")]
    # the conditioned router's config: the state grown by the profile
    # vector (``train_conditioned``'s ``ccfg``)
    ccfg = dataclasses.replace(
        cfg.router, state_dim=cfg.router.state_dim
        + len(profile_vector(profiles[0])), condition_on_slo=True)
    cond = ConditionedPolicy.train(train_log, profiles, cfg.router,
                                   init_params=initial(init_params, ccfg),
                                   device=device)

    rows = []
    for p in profiles + [interpolate(profiles[0], profiles[1], 0.5)]:
        acts_c = cond.route(eval_log.states, p).actions
        rep_c = evaluate_actions(eval_log, acts_c, p, f"conditioned@{p.name}")
        rows.append(rep_c.row())
        # per-profile specialist for comparison (seen profiles only)
        if p.name in list_slo_profiles():
            spec = MLPPolicy.train(train_log, train_log.rewards(p),
                                   cfg.router, objective="argmax_ce",
                                   init_params=initial(init_params,
                                                       cfg.router),
                                   device=device)
            rows.append(evaluate_actions(eval_log,
                                         spec.actions(eval_log.states), p,
                                         f"specialist@{p.name}").row())
        _, bf = best_fixed_action(eval_log, p)
        rows.append({**bf.row(), "method": f"best-fixed@{p.name}"})

    save_artifact("conditioned_policy", rows)
    for r in rows:
        print(f"{r['method']:38s} reward={r['reward']:+8.4f} "
              f"acc={r['acc']:.3f} cost={r['cost']:7.1f} "
              f"refuse={r['refuse']:.2f}")
    cond = {r["method"]: r for r in rows}
    gap_q = (cond["conditioned@quality_first"]["reward"]
             - cond["specialist@quality_first"]["reward"])
    return {"conditioned_vs_specialist_quality_gap": round(gap_q, 4),
            "unseen_mix_reward":
                cond[[k for k in cond if k.startswith("conditioned@mix")][0]]
                ["reward"]}


if __name__ == "__main__":
    print(main())
