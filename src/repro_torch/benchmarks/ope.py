"""Beyond-paper (§8 future work): counterfactual estimators (IPS / SNIPS /
Doubly-Robust) evaluated against the exactly-known policy value."""
from repro_torch.benchmarks.common import (canonical_results, initial,
                                           save_artifact)
from repro_torch.core.actions import SLO_PROFILES
from repro_torch.core.ope import estimator_suite
from repro_torch.core.policy import policy_actions, train_policy


def main(device="cuda", init_params=None) -> dict:
    cfg, _, _, (train_log, eval_log) = canonical_results(device, init_params)
    profile = SLO_PROFILES["quality_first"]
    tr = train_policy(train_log, train_log.rewards(profile), cfg.router,
                      objective="argmax_ce",
                      init_params=initial(init_params, cfg.router),
                      device=device)
    target = policy_actions(tr.params, eval_log.states, cfg.router)
    rewards = eval_log.rewards(profile)
    out = {}
    for kind in ("uniform", "eps_anchor"):
        out[kind] = estimator_suite(rewards, eval_log.states, target,
                                    kind=kind, seeds=30)
    save_artifact("ope", out)
    print(f"{'logging':>11s} {'estimator':>10s} {'value':>8s} {'bias':>8s} {'rmse':>8s}")
    for kind, suite in out.items():
        for est, stats in suite.items():
            print(f"{kind:>11s} {est:>10s} {stats['value']:+8.4f} "
                  f"{stats['bias']:+8.4f} {stats['rmse']:8.4f}")
    return {
        "snips_rmse_uniform": round(out["uniform"]["snips"]["rmse"], 4),
        "ips_rmse_uniform": round(out["uniform"]["ips"]["rmse"], 4),
        "dr_rmse_uniform": round(out["uniform"]["dr"]["rmse"], 4),
    }


if __name__ == "__main__":
    print(main())
