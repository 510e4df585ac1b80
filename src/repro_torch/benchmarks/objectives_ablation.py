"""The paper's namesake: objective ablation.

All four policy objectives (Argmax-CE, Argmax-CE-WT, reward-softmax
soft targets, constrained CE) under both SLO profiles on the canonical
testbed — the full grid behind the paper's "objective choice strongly
shapes learned behavior" conclusion.

Beyond the paper, the same grid runs over the ``hybrid9`` action space
(retriever ∈ {bm25, dense, hybrid} × depth × guarded/auto + refuse):
the paper's failure-mode convention — report the cheap-profile refusal
collapse and whether the constrained objective mitigates it — now with
retriever choice in the action set (the Lagrangian watches hybrid9's
refuse index 8 via the log's ``refuse_action``).
"""
from repro_torch.benchmarks.common import (canonical_hybrid9_logs,
                                           canonical_results, initial,
                                           save_artifact)
from repro_torch.core.metrics import best_fixed_action, evaluate_actions
from repro_torch.routing import MLPPolicy
# live registry view, iterated in registration order so artifact rows
# keep the seed ordering (quality_first before cheap)
from repro_torch.routing.registry import SLO_PROFILES, SPACE_DEFAULT_PROFILES

OBJECTIVES = ("argmax_ce", "argmax_ce_wt", "soft_reward", "constrained")


def _grid(space_name, router_cfg, train_log, eval_log, profiles, device,
          init_params):
    """One space's {profile × objective} grid -> artifact rows."""
    rows = []
    for slo, profile in profiles:
        rewards = train_log.rewards(profile)
        _, bf = best_fixed_action(eval_log, profile)
        rows.append({"space": space_name, "slo": slo, **bf.row()})
        for obj in OBJECTIVES:
            policy = MLPPolicy.train(train_log, rewards, router_cfg,
                                     objective=obj, refusal_cap=0.45,
                                     init_params=initial(init_params,
                                                         router_cfg),
                                     device=device)
            rep = evaluate_actions(eval_log, policy.actions(eval_log.states),
                                   profile, obj)
            rows.append({"space": space_name, "slo": slo, **rep.row()})
    return rows


def main(spaces=("paper5", "hybrid9"), device="cuda",
         init_params=None) -> dict:
    rows = []
    if "paper5" in spaces:
        cfg, _, _, (train_log, eval_log) = canonical_results(device,
                                                             init_params)
        rows += _grid("paper5", cfg.router, train_log, eval_log,
                      list(SLO_PROFILES.items()), device, init_params)
    if "hybrid9" in spaces:
        hcfg, hspace, (h_train, h_eval) = canonical_hybrid9_logs(device)
        profiles = [(name, SLO_PROFILES[name])
                    for name in SPACE_DEFAULT_PROFILES["hybrid9"]]
        rows += _grid("hybrid9", hcfg.router, h_train, h_eval, profiles,
                      device, init_params)
    save_artifact("objectives_ablation", rows)
    print(f"{'space':>8s} {'slo':>14s} {'objective':>16s} {'acc':>6s} "
          f"{'cost':>8s} {'reward':>8s} {'refuse':>7s}")
    for r in rows:
        print(f"{r['space']:>8s} {r['slo']:>14s} {r['method']:>16s} "
              f"{r['acc']:6.3f} {r['cost']:8.1f} {r['reward']:+8.4f} "
              f"{r['refuse']:7.3f}")
    by = {(r["space"], r["slo"], r["method"]): r for r in rows}
    out = {}
    if "paper5" in spaces:
        out.update({
            "cheap_soft_reward_refusal":
                by[("paper5", "cheap", "soft_reward")]["refuse"],
            "cheap_constrained_refusal":
                by[("paper5", "cheap", "constrained")]["refuse"],
            "quality_best_objective": max(
                (r for r in rows
                 if r["space"] == "paper5" and r["slo"] == "quality_first"),
                key=lambda r: r["reward"])["method"],
        })
    if "hybrid9" in spaces:
        # the paper's failure-mode check, now with retriever choice in
        # the action set: does cheap still collapse to refusal, and
        # does the constrained objective pull it back?
        out.update({
            "hybrid9_cheap_argmax_ce_refusal":
                by[("hybrid9", "cheap", "argmax_ce")]["refuse"],
            "hybrid9_cheap_constrained_refusal":
                by[("hybrid9", "cheap", "constrained")]["refuse"],
            "hybrid9_quality_best_objective": max(
                (r for r in rows
                 if r["space"] == "hybrid9" and r["slo"] == "quality_first"),
                key=lambda r: r["reward"])["method"],
        })
    return out


if __name__ == "__main__":
    print(main())
