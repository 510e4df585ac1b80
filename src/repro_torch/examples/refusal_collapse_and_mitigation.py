"""Failure-mode demo (paper §6.2/§7.1): refusal collapse under the cheap
SLO and the Lagrangian refusal-cap mitigation, through the routing API.
The routers train on ``--device`` (the card unless ``--device cpu``).

    PYTHONPATH=src python -m repro_torch.examples.refusal_collapse_and_mitigation \\
        [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.core.config import RouterConfig, TestbedConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.metrics import best_fixed_action, evaluate_actions
from repro_torch.core.offline_log import build_testbed
from repro_torch.routing import ConstrainedPolicy, MLPPolicy, get_slo_profile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = TestbedConfig(n_train=400, n_eval=150, n_paragraphs=300,
                        router=RouterConfig(n_epochs=20))
    _, _, _, train_log, eval_log = build_testbed(cfg)
    profile = get_slo_profile("cheap")
    rewards = train_log.rewards(profile)

    print("== cheap SLO: vanilla Argmax-CE (collapses) ==")
    policy = MLPPolicy.train(train_log, rewards, cfg.router,
                             objective="argmax_ce", device=device)
    rep = evaluate_actions(eval_log, policy.actions(eval_log.states),
                           profile, "argmax_ce")
    print(rep.row())

    print("\n== mitigation: Lagrangian refusal cap (0.45) ==")
    con = ConstrainedPolicy.train(train_log, rewards, cfg.router,
                                  refusal_cap=0.45, device=device)
    repc = evaluate_actions(eval_log, con.actions(eval_log.states),
                            profile, "constrained")
    print(repc.row())
    print(f"final lambda = {con.lagrange:.3f}")

    _, bf = best_fixed_action(eval_log, profile)
    print(f"\nbest fixed action reward: {bf.reward:+.4f}")
    print(f"collapsed policy reward:  {rep.reward:+.4f} "
          f"(refusal {rep.refusal_rate:.2f})")
    print(f"mitigated policy reward:  {repc.reward:+.4f} "
          f"(refusal {repc.refusal_rate:.2f})")
    return rep, repc, bf


if __name__ == "__main__":
    main()
