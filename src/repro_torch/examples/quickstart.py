"""Quickstart: the paper in miniature.

Builds a small synthetic SQuAD-2.0 testbed, generates the offline
action-sweep log, trains Argmax-CE under both SLO profiles, prints the
cost/quality table — including the refusal-collapse failure mode — and
then serves live traffic through the unified routing API:

    policy  = MLPPolicy.train(...)          # any RoutingPolicy
    gateway = Gateway(policy, SimulatorBackend(pipe), ...)
    stats   = gateway.serve(requests)       # route -> execute -> account

The routers train on ``--device`` (the card unless ``--device cpu``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.core.config import RouterConfig, TestbedConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.experiment import run_experiment
from repro_torch.routing import (Gateway, MLPPolicy, Request,
                                 SimulatorBackend, get_slo_profile)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = TestbedConfig(n_train=300, n_eval=100, n_paragraphs=300,
                        router=RouterConfig(n_epochs=15))
    res, extras, (train_log, eval_log) = run_experiment(
        cfg, verbose=True, device=device)
    print("\nAction distributions (Fig 1):")
    for k, d in extras["action_dists"].items():
        print(f"  {k:28s} {[round(x, 2) for x in d]}")
    ce_cheap = [r for r in res.rows
                if r["slo"] == "cheap" and r["method"] == "argmax_ce"][0]
    print(f"\nRefusal collapse under cheap SLO: refusal_rate="
          f"{ce_cheap['refuse']:.2f}, acc={ce_cheap['acc']:.2f}")

    # --- live serving through the Gateway (the production entry point) ---
    data, index, pipe = extras["testbed"]
    policy = MLPPolicy.train(
        train_log, train_log.rewards(get_slo_profile("cheap")),
        cfg.router, objective="argmax_ce", device=device)
    gateway = Gateway(policy, SimulatorBackend(pipe),
                      router_cfg=cfg.router, index=index, max_batch=20,
                      adaptive_refusal=True, base_refusal_share=0.5)
    stats = gateway.serve([Request(qid=q.qid, question=q, slo="cheap")
                           for q in data.questions[-60:]])
    print(f"\nGateway served {stats.served} requests under cheap SLO: "
          f"avg reward {stats.avg_reward:+.4f}, "
          f"refusal share {gateway.refusal_share:.2f} "
          f"(budget back-pressure capped the collapse)")
    return res, stats


if __name__ == "__main__":
    main()
