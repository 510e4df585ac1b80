"""Adaptive SLO serving: the Gateway + SRE error budgets (beyond paper).

Serves a stream of requests under the collapse-prone cheap SLO with a
routing policy trained by vanilla Argmax-CE.  Without back-pressure the
policy refuses ~80% of requests; the error-budget tracker detects the
wrong-refusal burn and tightens the refusal share per batch — collapse
mitigation applied at SERVING time through the unified Gateway, no
retraining.  The router trains on ``--device`` (the card unless
``--device cpu``).

    PYTHONPATH=src python -m repro_torch.examples.adaptive_serving [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.core.config import RouterConfig, TestbedConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.offline_log import build_testbed
from repro_torch.routing import (Gateway, MLPPolicy, Request,
                                 SimulatorBackend, get_slo_profile)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = TestbedConfig(n_train=300, n_eval=100, n_paragraphs=300,
                        router=RouterConfig(n_epochs=15))
    data, index, pipe, train_log, _ = build_testbed(cfg)
    policy = MLPPolicy.train(
        train_log, train_log.rewards(get_slo_profile("cheap")),
        cfg.router, objective="argmax_ce", device=device)
    reqs = [Request(qid=q.qid, question=q, slo="cheap")
            for q in data.questions[-100:]]

    shares = {}
    for adaptive in (False, True):
        gw = Gateway(policy, SimulatorBackend(pipe),
                     router_cfg=cfg.router, index=index, max_batch=20,
                     adaptive_refusal=adaptive, base_refusal_share=0.5)
        stats = gw.serve(list(reqs))
        print(f"adaptive={str(adaptive):5s} served={stats.served} "
              f"refusal_share={gw.refusal_share:.2f} "
              f"avg_reward={stats.avg_reward:+.4f}")
        for name, rep in gw.budget.report().items():
            print(f"    budget {name:13s} violation={rep.violation_rate:.3f}"
                  f" consumed={rep.budget_consumed:5.2f}"
                  f" healthy={rep.healthy}")
        shares[adaptive] = (stats, gw.refusal_share)
    return shares


if __name__ == "__main__":
    main()
