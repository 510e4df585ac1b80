"""End-to-end paper experiment: build testbed → train policies → report.

Reproduces the paper's Table 1 grid: {quality_first, cheap} ×
{Baseline(a1), Best-fixed, Argmax-CE, Argmax-CE-WT} (+ beyond-paper
objectives), and the Figure 1 action distributions.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

from repro_torch.core.actions import SLO_PROFILES
from repro_torch.core.config import RouterConfig, TestbedConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.metrics import (PolicyReport, best_fixed_action,
                                      evaluate_actions, fixed_action_report)
from repro_torch.core.offline_log import build_testbed
from repro_torch.routing.policy import MLPPolicy


@dataclass
class ExperimentResult:
    rows: List[dict] = field(default_factory=list)

    def add(self, slo: str, report: PolicyReport):
        self.rows.append({"slo": slo, **report.row()})

    def table(self) -> str:
        cols = ["slo", "method", "acc", "cost", "reward", "refuse",
                "hall", "hit"]
        lines = [" | ".join(f"{c:>13s}" for c in cols)]
        for r in self.rows:
            lines.append(" | ".join(f"{str(r[c]):>13s}" for c in cols))
        return "\n".join(lines)

    def save(self, path):
        Path(path).write_text(json.dumps(self.rows, indent=1))


def run_experiment(cfg: Optional[TestbedConfig] = None,
                   objectives=("argmax_ce", "argmax_ce_wt"),
                   include_mitigation: bool = False,
                   refusal_cap: float = 0.5,
                   verbose: bool = True, *,
                   init_params: Optional[Callable[[RouterConfig], dict]] = None,
                   device="cuda"):
    """Build the testbed, train every objective under every SLO profile
    on ``device`` and score each on the eval log.

    ``init_params(router_cfg)`` gives each training's initial params
    (default: the seeded draw).  ``extras["seconds"]`` holds the host
    seconds of the testbed build and of each training (each ends with
    its last epoch's read back, so the device has finished).
    """
    cfg = cfg or TestbedConfig()
    resolve_device(device)
    t0 = time.perf_counter()
    data, index, pipe, train_log, eval_log = build_testbed(cfg)
    res = ExperimentResult()
    extras: Dict[str, dict] = {"train_hist": {}, "action_dists": {},
                               "testbed": (data, index, pipe),
                               "seconds": {"build_testbed":
                                           time.perf_counter() - t0}}

    for slo_name, profile in SLO_PROFILES.items():
        # fixed baselines (paper §5.3)
        res.add(slo_name, fixed_action_report(eval_log, 1, profile,
                                              "baseline(a1)"))
        bf_a, bf_rep = best_fixed_action(eval_log, profile)
        res.add(slo_name, bf_rep)

        train_rewards = train_log.rewards(profile)
        objs = list(objectives)
        if include_mitigation:
            objs.append("constrained")
        for obj in objs:
            t0 = time.perf_counter()
            policy = MLPPolicy.train(
                train_log, train_rewards, cfg.router, objective=obj,
                refusal_cap=refusal_cap, device=device,
                init_params=None if init_params is None
                else init_params(cfg.router))
            extras["seconds"][f"{slo_name}/{obj}"] = time.perf_counter() - t0
            acts = policy.actions(eval_log.states)
            rep = evaluate_actions(eval_log, acts, profile, obj)
            res.add(slo_name, rep)
            extras["train_hist"][f"{slo_name}/{obj}"] = \
                policy.train_result.history[-1]
            extras["action_dists"][f"{slo_name}/{obj}"] = \
                [float(x) for x in rep.action_dist]
        if verbose:
            print(f"[{slo_name}] best fixed = a{bf_a}")

    if verbose:
        print(res.table())
    return res, extras, (train_log, eval_log)
