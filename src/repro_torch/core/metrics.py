"""Evaluation metrics and reporting (paper §5.1 conventions).

* accuracy — normalized exact match (the simulator scores EM directly);
* avg_cost_tokens — prompt + completion tokens;
* hallucination_rate — incorrect answer where refusal was appropriate;
* refusal_rate;
* retrieval_hit_rate — answerable questions only: gold answer string
  contained in the retrieved set.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.core.config import SLOProfile
from repro_torch.core.offline_log import OfflineLog


@dataclass
class PolicyReport:
    name: str
    acc: float
    cost: float
    reward: float
    refusal_rate: float
    hallucination_rate: float
    hit_rate: float
    action_dist: np.ndarray

    def row(self) -> Dict[str, float]:
        d = {"method": self.name, "acc": round(self.acc, 3),
             "cost": round(self.cost, 1), "reward": round(self.reward, 4),
             "refuse": round(self.refusal_rate, 3),
             "hall": round(self.hallucination_rate, 3),
             "hit": round(self.hit_rate, 3)}
        d["action_dist"] = [round(float(x), 3) for x in self.action_dist]
        return d


def evaluate_actions(log: OfflineLog, actions: np.ndarray,
                     profile: SLOProfile, name: str = "") -> PolicyReport:
    """Score a per-state action assignment against the logged sweep."""
    n = log.n
    idx = np.arange(n)
    r = log.rewards(profile)[idx, actions]
    ans = log.answerable.astype(bool)
    hall = log.hallucinated[idx, actions]
    # hallucination defined on queries where refusal was appropriate
    unans = ~ans
    hall_rate = float(hall[unans].mean()) if unans.any() else 0.0
    hit = log.hit[idx, actions]
    # sized to the LOGGED action space (paper5's 5, hybrid9's 9, ...)
    dist = np.bincount(actions, minlength=log.n_actions) / n
    return PolicyReport(
        name=name,
        acc=float(log.correct[idx, actions].mean()),
        cost=float(log.cost[idx, actions].mean()),
        reward=float(r.mean()),
        refusal_rate=float(log.refused[idx, actions].mean()),
        hallucination_rate=hall_rate,
        hit_rate=float(hit[ans].mean()) if ans.any() else 0.0,
        action_dist=dist,
    )


def fixed_action_report(log: OfflineLog, action: int, profile: SLOProfile,
                        name: str = "") -> PolicyReport:
    acts = np.full(log.n, action, np.int64)
    return evaluate_actions(log, acts, profile,
                            name or f"fixed(a{action})")


def best_fixed_action(log: OfflineLog, profile: SLOProfile):
    """The single action maximizing average reward (paper §5.3)."""
    r = log.rewards(profile)
    means = r.mean(axis=0)
    a = int(np.argmax(means))
    return a, fixed_action_report(log, a, profile, f"best-fixed(a{a})")
