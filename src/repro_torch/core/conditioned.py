"""Beyond paper: a single SLO-conditioned policy.

The paper trains one policy per SLO profile.  Here the profile's weight
vector is appended to the state so ONE router serves every profile —
including interpolated profiles never seen at training time (the Pareto
sweep benchmark).  This is the natural production deployment: the SLO is
a request header, not a model version.

Serving-side access goes through the
:class:`repro_torch.routing.policy.ConditionedPolicy` adapter, which wraps
``train_conditioned`` and appends the profile vector per request inside
``route``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.config import RouterConfig, SLOProfile
from repro_torch.core.offline_log import OfflineLog
from repro_torch.core.policy import TrainResult, policy_actions, train_policy


def profile_vector(p: SLOProfile) -> np.ndarray:
    return np.array([p.w_acc, p.w_cost, p.w_hall, p.w_ref, p.w_ref_wrong],
                    np.float32)


def conditioned_states(log: OfflineLog, p: SLOProfile) -> np.ndarray:
    v = np.tile(profile_vector(p)[None], (log.n, 1))
    return np.concatenate([log.states, v], axis=1)


def interpolate(a: SLOProfile, b: SLOProfile, t: float) -> SLOProfile:
    mix = lambda x, y: (1 - t) * x + t * y
    return SLOProfile(
        name=f"mix({a.name},{b.name},{t:.2f})",
        w_acc=mix(a.w_acc, b.w_acc), w_cost=mix(a.w_cost, b.w_cost),
        w_hall=mix(a.w_hall, b.w_hall), w_ref=mix(a.w_ref, b.w_ref),
        w_ref_wrong=mix(a.w_ref_wrong, b.w_ref_wrong))


def train_conditioned(log: OfflineLog, profiles: Sequence[SLOProfile],
                      cfg: RouterConfig, *, objective: str = "argmax_ce",
                      n_interp: int = 3, init_params=None, device="cuda"
                      ) -> Tuple[TrainResult, RouterConfig]:
    """Train one policy on the union of profile-conditioned examples;
    returns the result and the conditioned config (``state_dim`` grown
    by the profile vector's 5).

    ``n_interp`` adds interpolated profiles between consecutive training
    profiles so the conditioning dimension is densely covered.
    ``init_params`` and ``device`` go to ``train_policy``.
    """
    all_profiles: List[SLOProfile] = list(profiles)
    for a, b in zip(profiles[:-1], profiles[1:]):
        for i in range(1, n_interp + 1):
            all_profiles.append(interpolate(a, b, i / (n_interp + 1)))

    states = np.concatenate(
        [conditioned_states(log, p) for p in all_profiles], axis=0)
    rewards = np.concatenate([log.rewards(p) for p in all_profiles], axis=0)

    big = _concat_logs(log, len(all_profiles), states)
    ccfg = dataclasses.replace(
        cfg, state_dim=states.shape[1], condition_on_slo=True)
    return train_policy(big, rewards, ccfg, objective=objective,
                        init_params=init_params, device=device), ccfg


def _concat_logs(log: OfflineLog, k: int, states: np.ndarray) -> OfflineLog:
    rep = lambda x: np.concatenate([x] * k, axis=0)
    return OfflineLog(states, rep(log.correct), rep(log.refused),
                      rep(log.hallucinated), rep(log.cost), rep(log.hit),
                      rep(log.answerable), rep(log.qids),
                      refuse_action=log.refuse_action)


def conditioned_actions(result: TrainResult, ccfg: RouterConfig,
                        log: OfflineLog, p: SLOProfile) -> np.ndarray:
    return policy_actions(result.params, conditioned_states(log, p), ccfg)
