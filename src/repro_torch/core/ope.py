"""Off-policy evaluation estimators — the paper's §8 "future work on
counterfactual estimators", implemented beyond the paper.

Because the testbed logs the FULL action sweep, the ground-truth value
of any deterministic policy is exactly computable; we can therefore
measure estimator error directly.  We synthesize a partial log by
sampling one action per state from a logging policy, then estimate the
target policy's value with IPS, SNIPS [Swaminathan & Joachims 2015] and
Doubly Robust [Dudík, Langford & Li 2011].
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.core.actions import N_ACTIONS


@dataclass
class PartialLog:
    actions: np.ndarray     # (N,) logged action
    rewards: np.ndarray     # (N,) observed reward
    propensity: np.ndarray  # (N,) logging prob of the logged action
    states: np.ndarray      # (N, d)


def make_logging_policy(n_actions: int = N_ACTIONS, kind: str = "uniform",
                        anchor: int = 1, eps: float = 0.25) -> np.ndarray:
    """Returns per-action probabilities (A,) of the logging policy."""
    if kind == "uniform":
        return np.full(n_actions, 1.0 / n_actions)
    if kind == "eps_anchor":  # mostly the paper's fixed baseline action
        p = np.full(n_actions, eps / n_actions)
        p[anchor] += 1.0 - eps
        return p
    raise ValueError(kind)


def sample_partial_log(full_rewards: np.ndarray, states: np.ndarray,
                       log_probs: np.ndarray, seed: int = 0) -> PartialLog:
    rng = np.random.default_rng(seed)
    n = len(full_rewards)
    acts = rng.choice(len(log_probs), size=n, p=log_probs)
    return PartialLog(
        actions=acts,
        rewards=full_rewards[np.arange(n), acts],
        propensity=log_probs[acts],
        states=states)


def true_value(full_rewards: np.ndarray, target_actions: np.ndarray) -> float:
    return float(full_rewards[np.arange(len(full_rewards)),
                              target_actions].mean())


def ips(log: PartialLog, target_actions: np.ndarray,
        clip: float = 50.0) -> float:
    match = (log.actions == target_actions).astype(np.float64)
    w = np.minimum(match / log.propensity, clip)
    return float(np.mean(w * log.rewards))


def snips(log: PartialLog, target_actions: np.ndarray,
          clip: float = 50.0) -> float:
    match = (log.actions == target_actions).astype(np.float64)
    w = np.minimum(match / log.propensity, clip)
    denom = np.mean(w)
    return float(np.mean(w * log.rewards) / max(denom, 1e-9))


def _ridge_q(log: PartialLog, lam: float = 1.0) -> np.ndarray:
    """Direct method: per-action ridge regression q̂(s, a).  Returns
    (N, A) predicted rewards."""
    n, d = log.states.shape
    q = np.zeros((n, N_ACTIONS))
    for a in range(N_ACTIONS):
        mask = log.actions == a
        if mask.sum() < 3:
            continue
        X = log.states[mask]
        y = log.rewards[mask]
        A = X.T @ X + lam * np.eye(d)
        beta = np.linalg.solve(A, X.T @ y)
        q[:, a] = log.states @ beta
    return q


def doubly_robust(log: PartialLog, target_actions: np.ndarray,
                  clip: float = 50.0) -> float:
    q = _ridge_q(log)
    n = len(target_actions)
    dm = q[np.arange(n), target_actions]
    match = (log.actions == target_actions).astype(np.float64)
    w = np.minimum(match / log.propensity, clip)
    corr = w * (log.rewards - q[np.arange(n), log.actions])
    return float(np.mean(dm + corr))


def estimator_suite(full_rewards: np.ndarray, states: np.ndarray,
                    target_actions: np.ndarray, *, kind: str = "uniform",
                    seeds: int = 20) -> Dict[str, Dict[str, float]]:
    """Bias/RMSE of each estimator over logging-seed replicates."""
    probs = make_logging_policy(kind=kind)
    truth = true_value(full_rewards, target_actions)
    res = {name: [] for name in ("ips", "snips", "dr")}
    for s in range(seeds):
        plog = sample_partial_log(full_rewards, states, probs, seed=s)
        res["ips"].append(ips(plog, target_actions))
        res["snips"].append(snips(plog, target_actions))
        res["dr"].append(doubly_robust(plog, target_actions))
    out = {"truth": {"value": truth, "bias": 0.0, "rmse": 0.0}}
    for name, vals in res.items():
        v = np.asarray(vals)
        out[name] = {"value": float(v.mean()),
                     "bias": float(v.mean() - truth),
                     "rmse": float(np.sqrt(((v - truth) ** 2).mean()))}
    return out
