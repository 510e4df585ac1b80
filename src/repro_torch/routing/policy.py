"""The :class:`RoutingPolicy` protocol and its adapters.

One interface for every way the system can pick an action per request:

* :class:`FixedPolicy` — the paper's fixed baselines (always a_i);
* :class:`MLPPolicy` — the trained routing MLP (any objective from
  ``core/policy.py``: argmax_ce, argmax_ce_wt, soft_reward);
* :class:`ConstrainedPolicy` — the Lagrangian refusal-capped variant;
* :class:`ConditionedPolicy` — the SLO-conditioned single policy from
  ``core/conditioned.py`` (profile weights appended to the state).

``route(states, slo, context) -> RoutingDecision`` is vectorized over
the batch; the MLP's forward pass runs in torch on its params' device.
Inference-time constraints (the adaptive refusal cap the Gateway
derives from error-budget burn) are applied inside ``route`` via
:func:`apply_refusal_cap` and recorded on the decision.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Protocol, Sequence, Union, runtime_checkable

import numpy as np

from repro_torch.core.conditioned import profile_vector, train_conditioned
from repro_torch.core.config import RouterConfig, SLOProfile
from repro_torch.core.policy import host_logits, train_policy
from repro_torch.routing.registry import (ActionSpace, get_action_space,
                                          get_slo_profile)

SLOLike = Union[None, str, SLOProfile, Sequence[Union[str, SLOProfile]]]


@dataclass(frozen=True)
class RoutingContext:
    """Per-call serving context the Gateway threads into ``route``."""

    refusal_cap: Optional[float] = None   # max refuse share of this batch
    action_space: Optional[ActionSpace] = None


@dataclass
class RoutingDecision:
    """What the policy decided for one batch, and why."""

    actions: np.ndarray                 # (B,) int64
    logits: Optional[np.ndarray] = None  # (B, A) raw policy scores
    confidences: Optional[np.ndarray] = None  # (B,) p(chosen action)
    constraints: Dict[str, float] = field(default_factory=dict)
    policy: str = ""

    @property
    def n(self) -> int:
        return len(self.actions)


@runtime_checkable
class RoutingPolicy(Protocol):
    """Anything that can route a batch of request states to actions."""

    name: str

    def route(self, states: np.ndarray, slo: SLOLike = None,
              context: Optional[RoutingContext] = None) -> RoutingDecision:
        ...


def apply_refusal_cap(logits: np.ndarray, acts: np.ndarray, cap: float,
                      refuse_action: int) -> int:
    """Demote the least-confident refusals until ≤ ``cap`` of the batch
    refuses; returns the number of demotions.  Mutates ``acts``.

    This is the serving-time collapse mitigation (paper §7.1 made
    adaptive): each demoted request falls back to its runner-up action.
    """
    is_ref = acts == refuse_action
    n_allowed = int(cap * len(acts))
    n_demote = int(is_ref.sum()) - n_allowed
    if n_demote <= 0:
        return 0
    margin = logits[:, refuse_action] - np.partition(logits, -2, axis=1)[:, -2]
    order = np.argsort(np.where(is_ref, margin, np.inf))
    for i in order[:n_demote]:
        runner = np.argsort(logits[i])[-2]
        acts[i] = runner
    return n_demote


def _decision_from_logits(logits: np.ndarray, name: str,
                          context: Optional[RoutingContext]) -> RoutingDecision:
    """argmax + optional refusal-cap constraint + confidences."""
    logits = np.asarray(logits)
    acts = logits.argmax(axis=-1).astype(np.int64)
    constraints: Dict[str, float] = {}
    cap = context.refusal_cap if context else None
    if cap is not None:
        space = (context.action_space if context and context.action_space
                 else get_action_space())
        ref = space.refuse_action
        if ref is not None:
            n_demoted = apply_refusal_cap(logits, acts, cap, ref)
            constraints["refusal_cap"] = float(cap)
            constraints["n_demoted"] = float(n_demoted)
    z = logits - logits.max(axis=-1, keepdims=True)
    p = np.exp(z) / np.exp(z).sum(axis=-1, keepdims=True)
    conf = p[np.arange(len(acts)), acts]
    return RoutingDecision(actions=acts, logits=logits, confidences=conf,
                           constraints=constraints, policy=name)


# ---------------------------------------------------------------------------
# Adapters
# ---------------------------------------------------------------------------


class FixedPolicy:
    """The paper's fixed baselines: always action ``a``."""

    def __init__(self, action: int, *, name: Optional[str] = None):
        self.action = int(action)
        self.name = name or f"fixed(a{action})"

    def route(self, states, slo=None, context=None) -> RoutingDecision:
        n = len(states)
        acts = np.full(n, self.action, np.int64)
        return RoutingDecision(actions=acts,
                               confidences=np.ones(n, np.float32),
                               policy=self.name)


class MLPPolicy:
    """Adapter around the routing MLP.  ``params`` is a dict of torch
    tensors (from :meth:`train`, :mod:`repro_torch.bridge` or
    :func:`repro_torch.core.policy.init_policy`); the forward pass runs
    on their device."""

    def __init__(self, params, cfg: RouterConfig, *, name: str = "mlp",
                 train_result=None):
        self.params = params
        self.cfg = cfg
        self.name = name
        self.train_result = train_result

    @classmethod
    def train(cls, log, rewards, cfg: RouterConfig, *,
              objective: Optional[str] = None, refusal_cap: float = 1.0,
              dual_lr: float = 8.0, seed: Optional[int] = None,
              name: Optional[str] = None, init_params=None,
              device="cuda") -> "MLPPolicy":
        tr = train_policy(log, rewards, cfg, objective=objective,
                          refusal_cap=refusal_cap, dual_lr=dual_lr, seed=seed,
                          init_params=init_params, device=device)
        return cls(tr.params, cfg, name=name or (objective or cfg.objective),
                   train_result=tr)

    def logits(self, states: np.ndarray) -> np.ndarray:
        return host_logits(self.params, states, self.cfg)

    def actions(self, states: np.ndarray) -> np.ndarray:
        return self.route(states).actions

    def route(self, states, slo=None, context=None) -> RoutingDecision:
        return _decision_from_logits(self.logits(np.asarray(states)),
                                     self.name, context)


class ConstrainedPolicy(MLPPolicy):
    """Lagrangian refusal-capped MLP (the trained §7.1 mitigation)."""

    def __init__(self, params, cfg: RouterConfig, *,
                 trained_refusal_cap: float = 1.0, lagrange: float = 0.0,
                 name: str = "constrained", train_result=None):
        super().__init__(params, cfg, name=name, train_result=train_result)
        self.trained_refusal_cap = trained_refusal_cap
        self.lagrange = lagrange

    @classmethod
    def train(cls, log, rewards, cfg: RouterConfig, *,
              objective: str = "constrained", refusal_cap: float = 0.45,
              dual_lr: float = 8.0, seed: Optional[int] = None,
              name: str = "constrained", init_params=None,
              device="cuda") -> "ConstrainedPolicy":
        if objective != "constrained":
            raise ValueError(
                f"ConstrainedPolicy trains the 'constrained' objective, "
                f"got {objective!r}; use MLPPolicy.train for other objectives")
        tr = train_policy(log, rewards, cfg, objective="constrained",
                          refusal_cap=refusal_cap, dual_lr=dual_lr, seed=seed,
                          init_params=init_params, device=device)
        return cls(tr.params, cfg, trained_refusal_cap=refusal_cap,
                   lagrange=tr.lagrange, name=name, train_result=tr)

    def route(self, states, slo=None, context=None) -> RoutingDecision:
        d = super().route(states, slo, context)
        d.constraints.setdefault("trained_refusal_cap",
                                 float(self.trained_refusal_cap))
        d.constraints.setdefault("lagrange", float(self.lagrange))
        return d


class ConditionedPolicy(MLPPolicy):
    """One policy for every SLO: profile weights appended to the state
    (``core/conditioned.py``).  ``slo`` is required and may be a single
    profile/name or one per request."""

    def __init__(self, params, ccfg: RouterConfig, *,
                 name: str = "conditioned", train_result=None):
        super().__init__(params, ccfg, name=name, train_result=train_result)

    @classmethod
    def train(cls, log, profiles: Sequence[SLOProfile], cfg: RouterConfig, *,
              objective: str = "argmax_ce", n_interp: int = 3,
              name: str = "conditioned", init_params=None,
              device="cuda") -> "ConditionedPolicy":
        tr, ccfg = train_conditioned(log, profiles, cfg,
                                     objective=objective, n_interp=n_interp,
                                     init_params=init_params, device=device)
        return cls(tr.params, ccfg, name=name, train_result=tr)

    def _condition(self, states: np.ndarray, slo: SLOLike) -> np.ndarray:
        if slo is None:
            raise ValueError("ConditionedPolicy.route requires an SLO")
        states = np.asarray(states)
        if isinstance(slo, (str, SLOProfile)):
            v = profile_vector(get_slo_profile(slo))
            cond = np.tile(v[None], (len(states), 1))
        else:
            if len(slo) != len(states):
                raise ValueError(
                    f"{len(slo)} SLOs for {len(states)} states")
            cond = np.stack([profile_vector(get_slo_profile(s)) for s in slo])
        return np.concatenate([states, cond], axis=1)

    def route(self, states, slo=None, context=None) -> RoutingDecision:
        return _decision_from_logits(self.logits(self._condition(states, slo)),
                                     self.name, context)
