"""The :class:`RoutingPolicy` protocol and its adapters.

One interface for every way the system can pick an action per request:

* :class:`FixedPolicy` — the paper's fixed baselines (always a_i);
* :class:`MLPPolicy` — the routing MLP, its forward pass run in torch
  (``core/policy.py``).

``route(states, slo, context) -> RoutingDecision`` is vectorized over
the batch.  Inference-time constraints (the adaptive refusal cap the
Gateway derives from error-budget burn) are applied inside ``route`` via
:func:`apply_refusal_cap` and recorded on the decision.  Training the
MLP and the constrained / SLO-conditioned variants arrive with the
router-training slice (``ROADMAP.md`` queue 1, item 6).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Protocol, Sequence, Union, runtime_checkable

import numpy as np
import torch

from repro_torch.core.config import RouterConfig, SLOProfile
from repro_torch.core.policy import policy_logits
from repro_torch.routing.registry import ActionSpace, get_action_space

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
    tensors (from :mod:`repro_torch.bridge` or
    :func:`repro_torch.core.policy.init_policy`); the forward pass runs
    on their device."""

    def __init__(self, params, cfg: RouterConfig, *, name: str = "mlp"):
        self.params = params
        self.cfg = cfg
        self.name = name

    def logits(self, states: np.ndarray) -> np.ndarray:
        dev = self.params["w0"].device
        x = torch.from_numpy(np.ascontiguousarray(states, np.float32)).to(dev)
        with torch.no_grad():
            return policy_logits(self.params, x, self.cfg).cpu().numpy()

    def actions(self, states: np.ndarray) -> np.ndarray:
        return self.route(states).actions

    def route(self, states, slo=None, context=None) -> RoutingDecision:
        return _decision_from_logits(self.logits(np.asarray(states)),
                                     self.name, context)
