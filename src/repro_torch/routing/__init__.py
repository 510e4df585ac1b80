"""Routing API: policies, action-space and SLO-profile registries, the
generation backends and the serving Gateway.

Registry symbols import eagerly (they are dependency-light, and
``repro_torch.core.actions`` and ``repro_torch.serving.pipeline`` import
the registry); policy, backend and gateway symbols load lazily through
the module ``__getattr__``, so importing the registry never drags in the
serving stack mid-import.
"""
from __future__ import annotations

import importlib

from repro_torch.routing.registry import (Action, ActionSpace,
                                          get_action_space, get_slo_profile,
                                          list_slo_profiles)

_LAZY = {
    # policy layer
    "RoutingPolicy": "repro_torch.routing.policy",
    "RoutingDecision": "repro_torch.routing.policy",
    "RoutingContext": "repro_torch.routing.policy",
    "FixedPolicy": "repro_torch.routing.policy",
    "MLPPolicy": "repro_torch.routing.policy",
    "ConstrainedPolicy": "repro_torch.routing.policy",
    "ConditionedPolicy": "repro_torch.routing.policy",
    "apply_refusal_cap": "repro_torch.routing.policy",
    # backends
    "GenerationBackend": "repro_torch.routing.backends",
    "SimulatorBackend": "repro_torch.routing.backends",
    "as_backend": "repro_torch.routing.backends",
    "EngineBackend": "repro_torch.routing.engine_backend",
    "ContinuousEngineBackend": "repro_torch.routing.engine_backend",
    # gateway
    "Gateway": "repro_torch.routing.gateway",
    "GatewayStats": "repro_torch.routing.gateway",
    "Request": "repro_torch.routing.gateway",
}

__all__ = ["Action", "ActionSpace", "get_action_space", "get_slo_profile",
           "list_slo_profiles", *sorted(_LAZY)]


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
