"""Routing API: policies, action-space and SLO-profile registries, the
engine backend and the serving Gateway."""
from repro_torch.routing.engine_backend import ContinuousEngineBackend
from repro_torch.routing.gateway import Gateway, GatewayStats, Request
from repro_torch.routing.policy import (FixedPolicy, MLPPolicy,
                                        RoutingContext, RoutingDecision,
                                        RoutingPolicy, apply_refusal_cap)
from repro_torch.routing.registry import (Action, ActionSpace,
                                          get_action_space, get_slo_profile,
                                          list_slo_profiles)

__all__ = ["Action", "ActionSpace", "ContinuousEngineBackend", "FixedPolicy",
           "Gateway", "GatewayStats", "MLPPolicy", "Request",
           "RoutingContext", "RoutingDecision", "RoutingPolicy",
           "apply_refusal_cap", "get_action_space", "get_slo_profile",
           "list_slo_profiles"]
