"""Scheduler facade over the unified routing Gateway.

The production loop the paper's controller lives in:

  queue -> route (policy, per-request SLO) -> group by action bucket
        -> execute buckets (retrieval batched per depth, generation
           batched per mode) -> record outcomes -> error budgets
        -> (adaptive mitigation) budget burn tightens the refusal share.

That loop lives in :class:`repro_torch.routing.gateway.Gateway`, behind
the pluggable :class:`~repro_torch.routing.policy.RoutingPolicy` /
:class:`~repro_torch.routing.backends.GenerationBackend` protocols.
:class:`Scheduler` is a thin wrapper for callers that hold raw MLP
params + a simulator pipeline; new code should construct a ``Gateway``
directly.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.core.config import RouterConfig
from repro_torch.routing.backends import SimulatorBackend
from repro_torch.routing.gateway import Gateway, GatewayStats, Request
from repro_torch.routing.policy import MLPPolicy
from repro_torch.serving.pipeline import RAGPipeline

# the scheduler's request/stats types ARE the gateway's
SchedulerStats = GatewayStats

__all__ = ["Request", "Scheduler", "SchedulerStats"]


class Scheduler:
    """Micro-batching scheduler with adaptive refusal back-pressure.

    Thin wrapper: ``Scheduler(pipe, params, cfg)`` ==
    ``Gateway(MLPPolicy(params, cfg), SimulatorBackend(pipe), ...)``.
    """

    def __init__(self, pipeline: RAGPipeline, policy_params, router_cfg:
                 RouterConfig, *, index=None, max_batch: int = 16,
                 adaptive_refusal: bool = True, base_refusal_share: float = 0.6):
        self.pipe = pipeline
        self.params = policy_params
        self.rcfg = router_cfg
        self.index = index if index is not None else pipeline.index
        self.gateway = Gateway(
            MLPPolicy(policy_params, router_cfg),
            SimulatorBackend(pipeline),
            router_cfg=router_cfg, index=self.index, max_batch=max_batch,
            adaptive_refusal=adaptive_refusal,
            base_refusal_share=base_refusal_share)

    # ------------------------------------------------------------------
    @property
    def queue(self) -> List[Request]:
        return self.gateway.queue

    @property
    def stats(self) -> GatewayStats:
        return self.gateway.stats

    @property
    def budget(self):
        return self.gateway.budget

    def submit(self, reqs: Sequence[Request]) -> None:
        self.gateway.submit(reqs)

    def step(self) -> Optional[GatewayStats]:
        return self.gateway.step()

    def drain(self) -> GatewayStats:
        return self.gateway.drain()
