"""Serving layer: the RAG executor, the legacy Scheduler wrapper, SLO
error budgets, the KV-cache generation engines (padded-bucket and
continuous-batching), the open-loop gateway with its traffic harness,
and the chaos seams.

Engine, gateway and fault symbols resolve lazily via module
``__getattr__`` so their modules only import when actually used.
"""
from __future__ import annotations

import importlib

from repro_torch.serving.pipeline import ActionOutcome, RAGPipeline

_LAZY = {
    "Engine": "repro_torch.serving.engine",
    "GenerationResult": "repro_torch.serving.engine",
    "ContinuousEngine": "repro_torch.serving.continuous",
    "CompletedGeneration": "repro_torch.serving.continuous",
    "EngineStats": "repro_torch.serving.continuous",
    "SingleDeviceExecutor": "repro_torch.serving.executor",
    "PagePool": "repro_torch.serving.paged",
    "PagePlan": "repro_torch.serving.paged",
    "hash_prefix_pages": "repro_torch.serving.paged",
    "AsyncGateway": "repro_torch.serving.streaming",
    "StreamHandle": "repro_torch.serving.streaming",
    "AdmissionConfig": "repro_torch.serving.streaming",
    "FaultSpec": "repro_torch.serving.faults",
    "FaultPlan": "repro_torch.serving.faults",
    "ChaosInjector": "repro_torch.serving.faults",
    "ChaosRetriever": "repro_torch.serving.faults",
    "ChaosExecutor": "repro_torch.serving.faults",
    "RetryPolicy": "repro_torch.serving.faults",
    "FaultError": "repro_torch.serving.faults",
    "TransientFaultError": "repro_torch.serving.faults",
    "FaultTimeoutError": "repro_torch.serving.faults",
    "LoadGenerator": "repro_torch.serving.traffic",
    "PoissonProcess": "repro_torch.serving.traffic",
    "OnOffProcess": "repro_torch.serving.traffic",
    "VirtualClock": "repro_torch.serving.traffic",
    "build_trace": "repro_torch.serving.traffic",
    "sweep_offered_load": "repro_torch.serving.traffic",
}

__all__ = ["RAGPipeline", "ActionOutcome", *sorted(_LAZY)]


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
