"""The generation-backend protocol behind the Gateway.

The Gateway executes a routed action bucket through a
:class:`GenerationBackend`.  Backends may additionally provide
``execute_mixed(questions, actions)`` taking one action per request; the
Gateway prefers it when present, so the whole routed micro-batch — all
action buckets — executes as one shared in-flight stream (see
:class:`~repro_torch.routing.engine_backend.ContinuousEngineBackend`,
the backend this slice ports).  The reference's simulator backend and
its streaming protocol arrive with later slices.
"""
from __future__ import annotations

from typing import List, Protocol, Sequence, runtime_checkable

from repro_torch.data.synthetic_squad import Question
from repro_torch.routing.registry import Action
from repro_torch.serving.pipeline import ActionOutcome


@runtime_checkable
class GenerationBackend(Protocol):
    """Executes one action for a bucket of requests."""

    def execute_batch(self, questions: Sequence[Question],
                      action: Action) -> List[ActionOutcome]:
        ...
