"""Generation backends behind one protocol.

The Gateway executes a routed action bucket through a
:class:`GenerationBackend`; the simulator pipeline and the KV-cache
engines (``engine_backend.py``) are interchangeable behind
``execute_batch``.

**Streaming protocol** (optional, for the open-loop
:class:`~repro_torch.serving.streaming.AsyncGateway`): backends that can
hold requests in flight additionally provide

    stream_submit(question, action, *, deadline_at=0.0)
            -> (rid, immediate_outcome)
        enqueue ONE routed request without blocking.  Exactly one of
        the pair is non-None: immediate outcomes (refusals) never enter
        the service stream.  ``deadline_at`` (backend-clock instant,
        0 = none) lets deadline-enforcing backends cancel the request
        mid-stream; the simulator accepts but ignores it (its service
        model has no mid-service cancellation).  A transient fault at
        submit raises :class:`~repro_torch.core.errors.TransientFaultError`,
        which the AsyncGateway turns into a bounded deadline-aware
        retry.
    stream_poll() -> List[StreamCompletion]
        advance the backend by one scheduling step and return every
        request completed since the last poll.
    stream_backlog -> int
        requests submitted but not yet completed (the queue-depth
        signal admission control sheds on).

:class:`~repro_torch.routing.engine_backend.ContinuousEngineBackend`
implements it over the real slot engine; :class:`SimulatorBackend` over
a deterministic synthetic service model (bounded concurrency, fixed
polls-per-request) so admission-control behaviour is testable without a
model in the loop.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional, Protocol, Sequence, Tuple, \
    runtime_checkable

from repro_torch.data.synthetic_squad import Question
from repro_torch.routing.registry import Action
from repro_torch.serving.pipeline import ActionOutcome, RAGPipeline


@dataclass(frozen=True)
class StreamCompletion:
    """One finished in-flight request: its outcome plus the backend
    clock stamps open-loop latency accounting needs (``admitted_at`` is
    when the first token was produced — prefill dispatch)."""

    rid: int
    outcome: ActionOutcome
    admitted_at: float
    finished_at: float


@runtime_checkable
class GenerationBackend(Protocol):
    """Executes one action for a bucket of requests.

    Backends may additionally provide ``execute_mixed(questions,
    actions)`` taking one action per request; the Gateway prefers it
    when present so the whole routed micro-batch — all action buckets —
    executes as one shared in-flight stream (see
    :class:`~repro_torch.routing.engine_backend.ContinuousEngineBackend`).
    """

    def execute_batch(self, questions: Sequence[Question],
                      action: Action) -> List[ActionOutcome]:
        ...


class SimulatorBackend:
    """The calibrated simulator pipeline as a generation backend.

    Streaming runs the pipeline's (instant) outcome through a synthetic
    service model: at most ``stream_slots`` requests in service, each
    occupying its slot for ``service_polls`` ``stream_poll`` calls,
    FIFO admission from a waiting queue.  Entirely deterministic.
    """

    def __init__(self, pipeline: RAGPipeline, *, stream_slots: int = 4,
                 service_polls: int = 2, clock=None):
        self.pipeline = pipeline
        self.stream_slots = max(1, stream_slots)
        self.service_polls = max(1, service_polls)
        self._clock = clock if clock is not None else time.perf_counter
        self._next_rid = 0
        # waiting: (rid, outcome); in service: [rid, outcome, polls_left,
        # admitted_at]
        self._waiting: Deque[Tuple[int, ActionOutcome]] = deque()
        self._in_service: List[list] = []

    @property
    def index(self):
        return self.pipeline.index

    @property
    def retrieval_cache(self):
        """The pipeline's shared retrieval LRU (None when uncached) —
        the Gateway mirrors its hit counters into GatewayStats."""
        return self.pipeline.retrieval_cache

    def install_tracer(self, tracer) -> None:
        """Adopt the Gateway's tracer: the pipeline notes retrieval
        spans that the gateway adopts per submitted request."""
        self.pipeline.tracer = tracer

    def bind_metrics(self, registry) -> None:
        from repro_torch.retrieval.hybrid import bind_retrieval_metrics
        bind_retrieval_metrics(registry, {}, self.pipeline.retrieval_cache)

    def execute_batch(self, questions: Sequence[Question],
                      action: Action) -> List[ActionOutcome]:
        return [self.pipeline.execute(q, action) for q in questions]

    # -- streaming protocol -------------------------------------------

    @property
    def stream_backlog(self) -> int:
        return len(self._waiting) + len(self._in_service)

    def stream_submit(self, question: Question, action: Action, *,
                      deadline_at: float = 0.0
                      ) -> Tuple[Optional[int], Optional[ActionOutcome]]:
        # deadline_at accepted for protocol parity; the synthetic
        # service model never cancels mid-service (the AsyncGateway's
        # goodput accounting still marks late completions as misses)
        out = self.pipeline.execute(question, action)
        if action.mode == "refuse":
            return None, out          # refusals complete at the gate
        rid = self._next_rid
        self._next_rid += 1
        self._waiting.append((rid, out))
        return rid, None

    def _fill_slots(self) -> None:
        now = self._clock()
        while self._waiting and len(self._in_service) < self.stream_slots:
            rid, out = self._waiting.popleft()
            self._in_service.append([rid, out, self.service_polls, now])

    def stream_poll(self) -> List[StreamCompletion]:
        self._fill_slots()
        done: List[StreamCompletion] = []
        keep: List[list] = []
        now = self._clock()
        for entry in self._in_service:
            entry[2] -= 1
            if entry[2] <= 0:
                done.append(StreamCompletion(
                    rid=entry[0], outcome=entry[1],
                    admitted_at=entry[3], finished_at=now))
            else:
                keep.append(entry)
        self._in_service = keep
        self._fill_slots()
        return done


def as_backend(backend_or_pipeline) -> GenerationBackend:
    """Accept either a backend or a raw :class:`RAGPipeline`."""
    if isinstance(backend_or_pipeline, RAGPipeline):
        return SimulatorBackend(backend_or_pipeline)
    return backend_or_pipeline
