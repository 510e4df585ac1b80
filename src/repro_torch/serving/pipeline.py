"""The RAG pipeline executor: action -> retrieve -> generate -> score.

This is the system under control: a routing policy (see
``repro_torch.routing``) picks an action, the pipeline executes it
against the retrieval index and the calibrated generator simulator, and
emits the per-query metrics the reward (eq. 1) consumes.  In the Gateway
serve path this pipeline sits behind
``repro_torch.routing.backends.SimulatorBackend``; the engine backends
emit the same :class:`ActionOutcome` record.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Mapping, Optional, Sequence

from repro_torch.data.synthetic_squad import Question
from repro_torch.generation.simulator import SimulatedGenerator
from repro_torch.obs import NULL_TRACER
from repro_torch.retrieval.bm25 import BM25Index
from repro_torch.retrieval.hybrid import (Retriever, resolve_retrievers,
                                          retrieve_with_fallback)
from repro_torch.routing.registry import (Action, ActionSpace,
                                          get_action_space)


@dataclass
class ActionOutcome:
    qid: int
    action: int
    correct: bool
    refused: bool
    hallucinated: bool
    cost_tokens: float
    hit: bool                 # gold answer string in retrieved set
    answerable: bool
    answer: str
    # engine capacity rejection (e.g. over-length prompt), not a policy
    # refusal — refused is still True so reward/error-budget accounting
    # treats the unserved request as an SLO violation, but downstream
    # consumers can tell the two apart (Gateway counts them separately)
    rejected: bool = False
    # fault-tolerance facets (all default False — healthy outcomes are
    # unchanged).  degraded: served through a fallback retriever.
    # timed_out: the request's deadline passed mid-flight and it was
    # cancelled.  transient: the request failed on a retryable fault.
    degraded: bool = False
    timed_out: bool = False
    transient: bool = False
    # engine-clock stamps (0.0 = backend doesn't stamp): prefill
    # dispatch and generation finish — the Gateway's tracer slices its
    # dispatch window into prefill/decode spans with these
    admitted_at: float = 0.0
    finished_at: float = 0.0

    def to_row(self) -> dict:
        return asdict(self)


class RAGPipeline:
    # telemetry: the owning backend installs the Gateway's tracer here
    # so retrieval spans are noted into the request trace (no-op default)
    tracer = NULL_TRACER

    def __init__(self, index: BM25Index, generator: SimulatedGenerator,
                 retrievers: Optional[Mapping[str, Retriever]] = None,
                 *, retrieval_cache_size: int = 0):
        self.index = index
        self.generator = generator
        # named retrievers behind the shared protocol; None = the
        # bm25-only default.  cache_size > 0 puts one bounded LRU in
        # front of every retriever.
        self.retrievers, self.retrieval_cache = resolve_retrievers(
            retrievers, index, cache_size=retrieval_cache_size)

    def retrieve(self, question: str, k: int,
                 retriever: str = "bm25") -> Sequence[str]:
        if k <= 0:
            return []
        try:
            r = self.retrievers[retriever]
        except KeyError:
            raise KeyError(
                f"action retriever {retriever!r} not configured; "
                f"available: {sorted(self.retrievers)}") from None
        return r.passages(question, k)

    def retrieve_degradable(self, question: str, k: int,
                            retriever: str = "bm25"
                            ) -> tuple:
        """(passages, degraded) — like :meth:`retrieve`, but an open
        breaker or failing retriever degrades to the bm25 fallback
        instead of raising (raises TransientFaultError only when the
        fallback path fails too)."""
        if k <= 0:
            return [], False
        if retriever not in self.retrievers:
            raise KeyError(
                f"action retriever {retriever!r} not configured; "
                f"available: {sorted(self.retrievers)}")
        return retrieve_with_fallback(self.retrievers, retriever,
                                      question, k, tracer=self.tracer)

    def execute(self, q: Question, action: Action) -> ActionOutcome:
        if action.mode == "refuse":
            out = self.generator.refuse(q.qid, q.text)
            hit = False
            degraded = False
        else:
            passages, degraded = self.retrieve_degradable(
                q.text, action.k, action.retriever)
            out = self.generator.generate(
                q.qid, action.idx, action.mode, q.text, passages,
                answerable=q.answerable, gold_answer=q.gold_answer)
            hit = bool(q.gold_answer) and any(
                q.gold_answer in p for p in passages)
        return ActionOutcome(
            qid=q.qid, action=action.idx, correct=out.correct,
            refused=out.refused, hallucinated=out.hallucinated,
            cost_tokens=float(out.cost_tokens), hit=hit,
            answerable=q.answerable, answer=out.answer,
            degraded=degraded)

    def sweep(self, q: Question,
              space: Optional[ActionSpace] = None) -> list:
        """Full action sweep (paper §4.1) — one outcome per action of
        the given (default: paper) action space."""
        space = space if space is not None else get_action_space()
        return [self.execute(q, a) for a in space]
