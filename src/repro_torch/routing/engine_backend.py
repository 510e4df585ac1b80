"""Real-model generation backend: retrieval + the continuous engine
behind the :class:`~repro_torch.routing.backends.GenerationBackend`
protocol.

:class:`ContinuousEngineBackend` implements ``execute_mixed`` so ALL
routed buckets of a micro-batch feed one shared in-flight decode stream
of the slot-based :class:`~repro_torch.serving.continuous.ContinuousEngine`.
Retrieval depth only changes the prompt; generation is unified, so
deep-k and shallow-k requests decode in the same step and finished
slots admit queued requests mid-stream.

The local model has no answer scorer, so outcomes carry
token-accounting truth (cost, refusal) and conservative quality
indicators (``correct=False``; unanswerable queries that get an answer
anyway count as hallucinations), exactly as the reference does.

Retrieval goes through the named retrievers of
:mod:`repro_torch.retrieval.hybrid` (bm25 over ``index`` by default):
a shared bounded LRU in front when ``retrieval_cache_size > 0``, a
circuit breaker per retriever under it, and a failed lookup rewritten
to the bm25 fallback as a *degraded* outcome.
"""
from __future__ import annotations

from typing import List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.errors import TransientFaultError
from repro_torch.data.synthetic_squad import Question
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.generation.prompts import REFUSAL_TEXT, build_prompt
from repro_torch.obs import NULL_TRACER
from repro_torch.retrieval.bm25 import BM25Index
from repro_torch.retrieval.hybrid import (Retriever, bind_retrieval_metrics,
                                          collect_breakers,
                                          resolve_retrievers,
                                          retrieve_with_fallback)
from repro_torch.routing.registry import Action
from repro_torch.serving.pipeline import ActionOutcome

# Matches the pre-retrieval refusal accounting of the old serve driver.
REFUSE_COST_TOKENS = 5.0


class EngineBackend:
    """Retrieval + prompt building + outcome accounting over an engine."""

    # telemetry: the Gateway installs its tracer here so retrieval and
    # engine spans land in the same trace (no-op by default)
    tracer = NULL_TRACER

    def __init__(self, engine, tokenizer: HashTokenizer, index: BM25Index,
                 *, max_prompt_len: int = 384, max_new_tokens: int = 8,
                 retrievers: Optional[Mapping[str, Retriever]] = None,
                 retrieval_cache_size: int = 0,
                 breaker_kw: Optional[dict] = None):
        self.engine = engine
        self.tok = tokenizer
        self.index = index
        self.max_prompt_len = max_prompt_len
        self.max_new_tokens = max_new_tokens
        # named retrievers (None = bm25-only over `index`); a shared
        # bounded LRU fronts them when retrieval_cache_size > 0, and a
        # per-retriever circuit breaker sits under the cache
        self.retrievers, self.retrieval_cache = resolve_retrievers(
            retrievers, index, cache_size=retrieval_cache_size,
            breaker_kw=breaker_kw)
        self.breakers = collect_breakers(self.retrievers)

    def install_tracer(self, tracer) -> None:
        """Adopt the Gateway's tracer (called once at Gateway
        construction); the engine shares it when it can carry one."""
        self.tracer = tracer
        if hasattr(self.engine, "tracer"):
            self.engine.tracer = tracer

    def bind_metrics(self, registry) -> None:
        """Register this backend's stat sources (retrieval cache,
        breakers, engine counters) as views over ``registry``."""
        bind_retrieval_metrics(registry, self.breakers,
                               self.retrieval_cache)
        bind = getattr(self.engine, "bind_metrics", None)
        if bind is not None:
            bind(registry)

    def _prep(self, q: Question, action: Action
              ) -> Tuple[List[int], bool, bool]:
        """Retrieve with the action's retriever at its depth and build
        the prompt tokens.  Returns (token ids padded to
        max_prompt_len, retrieval hit, degraded).  ``degraded`` means
        the action's retriever failed (open breaker / fault) and the
        lookup was rewritten to the bm25 fallback; a transient fault
        with no working fallback raises ``TransientFaultError``."""
        degraded = False
        if action.k <= 0:
            passages: List[str] = []
        else:
            if action.retriever not in self.retrievers:
                raise KeyError(
                    f"action retriever {action.retriever!r} not "
                    f"configured; available: {sorted(self.retrievers)}")
            passages, degraded = retrieve_with_fallback(
                self.retrievers, action.retriever, q.text, action.k,
                tracer=self.tracer)
        hit = bool(q.gold_answer) and any(
            q.gold_answer in p for p in passages)
        prompt = build_prompt(action.mode, q.text, passages)
        return self.tok.encode(prompt, bos=True,
                               max_len=self.max_prompt_len), hit, degraded

    @staticmethod
    def _refusal_outcome(q: Question, action: Action) -> ActionOutcome:
        return ActionOutcome(
            qid=q.qid, action=action.idx, correct=False, refused=True,
            hallucinated=False, cost_tokens=REFUSE_COST_TOKENS,
            hit=False, answerable=q.answerable, answer=REFUSAL_TEXT)

    @staticmethod
    def _rejected_outcome(q: Question, action: Action,
                          reason: str) -> ActionOutcome:
        """An engine-rejected request (e.g. over-length prompt):
        surfaced as a refused outcome so Gateway accounting sees it
        like any served request; ``rejected=True`` marks it as a
        capacity rejection, not a policy refusal."""
        return ActionOutcome(
            qid=q.qid, action=action.idx, correct=False, refused=True,
            hallucinated=False, cost_tokens=REFUSE_COST_TOKENS,
            hit=False, answerable=q.answerable,
            answer=f"<rejected: {reason}>", rejected=True)

    @staticmethod
    def _transient_outcome(q: Question, action: Action,
                           reason: str) -> ActionOutcome:
        """A retryable fault (quarantined slot, executor fault):
        refused for reward/budget purposes, ``transient=True``."""
        return ActionOutcome(
            qid=q.qid, action=action.idx, correct=False, refused=True,
            hallucinated=False, cost_tokens=REFUSE_COST_TOKENS,
            hit=False, answerable=q.answerable,
            answer=f"<transient fault: {reason}>", transient=True)

    @staticmethod
    def _timeout_outcome(q: Question, action: Action) -> ActionOutcome:
        """Cancelled mid-stream past its deadline — an SLO violation
        (refused burns the budget), never retried."""
        return ActionOutcome(
            qid=q.qid, action=action.idx, correct=False, refused=True,
            hallucinated=False, cost_tokens=REFUSE_COST_TOKENS,
            hit=False, answerable=q.answerable,
            answer="<deadline exceeded>", timed_out=True)

    @classmethod
    def _failed_outcome(cls, q: Question, action: Action,
                        gen) -> ActionOutcome:
        """Map a failed :class:`CompletedGeneration` to its outcome."""
        if gen.timed_out:
            return cls._timeout_outcome(q, action)
        if gen.transient:
            return cls._transient_outcome(q, action, gen.failed)
        return cls._rejected_outcome(q, action, gen.failed)

    @staticmethod
    def _generated_outcome(q: Question, action: Action, prompt_len: int,
                           n_out: int, hit: bool,
                           degraded: bool = False) -> ActionOutcome:
        return ActionOutcome(
            qid=q.qid, action=action.idx, correct=False, refused=False,
            hallucinated=not q.answerable,
            cost_tokens=float(prompt_len + n_out), hit=hit,
            answerable=q.answerable,
            answer=f"<{n_out} generated tokens>", degraded=degraded)


class ContinuousEngineBackend(EngineBackend):
    """Cross-bucket in-flight serving over the continuous engine.

    ``execute_mixed`` takes the whole routed micro-batch — one action
    per request — and submits every non-refuse request into the shared
    slot pool before a single ``run()`` drains them together.  ``engine``
    must be a :class:`~repro_torch.serving.continuous.ContinuousEngine`
    whose ``max_len`` >= ``max_prompt_len + max_new_tokens``; use
    :meth:`create` to build engine and backend together.
    """

    @classmethod
    def create(cls, model, params, tokenizer: HashTokenizer,
               index: BM25Index, *, num_slots: int = 8,
               max_prompt_len: int = 384, max_new_tokens: int = 8,
               sync_every: int = 4, prefill_batch: Optional[int] = None,
               retrievers: Optional[Mapping[str, Retriever]] = None,
               retrieval_cache_size: int = 0,
               breaker_kw: Optional[dict] = None,
               **engine_kw) -> "ContinuousEngineBackend":
        """Build a :class:`~repro_torch.serving.continuous.ContinuousEngine`
        sized for this backend's prompts (slot caches hold the padded
        prompt plus the generation budget) on the params' device, and
        wrap it."""
        from repro_torch.serving.continuous import ContinuousEngine
        engine = ContinuousEngine(
            model, params, num_slots=num_slots,
            max_len=max_prompt_len + max_new_tokens,
            max_new_cap=max_new_tokens, sync_every=sync_every,
            prefill_batch=(num_slots if prefill_batch is None
                           else prefill_batch), **engine_kw)
        return cls(engine, tokenizer, index, max_prompt_len=max_prompt_len,
                   max_new_tokens=max_new_tokens, retrievers=retrievers,
                   retrieval_cache_size=retrieval_cache_size,
                   breaker_kw=breaker_kw)

    def execute_mixed(self, questions: Sequence[Question],
                      actions: Sequence[Action]) -> List[ActionOutcome]:
        outcomes: List[ActionOutcome] = [None] * len(questions)
        submitted = {}   # rid -> (position, question, action, hit, plen,
        #                          degraded)
        for i, (q, action) in enumerate(zip(questions, actions)):
            if action.mode == "refuse":
                outcomes[i] = self._refusal_outcome(q, action)
                continue
            try:
                toks, hit, degraded = self._prep(q, action)
            except TransientFaultError as exc:
                # dead retrieval path for THIS request only — the rest
                # of the micro-batch still serves
                outcomes[i] = self._transient_outcome(q, action, str(exc))
                continue
            rid = self.engine.reserve_rid()
            # non-strict: an over-length prompt is rejected per-request
            # (failed CompletedGeneration) instead of raising and
            # killing the micro-batch with other slots still resident
            self.engine.submit(rid, toks, self.max_new_tokens,
                               strict=False)
            submitted[rid] = (i, q, action, hit, len(toks), degraded)
        if submitted:
            done = self.engine.run()
            for rid, (i, q, action, hit, plen, degraded) in \
                    submitted.items():
                gen = done[rid]
                if gen.failed:
                    outcomes[i] = self._failed_outcome(q, action, gen)
                else:
                    outcomes[i] = self._generated_outcome(
                        q, action, plen, gen.n_steps, hit, degraded)
                # engine-clock stamps: the Gateway slices its dispatch
                # window into prefill/decode spans with these
                outcomes[i].admitted_at = gen.admitted_at
                outcomes[i].finished_at = gen.finished_at
        return outcomes

    def execute_batch(self, questions: Sequence[Question],
                      action: Action) -> List[ActionOutcome]:
        # single-bucket entry point routes through the same shared stream
        return self.execute_mixed(questions, [action] * len(questions))
