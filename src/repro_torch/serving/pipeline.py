"""The per-request outcome record the backends emit and the Gateway
accounts (reward eq. 1, error budgets).  The reference's simulator
``RAGPipeline`` arrives with the router-training slice."""
from __future__ import annotations

from dataclasses import asdict, dataclass


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
