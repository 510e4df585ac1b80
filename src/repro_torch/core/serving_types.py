"""Shared serving-side record types."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RequestOutcome:
    qid: int
    action: int
    correct: bool
    refused: bool
    hallucinated: bool
    cost_tokens: float
    answerable: bool
    latency_ms: float = 0.0
