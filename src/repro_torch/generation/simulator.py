"""Calibrated generator simulator (stands in for gpt-4.1-nano).

The paper logs, per (question, action): correctness, token cost,
hallucination/refusal indicators.  Here generation behaviour is a
calibrated stochastic model conditioned on the *actual retrieval
outcome* (hit/miss from our BM25 index) and the prompting mode, with
rates matched to Table 1's aggregates (accuracy ≈ 0.25–0.30, refusal
≈ 0.28 for guarded k=5, cost ≈ 244/609/1100 tokens for k=2/5/10).

Determinism: outcomes are a pure function of (seed, qid, action) via a
counter-based hash — the full action sweep is reproducible and
re-loggable, mirroring the paper's frozen offline log.  The same
(seed, qid, action) gives the reference's outcome bit for bit.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional, Sequence

from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.generation.prompts import (DONT_KNOW_TEXT, REFUSAL_TEXT,
                                            build_prompt)


@dataclass
class GenOutput:
    answer: str
    refused: bool
    correct: bool
    hallucinated: bool
    prompt_tokens: int
    completion_tokens: int

    @property
    def cost_tokens(self) -> int:
        return self.prompt_tokens + self.completion_tokens


@dataclass(frozen=True)
class BehaviorRates:
    """P(correct / refuse / hallucinate) per (mode, answerable, hit)."""

    # guarded mode
    g_hit_correct: float = 0.78
    g_hit_refuse: float = 0.12
    g_miss_refuse: float = 0.55
    g_miss_correct: float = 0.04     # parametric knowledge
    g_unans_refuse: float = 0.48     # guarded still often answers wrongly
    # auto mode
    a_hit_correct: float = 0.72
    a_hit_refuse: float = 0.03
    a_miss_correct: float = 0.08
    a_miss_refuse: float = 0.05
    a_unans_refuse: float = 0.10


def _u(seed: int, qid: int, action: int, salt: int) -> float:
    h = hashlib.blake2s(f"{seed}|{qid}|{action}|{salt}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "little") / 2**64


class SimulatedGenerator:
    """Executes one action's generation step and scores it."""

    def __init__(self, tokenizer: HashTokenizer, seed: int = 0,
                 rates: BehaviorRates = BehaviorRates()):
        self.tok = tokenizer
        self.seed = seed
        self.rates = rates

    def refuse(self, qid: int, question: str) -> GenOutput:
        """Action 4: pre-retrieval abstention (paper §3.1)."""
        return GenOutput(REFUSAL_TEXT, True, False, False,
                         self.tok.n_tokens(question) + 2, 5)

    def generate(self, qid: int, action: int, mode: str, question: str,
                 passages: Sequence[str], *, answerable: bool,
                 gold_answer: Optional[str]) -> GenOutput:
        hit = bool(gold_answer) and any(gold_answer in p for p in passages)
        prompt = build_prompt(mode, question, passages)
        p_tok = self.tok.n_tokens(prompt) + 14  # template punctuation etc.
        r = self.rates
        u = _u(self.seed, qid, action, 0)

        if mode == "guarded":
            if answerable and hit:
                correct = u < r.g_hit_correct
                refused = (not correct) and u < r.g_hit_correct + r.g_hit_refuse
            elif answerable:
                refused = u < r.g_miss_refuse
                correct = (not refused) and u < r.g_miss_refuse + r.g_miss_correct
            else:
                refused = u < r.g_unans_refuse
                correct = False
        else:  # auto
            if answerable and hit:
                correct = u < r.a_hit_correct
                refused = (not correct) and u < r.a_hit_correct + r.a_hit_refuse
            elif answerable:
                correct = u < r.a_miss_correct
                refused = (not correct) and u < r.a_miss_correct + r.a_miss_refuse
            else:
                refused = u < r.a_unans_refuse
                correct = False

        answered = not refused
        hallucinated = answered and not correct
        if refused:
            answer, c_tok = DONT_KNOW_TEXT, 4
        elif correct:
            answer, c_tok = f"the answer is {gold_answer} .", 6
        else:
            answer, c_tok = f"the answer is val{int(u * 1e5):05d} .", 6
        return GenOutput(answer, refused, correct, hallucinated, p_tok, c_tok)
