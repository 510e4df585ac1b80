"""Offline log generation (paper §4.1) and the logged-replay dataset.

For every question we execute ALL actions ("full action sweep") and
store per-action metrics; rewards are recomputed per SLO profile from
the stored indicators, exactly as the paper regenerates rewards without
re-calling the generator.

Logs are action-space generic: the sweep runs over any registered
:class:`~repro_torch.routing.registry.ActionSpace` (the paper's ``paper5`` is
the default and reproduces bit-for-bit), and the log remembers which
action index is the pre-retrieval refusal so eq. (1)'s refusal-credit
scaling survives spaces where refuse is not action 4 (e.g. ``hybrid9``).

The sweep runs on the host, one question at a time, as the reference's
does, so the log is the reference's bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.actions import reward
from repro_torch.core.config import RouterConfig, SLOProfile, TestbedConfig
from repro_torch.core.features import state_vector
from repro_torch.data.synthetic_squad import Question, SyntheticSquad
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.generation.simulator import SimulatedGenerator
from repro_torch.retrieval.bm25 import BM25Index
from repro_torch.retrieval.dense import DenseIndex
from repro_torch.retrieval.hybrid import build_retriever_suite
from repro_torch.routing.registry import ActionSpace, get_action_space
from repro_torch.serving.pipeline import RAGPipeline

_SAVE_KEYS = ("states", "correct", "refused", "hallucinated", "cost",
              "hit", "answerable", "qids")


@dataclass
class OfflineLog:
    states: np.ndarray        # (N, state_dim)
    correct: np.ndarray       # (N, A) bool
    refused: np.ndarray       # (N, A) bool
    hallucinated: np.ndarray  # (N, A) bool
    cost: np.ndarray          # (N, A) float
    hit: np.ndarray           # (N, A) bool
    answerable: np.ndarray    # (N,) bool
    qids: np.ndarray          # (N,)
    # which action is the pre-retrieval refusal (paper5's action 4);
    # None = no refuse action in the logged space
    refuse_action: Optional[int] = 4

    @property
    def n(self) -> int:
        return len(self.qids)

    @property
    def n_actions(self) -> int:
        return self.correct.shape[1]

    def rewards(self, profile: SLOProfile) -> np.ndarray:
        """(N, A) reward matrix under an SLO profile (eq. 1)."""
        A = self.n_actions
        r = np.zeros((self.n, A), np.float32)
        for i in range(self.n):
            for a in range(A):
                r[i, a] = reward(
                    profile,
                    correct=bool(self.correct[i, a]),
                    cost_tokens=float(self.cost[i, a]),
                    hallucinated=bool(self.hallucinated[i, a]),
                    refused=bool(self.refused[i, a]),
                    answerable=bool(self.answerable[i]),
                    pre_retrieval=(a == self.refuse_action))
        return r

    def subset(self, idx: np.ndarray) -> "OfflineLog":
        return OfflineLog(self.states[idx], self.correct[idx],
                          self.refused[idx], self.hallucinated[idx],
                          self.cost[idx], self.hit[idx],
                          self.answerable[idx], self.qids[idx],
                          refuse_action=self.refuse_action)

    def save(self, path: str | Path):
        arrays = {k: getattr(self, k) for k in _SAVE_KEYS}
        # -1 encodes "no refuse action in this space" so None round-trips
        # (a file without the key is a paper5 log: refuse at 4)
        arrays["refuse_action"] = np.int64(
            -1 if self.refuse_action is None else self.refuse_action)
        np.savez_compressed(path, **arrays)

    @classmethod
    def load(cls, path: str | Path) -> "OfflineLog":
        z = np.load(path)
        ra = int(z["refuse_action"]) if "refuse_action" in z.files else 4
        return cls(**{k: z[k] for k in _SAVE_KEYS},
                   refuse_action=None if ra < 0 else ra)


def generate_log(questions: Sequence[Question], pipeline: RAGPipeline,
                 index: BM25Index, router_cfg: RouterConfig,
                 space: Optional[ActionSpace] = None) -> OfflineLog:
    space = space if space is not None else get_action_space()
    n, A = len(questions), len(space)
    states = np.zeros((n, router_cfg.state_dim), np.float32)
    correct = np.zeros((n, A), bool)
    refused = np.zeros((n, A), bool)
    hall = np.zeros((n, A), bool)
    cost = np.zeros((n, A), np.float32)
    hit = np.zeros((n, A), bool)
    answerable = np.zeros(n, bool)
    qids = np.zeros(n, np.int64)

    for i, q in enumerate(questions):
        states[i] = state_vector(q.text, index, router_cfg)
        answerable[i] = q.answerable
        qids[i] = q.qid
        for out in pipeline.sweep(q, space):
            a = out.action
            correct[i, a] = out.correct
            refused[i, a] = out.refused
            hall[i, a] = out.hallucinated
            cost[i, a] = out.cost_tokens
            hit[i, a] = out.hit
    return OfflineLog(states, correct, refused, hall, cost, hit,
                      answerable, qids, refuse_action=space.refuse_action)


def build_testbed(cfg: TestbedConfig, space: Optional[ActionSpace] = None):
    """Corpus + index + pipeline + (train_log, eval_log).

    ``space=None`` is the paper's registered default (bit-for-bit).  A
    space whose actions reference the ``dense``/``hybrid`` retrievers
    (e.g. ``hybrid9``) additionally builds the dense index and wires
    the full retriever suite into the pipeline.
    """
    data = SyntheticSquad(
        n_paragraphs=cfg.n_paragraphs,
        n_questions=cfg.n_train + cfg.n_eval,
        answerable_frac=cfg.answerable_frac,
        seed=cfg.seed)
    texts = [p.text for p in data.paragraphs]
    index = BM25Index.build(texts, cfg.retrieval)
    retrievers = None
    if space is not None and set(space.retriever_names) - {"bm25"}:
        retrievers = build_retriever_suite(
            index, DenseIndex.build(texts, cfg.retrieval))
    tok = HashTokenizer(32768)
    gen = SimulatedGenerator(tok, seed=cfg.seed)
    pipe = RAGPipeline(index, gen, retrievers)
    train_q, eval_q = data.split(cfg.n_eval)
    train_log = generate_log(train_q, pipe, index, cfg.router, space)
    eval_log = generate_log(eval_q, pipe, index, cfg.router, space)
    return data, index, pipe, train_log, eval_log
