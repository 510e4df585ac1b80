"""Prompt templates — verbatim from the paper's Appendix A."""
from __future__ import annotations

from typing import Sequence

GUARDED_TEMPLATE = """You are a careful question-answering assistant.
Use ONLY the information in CONTEXT to answer the QUESTION.
If the answer is not in CONTEXT, respond with: "I don't know."

CONTEXT:
{retrieved_passages}

QUESTION:
{question}

Answer (one short sentence):"""

AUTO_TEMPLATE = """Answer the QUESTION using the CONTEXT below.

CONTEXT: {retrieved_passages}

QUESTION: {question}

Answer:"""

REFUSAL_TEXT = "I cannot answer that."
DONT_KNOW_TEXT = "I don't know."


def build_prompt(mode: str, question: str, passages: Sequence[str]) -> str:
    ctx = "\n\n".join(passages)
    if mode == "guarded":
        return GUARDED_TEMPLATE.format(retrieved_passages=ctx,
                                       question=question)
    if mode == "auto":
        return AUTO_TEMPLATE.format(retrieved_passages=ctx,
                                    question=question)
    raise ValueError(mode)
