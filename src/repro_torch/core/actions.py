"""The paper's reward (eq. 1).

The action space and SLO profiles live in
:mod:`repro_torch.routing.registry`.
"""
from __future__ import annotations

from repro_torch.core.config import SLOProfile


def reward(profile: SLOProfile, *, correct: bool, cost_tokens: float,
           hallucinated: bool, refused: bool, answerable: bool,
           pre_retrieval: bool = False) -> float:
    """Eq. (1):  r = w_acc·Acc − w_cost·Cost − w_hall·Hall + w_ref·Ref.

    Ref credits correct refusals and penalizes incorrect ones (paper
    §3.2: "captures correct refusals (and penalizes incorrect
    refusals)").  Pre-retrieval refusals earn scaled credit (§3.1's
    refusal-semantics distinction).
    """
    acc = 1.0 if correct else 0.0
    hall = 1.0 if hallucinated else 0.0
    if refused:
        if answerable:
            ref = -profile.w_ref_wrong
        else:
            ref = profile.w_ref * (profile.w_ref_pre_scale
                                   if pre_retrieval else 1.0)
    else:
        ref = 0.0
    return (profile.w_acc * acc
            - profile.w_cost * cost_tokens / profile.cost_scale
            - profile.w_hall * hall
            + ref)
