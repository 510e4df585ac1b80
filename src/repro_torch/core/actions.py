"""The paper's action space and SLO profiles (§3.1, §3.2), and its
reward (eq. 1).

The action space and the SLO profiles live in the
:mod:`repro_torch.routing.registry`; this module re-exports the paper
defaults:

* ``ACTIONS`` / ``N_ACTIONS`` / ``REFUSE_ACTION`` — the registered
  ``"paper5"`` action space;
* ``SLO_PROFILES`` — the LIVE profile registry dict (profiles
  registered through ``register_slo_profile`` appear here too);
* ``reward`` — eq. (1).
"""
from __future__ import annotations

from repro_torch.core.config import SLOProfile
from repro_torch.routing.registry import (Action, ActionSpace,  # noqa: F401
                                          PAPER_ACTION_SPACE, SLO_PROFILES,
                                          get_action_space, get_slo_profile,
                                          register_slo_profile)

# Action 0..4 exactly as in the paper §3.1, via the default registry entry
ACTIONS = PAPER_ACTION_SPACE.actions
N_ACTIONS = PAPER_ACTION_SPACE.n_actions
REFUSE_ACTION = PAPER_ACTION_SPACE.refuse_action


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
