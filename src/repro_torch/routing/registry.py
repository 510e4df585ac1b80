"""Action-space and SLO-profile registries — the routing control surface.

The paper fixes a 5-action space (§3.1) and two SLO profiles (§3.2);
production serving needs both to be *data*, not hardcoded tuples:
retrieval depths differ per corpus, SLO profiles arrive from request
headers or config files, and new named spaces must not fork the router.

This module owns:

* :class:`Action` / :class:`ActionSpace` — an immutable, validated,
  named action space (retrieval depth + prompting mode per action);
* a named action-space registry, seeded with the paper's 5-action
  space under the name ``"paper5"`` so every paper number reproduces
  bit-for-bit through the registry path;
* a named SLO-profile registry, seeded with the paper's
  ``quality_first`` / ``cheap`` profiles, extensible from plain dicts
  (:func:`slo_profile_from_config`).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

from repro_torch.core.config import SLOProfile

VALID_MODES = ("guarded", "auto", "refuse")


@dataclass(frozen=True)
class Action:
    idx: int
    k: int            # retrieval depth (0 = no retrieval)
    mode: str         # guarded | auto | refuse
    # which registered retriever serves this action's depth-k lookup
    # (the second big cost/quality lever after depth; "bm25" keeps the
    # paper's single-retriever space bit-for-bit)
    retriever: str = "bm25"


@dataclass(frozen=True)
class ActionSpace:
    """A named, ordered action space.

    Invariants: action indices equal their position, modes are valid,
    refuse actions retrieve nothing.
    """

    name: str
    actions: Tuple[Action, ...]

    def __post_init__(self):
        if not self.actions:
            raise ValueError(f"action space {self.name!r} is empty")
        for pos, a in enumerate(self.actions):
            if a.idx != pos:
                raise ValueError(
                    f"{self.name!r}: action at position {pos} has idx {a.idx}")
            if a.mode not in VALID_MODES:
                raise ValueError(f"{self.name!r}: invalid mode {a.mode!r}")
            if a.mode == "refuse" and a.k != 0:
                raise ValueError(
                    f"{self.name!r}: refuse action {pos} must have k=0")
            if not a.retriever:
                raise ValueError(
                    f"{self.name!r}: action {pos} has empty retriever")

    @property
    def n_actions(self) -> int:
        return len(self.actions)

    @property
    def refuse_action(self) -> Optional[int]:
        """Index of the (first) refuse action, or None."""
        for a in self.actions:
            if a.mode == "refuse":
                return a.idx
        return None

    def __len__(self) -> int:
        return len(self.actions)

    def __iter__(self) -> Iterator[Action]:
        return iter(self.actions)

    def __getitem__(self, idx: int) -> Action:
        return self.actions[idx]

    def to_config(self) -> dict:
        return {"name": self.name,
                "actions": [asdict(a) for a in self.actions]}

    @classmethod
    def from_config(cls, cfg: Mapping) -> "ActionSpace":
        """Build from a plain dict, e.g. parsed JSON/YAML.

        ``{"name": ..., "actions": [{"k": 5, "mode": "guarded",
        "retriever": "dense"}, ...]}`` (``idx`` defaults to the list
        position, ``retriever`` to ``"bm25"``).
        """
        actions = tuple(
            Action(int(a.get("idx", i)), int(a["k"]), str(a["mode"]),
                   str(a.get("retriever", "bm25")))
            for i, a in enumerate(cfg["actions"]))
        return cls(str(cfg["name"]), actions)

    @property
    def retriever_names(self) -> Tuple[str, ...]:
        """Retrievers this space's non-refuse actions reference (the
        set an executor must be able to resolve), in first-use order."""
        seen = []
        for a in self.actions:
            if a.mode != "refuse" and a.retriever not in seen:
                seen.append(a.retriever)
        return tuple(seen)


# ---------------------------------------------------------------------------
# Registries
# ---------------------------------------------------------------------------

_ACTION_SPACES: Dict[str, ActionSpace] = {}
# the live profile registry
SLO_PROFILES: Dict[str, SLOProfile] = {}
_SLO_PROFILES = SLO_PROFILES

DEFAULT_SPACE = "paper5"


def register_action_space(space: ActionSpace, *,
                          overwrite: bool = False) -> ActionSpace:
    if space.name in _ACTION_SPACES and not overwrite:
        raise ValueError(f"action space {space.name!r} already registered")
    _ACTION_SPACES[space.name] = space
    return space


def get_action_space(name: str = DEFAULT_SPACE) -> ActionSpace:
    try:
        return _ACTION_SPACES[name]
    except KeyError:
        raise KeyError(f"unknown action space {name!r}; "
                       f"registered: {sorted(_ACTION_SPACES)}") from None


def list_action_spaces() -> List[str]:
    return sorted(_ACTION_SPACES)


def register_slo_profile(profile: SLOProfile, *,
                         overwrite: bool = False) -> SLOProfile:
    if profile.name in _SLO_PROFILES and not overwrite:
        raise ValueError(f"SLO profile {profile.name!r} already registered")
    _SLO_PROFILES[profile.name] = profile
    return profile


def get_slo_profile(name_or_profile) -> SLOProfile:
    """Resolve a profile name (or pass a profile through)."""
    if isinstance(name_or_profile, SLOProfile):
        return name_or_profile
    try:
        return _SLO_PROFILES[name_or_profile]
    except KeyError:
        raise KeyError(f"unknown SLO profile {name_or_profile!r}; "
                       f"registered: {sorted(_SLO_PROFILES)}") from None


def list_slo_profiles() -> List[str]:
    return sorted(_SLO_PROFILES)


def slo_profile_from_config(cfg: Mapping) -> SLOProfile:
    """Build (and optionally register) a profile from a plain dict."""
    return SLOProfile(**dict(cfg))


# ---------------------------------------------------------------------------
# Paper defaults (§3.1, §3.2) — registered at import so the default
# registry entries reproduce every paper number bit-for-bit.
# ---------------------------------------------------------------------------

PAPER_ACTION_SPACE = register_action_space(ActionSpace(
    DEFAULT_SPACE,
    (Action(0, 2, "guarded"),
     Action(1, 5, "guarded"),
     Action(2, 10, "guarded"),
     Action(3, 5, "auto"),
     Action(4, 0, "refuse"))))

register_slo_profile(SLOProfile(
    name="quality_first",
    w_acc=1.0, w_cost=0.1, w_hall=0.25, w_ref=0.1, w_ref_wrong=0.15))
register_slo_profile(SLOProfile(
    name="cheap",
    w_acc=0.3, w_cost=0.8, w_hall=0.3, w_ref=0.35, w_ref_wrong=1.0))


# ---------------------------------------------------------------------------
# hybrid9: retriever choice as a routing action (beyond paper).
#
# The paper varies only DEPTH over one BM25 index; hybrid9 adds the
# other big cost/quality lever — WHICH retriever — crossing
# {bm25, dense, hybrid} × depth × {guarded, auto} (+ refuse).  The
# refuse action stays last, so the constrained objective's Lagrangian
# and the Gateway's cap logic carry over via ``space.refuse_action``.
#
# NOTE: the profile registry is deliberately NOT extended here — every
# registered profile feeds run_experiment's grid, and adding entries at
# import would silently change the paper tables.  hybrid9 serves under
# the paper's own profiles (SPACE_DEFAULT_PROFILES below); register
# bespoke profiles explicitly from config where needed.
# ---------------------------------------------------------------------------

HYBRID9_SPACE = register_action_space(ActionSpace(
    "hybrid9",
    (Action(0, 2, "guarded", "bm25"),
     Action(1, 5, "guarded", "bm25"),
     Action(2, 2, "guarded", "dense"),
     Action(3, 5, "guarded", "dense"),
     Action(4, 2, "guarded", "hybrid"),
     Action(5, 5, "guarded", "hybrid"),
     Action(6, 5, "auto", "bm25"),
     Action(7, 5, "auto", "hybrid"),
     Action(8, 0, "refuse"))))

# the SLO profiles each registered space is evaluated/served under by
# default (benchmarks' objective-ablation grids iterate these)
SPACE_DEFAULT_PROFILES: Dict[str, Tuple[str, ...]] = {
    "paper5": ("quality_first", "cheap"),
    "hybrid9": ("quality_first", "cheap"),
}
