"""Shared testbed/policy cache so each table reuses one sweep."""
from __future__ import annotations

import dataclasses
import functools
import json
import time
from pathlib import Path

from repro_torch.core.config import TestbedConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.experiment import run_experiment

ART_DIR = Path(__file__).resolve().parent / "artifacts"


@functools.lru_cache(maxsize=None)
def canonical_results(device="cuda", init_params=None):
    """One full experiment on the canonical testbed (N=200 eval), its
    policies trained on ``device``; cached per device and initial draw.
    ``init_params(router_cfg)`` gives each training's initial params
    (default: the seeded draw)."""
    cfg = TestbedConfig()
    res, extras, logs = run_experiment(
        cfg, include_mitigation=True, refusal_cap=0.45, verbose=False,
        init_params=init_params, device=device)
    return cfg, res, extras, logs


@functools.lru_cache(maxsize=None)
def canonical_hybrid9_logs(device="cuda"):
    """hybrid9 offline logs (9-action full sweep with the dense/hybrid
    retrievers) on the canonical testbed sizes — the retriever-choice
    counterpart of :func:`canonical_results`.  The sweep runs on the
    host; ``device`` is where its policies will train."""
    from repro_torch.core.offline_log import build_testbed
    from repro_torch.routing import get_action_space

    resolve_device(device)
    space = get_action_space("hybrid9")
    cfg = TestbedConfig()
    cfg = dataclasses.replace(cfg, router=dataclasses.replace(
        cfg.router, n_actions=space.n_actions))
    data, index, pipe, train_log, eval_log = build_testbed(cfg, space)
    return cfg, space, (train_log, eval_log)


def initial(init_params, router_cfg):
    """``init_params(router_cfg)``, or None (the seeded draw)."""
    return None if init_params is None else init_params(router_cfg)


def save_artifact(name: str, obj) -> Path:
    ART_DIR.mkdir(parents=True, exist_ok=True)
    p = ART_DIR / f"{name}.json"
    p.write_text(json.dumps(obj, indent=1))
    return p


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e6


def bar(x: float, scale: float = 50) -> str:
    n = max(0, int(x * scale))
    return "#" * n
