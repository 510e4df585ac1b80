"""The routing MLP's forward pass (paper §4.2).

A small MLP over the state s(q) scoring each action.  This slice ports
inference only: the params come from the reference's trained policy
through :mod:`repro_torch.bridge`, or from a seeded init.  Training the
router on the offline log is a later slice (``ROADMAP.md`` queue 1,
item 6).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.config import RouterConfig
from repro_torch.core.device import resolve_device
from repro_torch.models.schema import ParamSpec, init_from_schema


def policy_schema(cfg: RouterConfig):
    dims = (cfg.state_dim,) + cfg.hidden_dims + (cfg.n_actions,)
    schema = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        schema[f"w{i}"] = ParamSpec((a, b), ("", ""), "float32",
                                    "normal", scale=float(np.sqrt(2.0 / a)))
        schema[f"b{i}"] = ParamSpec((b,), ("",), "float32", "zeros")
    return schema


def init_policy(seed: int, cfg: RouterConfig, *, device="cuda"):
    """Seeded He-normal init (the reference's schema, torch's draws)."""
    return init_from_schema(policy_schema(cfg), seed=seed,
                            device=resolve_device(device))


def policy_logits(params, states, cfg: RouterConfig):
    x = states
    n_layers = len(cfg.hidden_dims) + 1
    for i in range(n_layers):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            x = torch.relu(x)
    return x
