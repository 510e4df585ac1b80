"""AdamW with linear-warmup cosine decay and global-norm clipping.

An own copy of the reference's ``training/optimizer.py``, with its
arithmetic: fp32 moments, ``step + 1`` first, fp32 bias corrections,
clip scale ``min(1, clip_norm / (gnorm + 1e-9))``, decoupled weight decay
on every leaf with ``ndim >= 1`` (biases and norms included), and the
new params cast back to their dtype.  Trees are the nested dicts and
lists of :mod:`repro_torch.models.schema`, visited in the same order.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict

import torch

from repro_torch.models.schema import ParamSpec, tree_leaves, tree_map


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    clip_norm: float = 1.0


def _moment_spec(ps: ParamSpec) -> ParamSpec:
    return dataclasses.replace(ps, dtype="float32", init="zeros")


def adamw_init_schema(param_schema) -> Dict[str, Any]:
    """The optimizer state's schema: fp32 ``m`` and ``v`` shaped as the
    params, and an int32 scalar ``step``.  Materialize it with
    :func:`repro_torch.models.schema.zeros_from_schema`."""
    return {
        "m": tree_map(_moment_spec, param_schema),
        "v": tree_map(_moment_spec, param_schema),
        "step": ParamSpec((), (), "int32", "zeros"),
    }


def lr_at(cfg: OptConfig, step):
    """Learning rate at ``step`` (a tensor), as a float32 tensor."""
    step = step.float()
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(leaf.float() ** 2)
                          for leaf in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: OptConfig):
    """One AdamW step.  Returns (params, opt_state, metrics) with
    ``metrics`` holding ``grad_norm`` and ``lr`` as tensors.

    Unlike the reference, which returns new trees, the port updates the
    params and the moments IN PLACE, leaf by leaf, and returns the same
    trees: a second copy of a multi-GB model and its fp32 moments would
    not fit beside them.  The numbers are the reference's.  ``grads`` may
    be in the params' dtype or float32 (accumulated microbatches).
    """
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"]), tree_leaves(params)):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        del g
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.dim() >= 1:  # decoupled weight decay (skip scalars/norms-ish)
            u = u + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * u)
    opt_state["step"].copy_(step)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
