"""SLO-conditioned routing policies (paper §4.2) in torch.

The controller is a small MLP over s(q) producing a categorical
distribution over the actions, trained on the offline action-sweep log.
Objectives:

* ``argmax_ce``     — supervised classification of the per-state best
                      action (paper's Argmax-CE);
* ``argmax_ce_wt``  — CE weighted by the best-vs-second action margin
                      (paper's Argmax-CE-WT);
* ``soft_reward``   — reward-softmax soft targets (paper §4.2's
                      reward-weighted variant);
* ``constrained``   — beyond-paper mitigation for refusal collapse:
                      Argmax-CE with a Lagrangian cap on the expected
                      refusal probability (paper §7.1 calls for "a
                      calibrated abstention constraint").

Training follows the reference step for step: the targets and the
minibatch order are numpy's, the loss and the Adam update the
reference's formulas in float32.  Only the initial draw differs (torch's
generator, not ``jax.random``); ``init_params`` takes any other tree.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.actions import REFUSE_ACTION
from repro_torch.core.config import RouterConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.offline_log import OfflineLog
from repro_torch.models.schema import ParamSpec, init_from_schema

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


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


def host_logits(params, states, cfg: RouterConfig) -> np.ndarray:
    """The logits of host ``states``, computed on the params' device and
    brought back to the host."""
    x = torch.from_numpy(np.ascontiguousarray(states, np.float32))
    with torch.no_grad():
        return policy_logits(params, x.to(params["w0"].device),
                             cfg).cpu().numpy()


def policy_actions(params, states, cfg: RouterConfig) -> np.ndarray:
    """numpy's argmax of :func:`host_logits`: ties go to the lowest
    action, as in the reference."""
    return np.argmax(host_logits(params, states, cfg), axis=-1)


# ---------------------------------------------------------------------------
# Objectives
# ---------------------------------------------------------------------------


def make_targets(rewards: np.ndarray, objective: str,
                 margin_temp: float = 1.0):
    """Per-example targets/weights from the (N, A) reward matrix.

    numpy's default argsort, as the reference's: rows with tied rewards
    (every refusal under a profile earns the same) keep its tie order.
    """
    order = np.argsort(-rewards, axis=1)
    best = order[:, 0]
    second = order[:, 1]
    n = len(rewards)
    margin = rewards[np.arange(n), best] - rewards[np.arange(n), second]
    if objective in ("argmax_ce", "constrained"):
        w = np.ones(n, np.float32)
    elif objective == "argmax_ce_wt":
        w = (margin / (margin.mean() + 1e-8)) ** margin_temp
        w = w.astype(np.float32)
    elif objective == "soft_reward":
        w = np.ones(n, np.float32)
    else:
        raise ValueError(objective)
    soft = None
    if objective == "soft_reward":
        z = rewards / max(margin_temp, 1e-3)
        z = z - z.max(axis=1, keepdims=True)
        soft = (np.exp(z) / np.exp(z).sum(axis=1, keepdims=True)).astype(np.float32)
    return best.astype(np.int64), w, soft


@dataclass
class TrainResult:
    params: Dict
    history: list
    lagrange: float = 0.0


def train_policy(log: OfflineLog, rewards: np.ndarray, cfg: RouterConfig,
                 *, objective: Optional[str] = None,
                 refusal_cap: float = 1.0, dual_lr: float = 8.0,
                 seed: Optional[int] = None,
                 refuse_action: Optional[int] = None,
                 init_params=None, device="cuda") -> TrainResult:
    """Minibatch Adam training of the routing MLP on the offline log.

    ``refuse_action`` is the action index the Lagrangian refusal terms
    watch; the default resolves to the logged space's refuse action
    (falling back to the paper's action 4 for logs without the field).
    A log whose space has NO refuse action (``log.refuse_action is
    None``) disables the refusal term entirely.

    ``init_params`` (a tree of tensors, copied to ``device``) replaces
    the seeded :func:`init_policy` draw.  States, targets and weights go
    to the device once, each epoch's permutation once; the step's loss
    and refusal probability stay there until the epoch ends, when they
    are read back together for ``history`` and the dual update.
    """
    objective = objective or cfg.objective
    seed = cfg.seed if seed is None else seed
    dev = resolve_device(device)
    if refuse_action is None:
        refuse_action = getattr(log, "refuse_action", REFUSE_ACTION)
    ra = None if refuse_action is None else int(refuse_action)
    assert ra is None or ra < cfg.n_actions, (ra, cfg.n_actions)
    best, w, soft = make_targets(rewards, objective, cfg.margin_temp)

    def upload(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    states = upload(np.asarray(log.states, np.float32))
    best_t, w_t = upload(best), upload(w)
    soft_t = None if soft is None else upload(soft)

    if init_params is None:
        params = init_policy(seed, cfg, device=dev)
    else:
        params = {k: p.detach().to(dev, torch.float32, copy=True)
                  for k, p in init_params.items()}
    keys = sorted(params)
    for k in keys:
        params[k].requires_grad_(True)
    m = {k: torch.zeros_like(params[k]) for k in keys}
    v = {k: torch.zeros_like(params[k]) for k in keys}
    t = 0

    def loss_fn(sb, tb, wb, softb, lam):
        logp = torch.log_softmax(policy_logits(params, sb, cfg), dim=-1)
        if softb is not None:
            ce = -torch.sum(softb * logp, dim=-1)
        else:
            ce = -torch.gather(logp, 1, tb[:, None])[:, 0]
        loss = torch.mean(wb * ce)
        # weight decay on the weights only, in the reference's order
        l2 = sum(torch.sum(params[k] ** 2) for k in keys if k.startswith("w"))
        loss = loss + cfg.weight_decay * l2
        if ra is None:      # refuse-free space: no refusal term at all
            p_refuse = torch.zeros((), device=dev)
        else:
            p_refuse = torch.mean(torch.exp(logp[:, ra]))
        return loss + lam * p_refuse, p_refuse

    def adam_step(grads):
        # the reference's formula, float32, t as float32
        bc1 = float(1 - np.float32(ADAM_B1) ** np.float32(t))
        bc2 = float(1 - np.float32(ADAM_B2) ** np.float32(t))
        with torch.no_grad():
            for k, g in zip(keys, grads):
                m[k] = ADAM_B1 * m[k] + (1 - ADAM_B1) * g
                v[k] = ADAM_B2 * v[k] + (1 - ADAM_B2) * g ** 2
                params[k].sub_(cfg.lr * (m[k] / bc1)
                               / (torch.sqrt(v[k] / bc2) + ADAM_EPS))

    n = log.n
    rng = np.random.default_rng(seed)
    lam = 0.0
    history = []
    for epoch in range(cfg.n_epochs):
        perm = upload(rng.permutation(n))
        losses, prefs = [], []
        for s0 in range(0, n, cfg.batch_size):
            mb = perm[s0: s0 + cfg.batch_size]
            loss, p_ref = loss_fn(states[mb], best_t[mb], w_t[mb],
                                  None if soft_t is None else soft_t[mb],
                                  lam)
            grads = torch.autograd.grad(loss, [params[k] for k in keys])
            t += 1
            adam_step(grads)
            losses.append(loss.detach())
            prefs.append(p_ref.detach())
        # the epoch's one read back: every step's loss and p_refuse
        loss_np, pref_np = torch.stack(
            [torch.stack(losses), torch.stack(prefs)]).cpu().numpy()
        avg_ref = float(np.mean([float(x) for x in pref_np]))
        if objective == "constrained":
            lam = max(0.0, lam + dual_lr * (avg_ref - refusal_cap))
        history.append({"epoch": epoch,
                        "loss": float(np.mean([float(x) for x in loss_np])),
                        "p_refuse": avg_ref, "lambda": lam})
    params = {k: params[k].detach() for k in keys}
    return TrainResult(params=params, history=history, lagrange=lam)
