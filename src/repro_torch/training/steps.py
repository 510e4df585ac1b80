"""Train / eval steps with optional microbatch gradient accumulation.

An own copy of the reference's ``training/steps.py`` (less ``moe_fn``:
no MoE layer is ported).  A step reads nothing back to the host: its
metrics are tensors, and the caller decides when to read them.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.registry import Model
from repro_torch.models.schema import tree_leaves
from repro_torch.models.transformer import forward_train_loss, loss_fn
from repro_torch.training.optimizer import OptConfig, adamw_update


def _split_microbatches(batch: Dict[str, torch.Tensor], n_mb: int):
    """The batch as ``n_mb`` microbatches of consecutive rows (views)."""
    for x in batch.values():
        if x.shape[0] % n_mb:
            raise ValueError(f"batch of {x.shape[0]} rows does not split "
                             f"into {n_mb} microbatches")
    parts = {k: x.chunk(n_mb) for k, x in batch.items()}
    return [{k: p[i] for k, p in parts.items()} for i in range(n_mb)]


def make_train_step(model: Model, opt_cfg: OptConfig, *,
                    microbatches: int = 1, fused_loss: bool = True):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics).

    ``batch`` is a dict with "tokens" and "labels".  ``microbatches > 1``
    accumulates the microbatches' gradients in float32, which bounds the
    saved activations to one microbatch's.  ``fused_loss`` computes CE
    chunk-wise without materializing the (B, S, V) logits tensor.  The
    params and the optimizer state are updated in place (see
    :func:`repro_torch.training.optimizer.adamw_update`); ``metrics``
    holds ``loss``, ``grad_norm`` and ``lr`` as tensors.
    """

    def loss_for(params, mb):
        if fused_loss:
            return forward_train_loss(params, model.cfg, mb)
        inputs = {k: v for k, v in mb.items() if k != "labels"}
        logits, extras = model.train_logits(params, inputs)
        return loss_fn(logits, mb["labels"], extras=extras)

    def value_and_grad(params, leaves, mb):
        loss = loss_for(params, mb)
        # a leaf the loss never reads (a Mamba2 layer's ln2: no MLP
        # follows it) gets a zero gradient, as jax.grad gives it
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        was = [p.requires_grad for p in leaves]
        try:
            for p in leaves:
                p.requires_grad_(True)
            with torch.enable_grad():
                if microbatches == 1:
                    loss, grads = value_and_grad(params, leaves, batch)
                else:
                    grads = [torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device) for p in leaves]
                    loss = 0.0
                    for mb in _split_microbatches(batch, microbatches):
                        l, g = value_and_grad(params, leaves, mb)
                        for a, b in zip(grads, g):
                            a.add_(b.float())
                        loss = loss + l
                        del g
                    grads = [g.div_(microbatches) for g in grads]
                    loss = loss / microbatches
        finally:
            for p, w in zip(leaves, was):
                p.requires_grad_(w)
        params, opt_state, metrics = adamw_update(grads, opt_state, params,
                                                  opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_eval_step(model: Model):
    """Returns eval_step(params, batch) -> loss (a float32 tensor), the
    ``loss_fn`` of ``model.train_logits`` with autograd off."""

    @torch.no_grad()
    def eval_step(params, batch):
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        logits, extras = model.train_logits(params, inputs)
        return loss_fn(logits, batch["labels"], extras=extras)

    return eval_step
