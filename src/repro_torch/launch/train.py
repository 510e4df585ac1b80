"""Training entry point.

Trains ``--variant`` of ``--arch`` for ``--steps`` steps of AdamW on the
synthetic LM stream, on the card unless ``--device cpu`` asks for the
host, and optionally writes an npz checkpoint (the reference's format).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-32b \\
        --variant smoke --steps 20 --ckpt /tmp/ckpt

The flags are the reference's ``launch/train.py`` local mode's, plus
``--device``.  ``--arch`` keeps the reference's default, ``mamba2-130m``;
its SMOKE variant trains at the config's chunk of 64 (FULL's 256 gives a
NaN gradient in the reference as here, ``ROADMAP.md`` queue 3).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.data.lm_dataset import LMDataset
from repro_torch.models.registry import build_model
from repro_torch.models.schema import zeros_from_schema
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.optimizer import OptConfig, adamw_init_schema
from repro_torch.training.steps import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--variant", default="smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, args.variant)
    model = build_model(cfg)
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                        total_steps=args.steps)
    params = model.init(seed=0, device=dev)
    opt_state = zeros_from_schema(adamw_init_schema(model.schema), device=dev)

    step_fn = make_train_step(model, opt_cfg, microbatches=args.microbatches)
    ds = LMDataset(cfg, args.seq)
    it = ds.batches(args.batch)

    t0 = time.perf_counter()
    losses = []
    for step in range(1, args.steps + 1):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == 1:
            dt = time.perf_counter() - t0
            recent = np.mean(losses[-args.log_every:])
            print(f"step {step:5d}  loss {recent:.4f}"
                  f"  grad_norm {float(metrics['grad_norm']):.3f}"
                  f"  lr {float(metrics['lr']):.2e}  {dt:.1f}s")
    if args.ckpt:
        p = save_checkpoint(args.ckpt, args.steps, params, opt_state,
                            {"arch": args.arch, "loss": losses[-1]})
        print("saved", p)
    if not np.isfinite(losses[-1]):
        raise SystemExit("training diverged")
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
