"""Device resolution for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``.  A
request for the card on a machine without one raises: nothing in the
port falls back to the CPU on its own.  The CPU tests pass
``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch sees no CUDA device; "
            "pass device='cpu' explicitly to run on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
