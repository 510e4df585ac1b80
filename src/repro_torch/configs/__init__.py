"""Model configs the port serves (``get_config(arch_id, variant)``).

Each module exposes ``FULL`` (the exact assigned configuration, cited)
and ``SMOKE`` (a reduced same-family variant for the CPU tests).  Only
the dense-GQA families are ported so far; the other families of the
reference registry arrive with their layers.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.core.config import ModelConfig

ARCH_IDS: List[str] = ["qwen1.5-32b"]

_MODULES: Dict[str, str] = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch_id: str, variant: str = "full") -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return getattr(mod, variant.upper())
