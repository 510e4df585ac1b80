"""Model configs the port serves (``get_config(arch_id, variant)``).

Each module exposes ``FULL`` (the exact assigned configuration, cited)
and ``SMOKE`` (a reduced same-family variant for the CPU tests).  The
dense-GQA and Mamba2 families are ported so far; the other families of
the reference registry arrive with their layers.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.core.config import ModelConfig

ARCH_IDS: List[str] = ["qwen1.5-32b", "mamba2-130m"]
# the reference's other architectures, which arrive with their layers
UNPORTED_ARCH_IDS: List[str] = [
    "dbrx-132b", "minicpm3-4b", "whisper-large-v3", "jamba-1.5-large-398b",
    "phi-3-vision-4.2b", "command-r-35b", "deepseek-v3-671b", "gemma3-12b"]

_MODULES: Dict[str, str] = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch_id: str, variant: str = "full") -> ModelConfig:
    if arch_id in UNPORTED_ARCH_IDS:
        raise NotImplementedError(f"{arch_id}: not ported yet; ROADMAP.md "
                                  f"queue 1, item 8")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return getattr(mod, variant.upper())
