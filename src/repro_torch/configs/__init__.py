"""Model configs the port serves (``get_config(arch_id, variant)``).

Each module exposes ``FULL`` (the exact assigned configuration, cited)
and ``SMOKE`` (a reduced same-family variant for the CPU tests).  Every
family of the reference registry is ported: dense GQA, mixture of
experts, Mamba2, Jamba (Mamba + attention + MoE), Gemma3
(sliding-window), multi-head latent attention (MiniCPM3, DeepSeek-V3
with MoE and multi-token prediction), Phi-3-vision (the patch
projector before the decoder) and Whisper (encoder-decoder with
cross-attention).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.core.config import ModelConfig

ARCH_IDS: List[str] = ["qwen1.5-32b", "mamba2-130m", "command-r-35b",
                       "dbrx-132b", "jamba-1.5-large-398b", "gemma3-12b",
                       "minicpm3-4b", "deepseek-v3-671b",
                       "phi-3-vision-4.2b", "whisper-large-v3"]
# the reference's architectures not ported yet: none
UNPORTED_ARCH_IDS: List[str] = []

_MODULES: Dict[str, str] = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch_id: str, variant: str = "full") -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return getattr(mod, variant.upper())
