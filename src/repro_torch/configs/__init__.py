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


# The input shapes the reference assigns to this paper (global batch x
# sequence), which its dry run and launch/specs.py resolve.
INPUT_SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

# long_500k needs sub-quadratic attention or a bounded KV cache
LONG_CONTEXT_ARCHS = {"mamba2-130m", "jamba-1.5-large-398b", "gemma3-12b"}


def shape_supported(arch_id: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch_id in LONG_CONTEXT_ARCHS
    return True
