"""Gemma3-12B — 5:1 local:global sliding-window attention, 128k context.
[hf:google/gemma-3-1b-pt family card; 12B variant]

The reference's simplified config, field for field: one ``rope_theta``
for every layer and no qk-norm, as in the reference.
"""
from repro_torch.core.config import ModelConfig

FULL = ModelConfig(
    name="gemma3-12b",
    arch_type="dense",
    source="hf:google/gemma-3-1b-pt",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    attn_type="gqa",
    sliding_window=1024,
    attn_pattern=("L", "L", "L", "L", "L", "G"),
    rope_theta=1000000.0,
    remat="full",
)

SMOKE = ModelConfig(
    name="gemma3-smoke",
    arch_type="dense",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    attn_type="gqa",
    sliding_window=32,
    attn_pattern=("L", "G"),
    vocab_pad_multiple=64,
)
