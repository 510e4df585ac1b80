"""Jamba-1.5-Large 398B — hybrid Mamba+attention 1:7, MoE 16e top-2.
[arXiv:2403.19887]

Block of 8 layers: attention at position 4 (attn_layer_period=8,
offset=4), MoE on odd positions (expert_layer_period=2, offset=1).
"""
from repro_torch.core.config import ModelConfig, MoEConfig, SSMConfig

_PATTERN = ("M", "M", "M", "M", "A", "M", "M", "M")

FULL = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    source="arXiv:2403.19887",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    attn_type="gqa",
    layer_pattern=_PATTERN,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576,
                  moe_period=2, moe_offset=1),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, chunk_size=256),
    remat="full",
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    arch_type="hybrid",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    head_dim=32,
    d_ff=512,
    vocab_size=512,
    attn_type="gqa",
    layer_pattern=("M", "A"),
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=512,
                  moe_period=2, moe_offset=1),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, chunk_size=64),
    vocab_pad_multiple=64,
)
