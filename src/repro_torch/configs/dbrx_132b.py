"""DBRX-132B — fine-grained MoE, 16 experts top-4. [hf:databricks/dbrx-base]"""
from repro_torch.core.config import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="dbrx-132b",
    arch_type="moe",
    source="hf:databricks/dbrx-base",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    attn_type="gqa",
    rope_theta=500000.0,
    moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752),
    remat="full",
)

SMOKE = ModelConfig(
    name="dbrx-smoke",
    arch_type="moe",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    head_dim=32,
    d_ff=512,
    vocab_size=512,
    attn_type="gqa",
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=512),
    vocab_pad_multiple=64,
)
