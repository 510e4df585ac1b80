"""Qwen1.5-32B — dense with QKV bias. [hf:Qwen/Qwen1.5-0.5B family]"""
from repro_torch.core.config import ModelConfig

FULL = ModelConfig(
    name="qwen1.5-32b",
    arch_type="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    attn_type="gqa",
    qkv_bias=True,
    rope_theta=1000000.0,
    remat="full",
)

SMOKE = ModelConfig(
    name="qwen-smoke",
    arch_type="dense",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    attn_type="gqa",
    qkv_bias=True,
    vocab_pad_multiple=64,
)
