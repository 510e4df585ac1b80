"""Mamba2-130M — attention-free SSD. [arXiv:2405.21060]"""
from repro_torch.core.config import ModelConfig, SSMConfig

FULL = ModelConfig(
    name="mamba2-130m",
    arch_type="ssm",
    source="arXiv:2405.21060",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,                    # pure mamba blocks, no MLP
    vocab_size=50280,
    attn_type="none",
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  chunk_size=256),
    remat="full",
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    arch_type="ssm",
    n_layers=2,
    d_model=256,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=512,
    attn_type="none",
    ssm=SSMConfig(d_state=32, d_conv=4, expand=2, head_dim=64, chunk_size=64),
    vocab_pad_multiple=64,
)
