"""MiniCPM3-4B — dense with MLA. [hf:openbmb/MiniCPM3-4B]"""
from repro_torch.core.config import MLAConfig, ModelConfig

FULL = ModelConfig(
    name="minicpm3-4b",
    arch_type="dense",
    source="hf:openbmb/MiniCPM3-4B",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=96,  # qk_nope(64) + qk_rope(32)
    d_ff=6400,
    vocab_size=73448,
    attn_type="mla",
    mla=MLAConfig(kv_lora_rank=256, q_lora_rank=768,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
    remat="full",
)

SMOKE = ModelConfig(
    name="minicpm3-smoke",
    arch_type="dense",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=8,
    head_dim=48,
    d_ff=512,
    vocab_size=512,
    attn_type="mla",
    mla=MLAConfig(kv_lora_rank=64, q_lora_rank=96,
                  qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32),
    vocab_pad_multiple=64,
)
