"""DeepSeek-V3 671B — MLA, 1 shared + 256 routed top-8 fine-grained MoE,
multi-token prediction. [arXiv:2412.19437]

Assigned spec: 61L d_model=7168 128H d_ff=2048 (= per-expert hidden)
vocab=129280.  First 3 layers dense (intermediate 18432 per the paper).
"""
from repro_torch.core.config import MLAConfig, ModelConfig, MoEConfig

FULL = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    source="arXiv:2412.19437",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=192,              # qk_nope(128) + qk_rope(64)
    d_ff=18432,                # dense-prefix MLP width (paper §4)
    vocab_size=129280,
    attn_type="mla",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048,
                  n_shared_experts=1, first_k_dense=3),
    mtp_depth=1,
    tie_embeddings=False,
    remat="full",
)

SMOKE = ModelConfig(
    name="deepseek-smoke",
    arch_type="moe",
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
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128,
                  n_shared_experts=1, first_k_dense=1),
    mtp_depth=1,
    tie_embeddings=False,
    vocab_pad_multiple=64,
)
