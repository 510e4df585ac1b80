"""Command-R 35B — dense GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01]

The reference's simplified config, field for field: the RMSNorm
pre-norm block every dense decoder here has, not Cohere's parallel
attention + MLP block.
"""
from repro_torch.core.config import ModelConfig

FULL = ModelConfig(
    name="command-r-35b",
    arch_type="dense",
    source="hf:CohereForAI/c4ai-command-r-v01",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    attn_type="gqa",
    use_bias=False,
    tie_embeddings=True,
    rope_theta=8000000.0,
    remat="full",
)

SMOKE = ModelConfig(
    name="command-r-smoke",
    arch_type="dense",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    head_dim=32,
    d_ff=512,
    vocab_size=512,
    attn_type="gqa",
    use_bias=False,
    vocab_pad_multiple=64,
)
