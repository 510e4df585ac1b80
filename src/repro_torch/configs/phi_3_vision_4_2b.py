"""Phi-3-vision-4.2B — phi3-mini backbone + CLIP vision stub.
[hf:microsoft/Phi-3-vision-128k-instruct]

The ViT/SigLIP encoder is a stub, as in the reference: the caller
provides precomputed patch embeddings (B, 576, 1024); the port
implements the projector and the language decoder.
"""
from repro_torch.core.config import ModelConfig

FULL = ModelConfig(
    name="phi-3-vision-4.2b",
    arch_type="vlm",
    source="hf:microsoft/Phi-3-vision-128k-instruct",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    attn_type="gqa",
    modality="vision",
    n_modality_tokens=576,     # CLIP ViT-L/14 @ 336px
    modality_embed_dim=1024,
    remat="full",
)

SMOKE = ModelConfig(
    name="phi3v-smoke",
    arch_type="vlm",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    attn_type="gqa",
    modality="vision",
    n_modality_tokens=16,
    modality_embed_dim=64,
    vocab_pad_multiple=64,
)
