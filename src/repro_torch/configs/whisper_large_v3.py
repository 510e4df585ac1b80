"""Whisper-large-v3 — enc-dec audio; conv frontend stubbed. [arXiv:2212.04356]

The mel-spectrogram + conv feature extractor is a stub, as in the
reference: the caller provides precomputed frame embeddings (B, 1500,
d_model); the port implements the transformer backbone (32 encoder + 32
decoder layers).
"""
from repro_torch.core.config import ModelConfig

FULL = ModelConfig(
    name="whisper-large-v3",
    arch_type="audio",
    source="arXiv:2212.04356",
    n_layers=32,               # decoder
    n_encoder_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    attn_type="gqa",
    is_encoder_decoder=True,
    encoder_seq_len=1500,      # 30 s audio → 1500 frames
    modality="audio",
    modality_embed_dim=1280,
    remat="full",
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    arch_type="audio",
    n_layers=2,
    n_encoder_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    attn_type="gqa",
    is_encoder_decoder=True,
    encoder_seq_len=64,
    modality="audio",
    modality_embed_dim=256,
    vocab_pad_multiple=64,
)
