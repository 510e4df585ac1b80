"""Configuration dataclasses for the PyTorch port.

An own copy of the reference's ``core/config.py``: the model-zoo
:class:`ModelConfig` plus the SLO-routing testbed configs
(:class:`RouterConfig`, :class:`SLOProfile`, :class:`RetrievalConfig`,
:class:`TestbedConfig`).  Field names and defaults are identical, so a
config printed by either package reads the same.  The MLA and MoE
sub-configs are not ported yet: the port serves dense GQA decoders and
the Mamba2 family (:class:`SSMConfig`), and those two fields stay
``None``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD config."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256
    n_groups: int = 1


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    arch_type: str = "dense"         # dense|moe|ssm|hybrid|audio|vlm
    source: str = ""                 # citation for the config values

    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0                # 0 → d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024

    # attention flavour
    attn_type: str = "gqa"           # gqa|mla|none
    qkv_bias: bool = False           # Qwen1.5
    attn_logit_softcap: float = 0.0
    rope_theta: float = 10000.0
    # sliding window attention: 0 = full attention everywhere
    sliding_window: int = 0
    # query-chunk size for the chunked-softmax attention path
    attn_q_chunk: int = 1024
    window_ring_cache: bool = False
    # kernel switches of the reference (its TPU kernels are opt-in); the
    # port's cached decode always runs the flash-decode kernel on the card
    use_pallas_attention: bool = False
    use_pallas_ssd: bool = False
    use_flash_decode: bool = False
    kv_quant_int8: bool = False
    embed_one_hot: bool = False
    # layer pattern for local/global mixes, e.g. ("L","L","L","L","L","G")
    # repeated across depth; empty → all "G" (global/full)
    attn_pattern: Tuple[str, ...] = ()

    # hybrid (Jamba) pattern: per-layer "A" (attention) or "M" (mamba),
    # repeated; empty → homogeneous per arch_type
    layer_pattern: Tuple[str, ...] = ()

    mla: Optional[Any] = None
    moe: Optional[Any] = None
    ssm: Optional[SSMConfig] = None

    # encoder-decoder (Whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq_len: int = 1500

    # multimodal stub frontends
    modality: str = "text"           # text|audio|vision
    n_modality_tokens: int = 0
    modality_embed_dim: int = 0

    # misc
    use_bias: bool = False
    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    mtp_depth: int = 0
    dtype: str = "bfloat16"
    vocab_pad_multiple: int = 256

    # remat policy for training: "none" | "full" | "dots"
    remat: str = "none"

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    def layer_kind(self, i: int) -> str:
        """'A' attention / 'M' mamba for layer i."""
        if self.layer_pattern:
            return self.layer_pattern[i % len(self.layer_pattern)]
        return "M" if self.arch_type == "ssm" else "A"

    def attn_kind(self, i: int) -> str:
        """'G' global / 'L' local(sliding) for attention layer i."""
        if self.attn_pattern:
            return self.attn_pattern[i % len(self.attn_pattern)]
        return "L" if self.sliding_window else "G"

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        if i < self.moe.first_k_dense:
            return False
        j = i - self.moe.first_k_dense
        return j % self.moe.moe_period == self.moe.moe_offset


# ---------------------------------------------------------------------------
# Paper-core configs (SLO routing)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SLOProfile:
    """SLO weight vector — eq. (1) of the paper."""

    name: str
    w_acc: float
    w_cost: float     # applied to cost_tokens / cost_scale
    w_hall: float
    w_ref: float      # reward for a correct refusal
    w_ref_wrong: float = 0.0  # penalty weight for refusing an answerable q
    # Pre-retrieval (action-4) refusals earn scaled credit: an informed
    # post-retrieval "I don't know" is worth more than a blind refusal
    # (paper §3.1 distinguishes the two refusal kinds).
    w_ref_pre_scale: float = 0.5
    cost_scale: float = 1000.0  # tokens are divided by this before weighting
    # cap on refusal rate enforced with a Lagrangian penalty during
    # policy training
    max_refusal_rate: float = 1.0


@dataclass(frozen=True)
class RouterConfig:
    """The paper's controller: MLP over state features → 5 actions."""

    state_dim: int = 272            # 256-d query embedding + 16 metadata
    embed_dim: int = 256
    n_meta_features: int = 16
    hidden_dims: Tuple[int, ...] = (128, 64)
    n_actions: int = 5
    dropout: float = 0.0
    # objective: argmax_ce | argmax_ce_wt | reward_weighted | constrained
    objective: str = "argmax_ce"
    margin_temp: float = 1.0        # WT weighting temperature
    lr: float = 3e-4
    batch_size: int = 64
    n_epochs: int = 30
    weight_decay: float = 1e-4
    seed: int = 0
    # feed the SLO weight vector into the state so one policy serves all
    # profiles
    condition_on_slo: bool = False


@dataclass(frozen=True)
class RetrievalConfig:
    vocab_hash_dim: int = 4096      # hashed lexical vocab (128-aligned)
    k1: float = 1.2                 # BM25 params [Robertson & Zaragoza 2009]
    b: float = 0.75
    max_k: int = 10
    dense_embed_dim: int = 256
    # hybrid fusion: "rrf" (reciprocal rank) | "weighted"
    hybrid_method: str = "rrf"
    hybrid_alpha: float = 0.5


@dataclass(frozen=True)
class TestbedConfig:
    """End-to-end paper testbed: corpus + retrieval + generator + router."""

    # not a pytest test class, despite the name (silences collection warning)
    __test__ = False

    n_train: int = 800
    n_eval: int = 200               # paper: N=200 dev examples
    n_paragraphs: int = 600
    answerable_frac: float = 0.5    # SQuAD2 dev is ~50/50
    seed: int = 0
    retrieval: RetrievalConfig = field(default_factory=RetrievalConfig)
    router: RouterConfig = field(default_factory=RouterConfig)
    generator_backend: str = "simulator"   # simulator | local_model
