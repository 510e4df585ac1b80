"""The paper's own configuration: the SLO-routing testbed.

Unlike the decoder architectures, the paper's "architecture" is a
control system: the 5-action space, two SLO profiles, the BM25
retriever, and the Argmax-CE router MLP.  This module pins the canonical
hyperparameters, field for field the reference's.  These are
``TestbedConfig``s, not decoders: nothing here is registered with
``configs.get_config``.
"""
from repro_torch.core.config import (RetrievalConfig, RouterConfig, TestbedConfig)

# Canonical testbed: N=200 eval (paper §5.1), 800 train, 600 paragraphs.
FULL = TestbedConfig(
    n_train=800,
    n_eval=200,
    n_paragraphs=600,
    answerable_frac=0.5,
    seed=0,
    retrieval=RetrievalConfig(vocab_hash_dim=4096, k1=1.2, b=0.75, max_k=10),
    router=RouterConfig(
        state_dim=272, embed_dim=256, n_meta_features=16,
        hidden_dims=(128, 64), n_actions=5,
        objective="argmax_ce", lr=3e-4, batch_size=64, n_epochs=30),
)

# Reduced variant for smoke tests / quickstart.
SMOKE = TestbedConfig(
    n_train=120, n_eval=60, n_paragraphs=120,
    router=RouterConfig(n_epochs=8),
)
