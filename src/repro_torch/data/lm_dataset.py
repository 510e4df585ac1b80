"""LM training batches from the synthetic corpus (for training loops).

An own copy of the reference's ``data/lm_dataset.py``: fixed-shape
(tokens, labels) numpy batches drawn from the hashed-token stream of a
``SyntheticSquad`` corpus, the same batches as the reference's for the
same seed, with the modality stubs' embeddings drawn from the same
generator in the same order: ``image_emb`` (B, n_modality_tokens,
modality_embed_dim) for a vision config, whose text then takes
``seq_len - n_modality_tokens`` positions, and ``audio_emb`` (B,
encoder_seq_len, d_model) for an audio one.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from repro_torch.core.config import ModelConfig
from repro_torch.data.synthetic_squad import SyntheticSquad
from repro_torch.data.tokenizer import HashTokenizer


class LMDataset:
    def __init__(self, cfg: ModelConfig, seq_len: int, seed: int = 0,
                 n_paragraphs: int = 200):
        self.cfg = cfg
        self.seq_len = seq_len
        self.rng = np.random.default_rng(seed)
        tok = HashTokenizer(cfg.vocab_size)
        corpus = SyntheticSquad(n_paragraphs=n_paragraphs, n_questions=10,
                                seed=seed)
        ids = []
        for p in corpus.paragraphs:
            ids.extend(tok.encode(p.text, eos=True))
        self.stream = np.asarray(ids, np.int32)

    def batches(self, batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
        cfg, S = self.cfg, self.seq_len
        s_txt = S - (cfg.n_modality_tokens if cfg.modality == "vision" else 0)
        n = len(self.stream) - s_txt - 1
        while True:
            starts = self.rng.integers(0, n, size=batch_size)
            toks = np.stack([self.stream[s: s + s_txt] for s in starts])
            labs = np.stack([self.stream[s + 1: s + 1 + s_txt]
                             for s in starts])
            batch = {"tokens": toks, "labels": labs}
            if cfg.modality == "vision":
                batch["image_emb"] = self.rng.standard_normal(
                    (batch_size, cfg.n_modality_tokens,
                     cfg.modality_embed_dim)).astype(np.float32) * 0.02
            if cfg.modality == "audio":
                batch["audio_emb"] = self.rng.standard_normal(
                    (batch_size, cfg.encoder_seq_len,
                     cfg.d_model)).astype(np.float32) * 0.02
            yield batch
