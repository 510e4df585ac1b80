"""PyTorch port of ``repro`` (SLO-routed RAG serving), for CUDA cards.

Mirrors the layout of the JAX package ``repro``, which stays the
reference the port is held against; the port imports nothing of it.
Entry points take ``device=`` and default to ``"cuda"``; a missing card
raises (see :mod:`repro_torch.core.device`).
"""
