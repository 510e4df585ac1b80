"""Multi-method retrieval subsystem.

* ``bm25.py``   — sparse lexical BM25 over a hashed vocab;
* ``dense.py``  — dense retrieval over hashed n-gram embeddings (the
  fused score + top-k kernel in ``repro_torch.kernels.dense_topk``);
* ``hybrid.py`` — the :class:`Retriever` protocol, weighted/RRF fusion,
  the bounded LRU retrieval cache, circuit breakers and the bm25
  fallback;
* ``distributed.py`` — the corpus sharded over a mesh's data axis, one
  local-top-k -> all-gather -> merge path shared by BM25 and dense.
"""
from repro_torch.retrieval.bm25 import BM25Index
from repro_torch.retrieval.dense import DenseIndex, embed_text
from repro_torch.retrieval.distributed import (DistributedBM25,
                                               DistributedDenseIndex,
                                               distributed_bm25_topk,
                                               distributed_dense_topk,
                                               distributed_topk)
from repro_torch.retrieval.hybrid import (BreakerRetriever, CachedRetriever,
                                          CircuitBreaker, CircuitOpenError,
                                          HybridRetriever, IndexRetriever,
                                          RetrievalCache, Retriever,
                                          build_retriever_suite,
                                          collect_breakers,
                                          resolve_retrievers,
                                          retrieve_with_fallback)

__all__ = [
    "BM25Index", "DenseIndex", "embed_text",
    "DistributedBM25", "DistributedDenseIndex", "distributed_topk",
    "distributed_bm25_topk", "distributed_dense_topk",
    "Retriever", "IndexRetriever", "HybridRetriever",
    "RetrievalCache", "CachedRetriever",
    "CircuitBreaker", "CircuitOpenError", "BreakerRetriever",
    "collect_breakers", "retrieve_with_fallback",
    "build_retriever_suite", "resolve_retrievers",
]
