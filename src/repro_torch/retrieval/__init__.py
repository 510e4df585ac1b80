from repro_torch.retrieval.bm25 import BM25Index

__all__ = ["BM25Index"]
