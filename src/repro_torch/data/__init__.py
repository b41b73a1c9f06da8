"""Data pipeline of the port: synthetic corpora, fixed-length LM samples,
RAG-augmented token streams and host sharding."""
from repro_torch.data.pipeline import (
    TokenDataset, host_shard_iter, rag_token_stream, synthetic_corpus,
)

__all__ = [
    "TokenDataset", "rag_token_stream", "host_shard_iter", "synthetic_corpus",
]
