"""Serving stack of the port: slot decode engine, retrieval cache, admission
prefetcher, fused RAG engine, replica router and the fault simulators."""
from repro_torch.serving.cache import CachedRetrieval, RetrievalCache
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.prefetch import AdmissionPrefetcher, PrefetchWave
from repro_torch.serving.rag_engine import RAGRequest, RAGServeEngine
from repro_torch.serving.router import ReplicaRouter
from repro_torch.serving.simulate import (
    DelayedRetrieval,
    FaultyReplica,
    FaultyRetrieval,
    LazyHostArray,
    ReplicaFault,
    RetrievalFault,
)
from repro_torch.serving.stats import flatten_stats

__all__ = [
    "ServingConfig", "flatten_stats",
    "ServeEngine", "Request",
    "RetrievalCache", "CachedRetrieval",
    "AdmissionPrefetcher", "PrefetchWave",
    "RAGServeEngine", "RAGRequest",
    "ReplicaRouter",
    "DelayedRetrieval", "FaultyRetrieval", "LazyHostArray", "RetrievalFault",
    "FaultyReplica", "ReplicaFault",
]
