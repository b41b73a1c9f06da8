"""Similarity top-k (``topk_sim``): every query scored against every
embedding row in float32, then the k best kept.

Operations: 2 Q N D (multiply-adds of the scores).  Bytes: the queries and
the embeddings read once, the (Q, k) scores and ids written once."""
from __future__ import annotations


def flops(q: int, n: int, d: int, k: int) -> float:
    return 2.0 * q * n * d


def bytes_moved(q: int, n: int, d: int, k: int) -> float:
    return 4.0 * (q * d + n * d) + 8.0 * q * k
