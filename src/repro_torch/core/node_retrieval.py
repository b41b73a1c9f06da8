"""Stage 2 of the RGL pipeline: semantic node retrieval (paper §2.1.2).

Embeds queries (optionally through a user-supplied encoder) and returns the
top-k seed nodes per query from a vector index.  Batched end to end.
"""
from __future__ import annotations

from typing import Callable, Optional


def retrieve_nodes(index, queries, k: int, *, encoder: Optional[Callable] = None):
    """queries: (Q, D_in); returns (scores (Q,k), node_ids (Q,k))."""
    q = queries
    if encoder is not None:
        q = encoder(q)
    return index.search(q, k)
