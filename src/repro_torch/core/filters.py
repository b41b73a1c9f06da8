"""Dynamic node filtering (paper §1/§2: cut token consumption pre-generation).

Filters operate on a retrieved :class:`Subgraph` and a per-node relevance
score, reducing the node budget while always preserving the seed terminals.
Fixed shapes: filtering = reordering + masking, never reshaping.
"""
from __future__ import annotations

import torch

from repro_torch.core.graph_retrieval import INF, Subgraph
from repro_torch.kernels.topk_sim.ref import stable_topk


def dynamic_filter(
    sub: Subgraph,
    node_scores: torch.Tensor,  # (N,) or (Q, N) relevance (higher = keep)
    seeds: torch.Tensor,  # (Q, S)
    *,
    budget: int,
) -> Subgraph:
    """Keep the ``budget`` highest-scoring retrieved nodes (+ all seeds).

    Seeds all score +inf and padding -inf, so the order among equal scores
    decides which nodes survive: it is position order, as in the reference.
    """
    q, m = sub.nodes.shape
    n = sub.num_nodes
    if node_scores.ndim == 1:
        node_scores = node_scores[None].expand(q, n)
    safe = torch.clamp(sub.nodes, max=n - 1).long()
    s = torch.gather(node_scores, 1, safe)  # (Q, M)
    is_seed = (sub.nodes[:, :, None] == seeds[:, None, :]).any(-1) & sub.mask
    s = torch.where(is_seed, torch.inf, s)
    s = torch.where(sub.mask, s, -torch.inf)
    top_s, pos = stable_topk(s, min(budget, m))
    nodes = torch.gather(sub.nodes, 1, pos)
    mask = top_s > -torch.inf
    dist = torch.gather(sub.dist, 1, pos)
    return Subgraph(
        nodes=torch.where(mask, nodes, n).to(torch.int32),
        mask=mask,
        dist=torch.where(mask, dist, INF).to(torch.int32),
        num_nodes=n,
        overflow=sub.overflow,
    )


def similarity_scores(node_emb: torch.Tensor, query_emb: torch.Tensor) -> torch.Tensor:
    """(N, D) x (Q, D) -> (Q, N) cosine relevance for dynamic filtering."""
    ne = node_emb / (torch.sqrt(torch.sum(node_emb * node_emb, -1, keepdim=True)) + 1e-6)
    qe = query_emb / (torch.sqrt(torch.sum(query_emb * query_emb, -1, keepdim=True)) + 1e-6)
    return qe @ ne.T
