"""Plain PyTorch versions of fused similarity + top-k node retrieval.

``topk_similarity`` is the function the kernel computes (scan and merge in
one launch); the CPU takes it, and the card is checked against it.
"""
from __future__ import annotations

import torch


def stable_topk(x: torch.Tensor, k: int):
    """Top-k along the last axis, largest first, lower index first among
    equal values — ``lax.top_k``'s order (``torch.topk`` promises none)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def lex_order(s: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Permutation along the last axis that orders by (s desc, key asc) --
    the reference's 2-key ``lax.sort`` on (-s, key)."""
    by_key = torch.argsort(key, dim=-1, stable=True)
    by_s = torch.argsort(torch.gather(s, -1, by_key), dim=-1, descending=True, stable=True)
    return torch.gather(by_key, -1, by_s)


def topk_similarity(q: torch.Tensor, emb: torch.Tensor, k: int):
    """q (Q, D), emb (N, D) -> (scores (Q, k) f32, ids (Q, k) int32), exact
    fp32 dot-product retrieval, ties to the lower id."""
    scores = q.float() @ emb.float().T
    s, i = stable_topk(scores, min(k, emb.shape[0]))
    return s, i.to(torch.int32)
