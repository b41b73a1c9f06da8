"""Plain PyTorch versions of fused similarity + top-k node retrieval.

``topk_similarity`` is the function the kernel path computes; the CPU takes
it, and the card is checked against it.  ``topk_sim_tiles`` is the kernel's
own output (per-tile top-k lists) in plain PyTorch, so the tile merge in
``ops.py`` is testable without a card.
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


def topk_sim_tiles(q: torch.Tensor, emb: torch.Tensor, k: int, c_blk: int):
    """Per-tile top-k of the kernel: (Q, ceil(N/c_blk), k) scores and global
    ids; rows past N score -inf.  Within a tile, a winner is masked to -inf
    before the next round (so a tile with fewer than k rows repeats its
    lowest -inf column, as the TPU kernel does)."""
    n = emb.shape[0]
    n_tiles = -(-n // c_blk)
    scores = torch.full((q.shape[0], n_tiles * c_blk), float("-inf"),
                        dtype=torch.float32, device=q.device)
    scores[:, :n] = q.float() @ emb.float().T
    tiles = scores.view(q.shape[0], n_tiles, c_blk).clone()
    s_out, i_out = [], []
    for _ in range(k):
        s, a = stable_topk(tiles, 1)
        s_out.append(s)
        i_out.append(a)
        tiles.scatter_(-1, a, float("-inf"))
    base = torch.arange(n_tiles, device=q.device)[None, :, None] * c_blk
    return torch.cat(s_out, -1), (torch.cat(i_out, -1) + base).to(torch.int32)
