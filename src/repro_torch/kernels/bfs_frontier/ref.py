"""Plain PyTorch version of one batched pull-BFS frontier hop."""
from __future__ import annotations

import torch


def frontier_hop(frontier: torch.Tensor, nbr: torch.Tensor,
                 nbr_mask: torch.Tensor) -> torch.Tensor:
    """frontier (Q, N) bool; nbr (N, K) with sentinel N -> reach (Q, N) bool:
    reach[q, v] = OR_k frontier[q, nbr[v, k]] & nbr_mask[v, k]."""
    q = frontier.shape[0]
    fp = torch.cat([frontier, frontier.new_zeros((q, 1))], dim=1)
    g = fp[:, nbr.long()]  # (Q, N, K)
    return (g & nbr_mask[None]).any(dim=-1)
