"""Plain PyTorch version of batched ELL neighbour aggregation (subgraph
encoding): the function ``ops.ell_aggregate`` computes, which the CPU takes
and the card's kernel is checked against."""
from __future__ import annotations

import torch


def ell_aggregate(feat: torch.Tensor, nbr: torch.Tensor, nbr_mask: torch.Tensor) -> torch.Tensor:
    """feat (Q, M, D); nbr (Q, M, K) positions in [0, M] (M = the zero
    sentinel; larger ids count as the sentinel); nbr_mask (Q, M, K) bool.

    ``out[q, i] = sum_k mask[q, i, k] * feat[q, nbr[q, i, k]]``, accumulated
    in fp32 and returned in ``feat.dtype``.  The slots are summed one after
    another in slot order, as the TPU kernel's unrolled loop does, so the
    card's kernel (which adds the same fp32 values in the same order) is
    held to this bit for bit."""
    q, m, d = feat.shape
    fp = torch.cat([feat, feat.new_zeros((q, 1, d))], dim=1).float()  # (Q, M+1, D)
    idx = nbr.long().clamp(max=m)
    rows = torch.arange(q, device=feat.device)[:, None]
    acc = torch.zeros((q, m, d), dtype=torch.float32, device=feat.device)
    for kk in range(nbr.shape[2]):
        g = fp[rows, idx[:, :, kk]]  # (Q, M, D) row gather
        acc = acc + torch.where(nbr_mask[:, :, kk, None], g, 0.0)
    return acc.to(feat.dtype)
