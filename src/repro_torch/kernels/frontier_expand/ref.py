"""Plain PyTorch version of the workset membership mark: a batched
lower-bound search (``torch.searchsorted``) plus a gather and compare."""
from __future__ import annotations

import torch


def ws_member(ws_ids: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """ws_ids (Q, C) int32 sorted ascending per row; cand (Q, W) int32.

    Returns (Q, W) bool: True where the candidate id appears in its row's
    workset.  Sentinel-padded workset slots are ordinary values — a
    candidate equal to the pad value *will* match it; callers mask
    sentinels themselves (convention: sentinel == num_nodes).
    """
    c = ws_ids.shape[1]
    pos = torch.searchsorted(ws_ids.contiguous(), cand.contiguous(), side="left")
    hit = torch.gather(ws_ids, 1, torch.clamp(pos, max=c - 1))
    return (pos < c) & (hit == cand)
