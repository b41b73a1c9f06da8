"""ELL (padded neighbor list) graph format — the device-side layout.

Every node stores exactly ``max_deg`` neighbor slots; unused slots hold the
sentinel ``num_nodes`` and a False mask bit.  Gathers index arrays of length
``num_nodes + 1`` whose last row is a neutral element, so a BFS hop is one
fixed-shape gather.  High-degree tails beyond ``max_deg`` are truncated
(choose ``max_deg >= max degree`` for exactness).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.graph.csr import CSRGraph


@dataclasses.dataclass
class ELLGraph:
    """``nbr[i, k]`` = k-th neighbor of node i, or ``num_nodes`` (sentinel)."""

    nbr: torch.Tensor  # (N, max_deg) int32
    nbr_mask: torch.Tensor  # (N, max_deg) bool — True where a real edge exists
    num_nodes: int
    node_feat: Optional[torch.Tensor] = None  # (N, F) float32

    @property
    def max_deg(self) -> int:
        return int(self.nbr.shape[1])

    @property
    def sentinel(self) -> int:
        return self.num_nodes

    def degrees(self) -> torch.Tensor:
        return self.nbr_mask.sum(dim=1, dtype=torch.int32)


def csr_to_ell(
    g: CSRGraph, max_deg: Optional[int] = None, *, pad_to_multiple: int = 8,
    device="cuda",
) -> ELLGraph:
    """Convert CSR → ELL on the host (the reference's exact layout), then
    move it to ``device``."""
    dev = resolve_device(device)
    nbr, mask = ell_arrays(g, max_deg, pad_to_multiple=pad_to_multiple)
    feat = None
    if g.node_feat is not None:
        feat = torch.from_numpy(np.asarray(g.node_feat, np.float32)).to(dev)
    return ELLGraph(
        nbr=torch.from_numpy(nbr).to(dev),
        nbr_mask=torch.from_numpy(mask).to(dev),
        num_nodes=g.num_nodes,
        node_feat=feat,
    )


def ell_arrays(g: CSRGraph, max_deg: Optional[int] = None, *,
               pad_to_multiple: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """The host arrays of :func:`csr_to_ell`: (nbr (N, K) int32 with
    sentinel N, mask (N, K) bool)."""
    deg = g.degrees()
    if max_deg is None:
        max_deg = int(deg.max()) if g.num_nodes else 1
    max_deg = max(1, max_deg)
    if pad_to_multiple > 1:
        max_deg = -(-max_deg // pad_to_multiple) * pad_to_multiple
    n = g.num_nodes
    nbr = np.full((n, max_deg), n, dtype=np.int32)
    take = np.minimum(deg, max_deg)
    rows = np.repeat(np.arange(n), take)
    slots = _ranges(take)
    src_pos = np.repeat(g.indptr[:-1], take) + slots
    nbr[rows, slots] = g.indices[src_pos]
    mask = np.arange(max_deg)[None, :] < take[:, None]
    return nbr, mask


def _ranges(counts: np.ndarray) -> np.ndarray:
    """[0..c0-1, 0..c1-1, ...] without a Python loop."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    idx = np.arange(total, dtype=np.int64)
    starts = np.repeat(np.cumsum(counts) - counts, counts)
    return idx - starts
