"""Workset-compacted candidate expansion for subgraph construction.

The dense stage-3 path does O(N) work per query — every BFS hop pulls over
the full ``(Q, N, K)`` adjacency — for an O(max_nodes) result.  A *workset*
bounds that cost by the retrieved neighbourhood instead: seeds are expanded
hop by hop into a fixed-capacity, per-query candidate set of ``C`` global
node ids (C << N), kept **sorted ascending** so that membership tests
(:mod:`repro_torch.kernels.frontier_expand`) and global->local id
translation are log-time searches.

With no overflow the workset after ``max_hops`` hops is exactly the BFS
ball around the seeds, and ``dist`` holds exact hop distances.  On overflow
the per-query flag is set and truncation is deterministic: entries are
never evicted, so complete hops survive whole and the overflowing hop keeps
its lowest fresh ids.

All strategies then run over the *workset-local induced adjacency*
(``workset_adjacency``): ``(Q, C, K)`` neighbour slots holding positions
into the workset, sentinel ``C`` where the neighbour is absent.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels.frontier_expand import ops as fe_ops

INF = 0x3FFFFFF


@dataclasses.dataclass
class Workset:
    """Per-query candidate set: ``ids`` sorted ascending, sentinel = n."""

    ids: torch.Tensor  # (Q, C) int32 global node ids, sentinel n where unused
    dist: torch.Tensor  # (Q, C) int32 hop distance from the seed set, INF pad
    overflow: torch.Tensor  # (Q,) bool — ball exceeded capacity, truncated
    num_nodes: int  # N of the parent graph

    @property
    def cap(self) -> int:
        return int(self.ids.shape[1])


def _seed_workset(seeds: torch.Tensor, n: int, cap: int):
    """(Q, S) seed ids (pad with -1 or >= n) -> initial sorted workset.
    Distinct seeds past the capacity go to a slack column, then dropped."""
    q = seeds.shape[0]
    dev = seeds.device
    ids0 = torch.where((seeds >= 0) & (seeds < n), seeds, n).to(torch.int32)
    ids0 = torch.sort(ids0, dim=1).values
    first = (ids0 < n) & torch.cat(
        [torch.ones((q, 1), dtype=torch.bool, device=dev), ids0[:, 1:] != ids0[:, :-1]], 1)
    rank = torch.cumsum(first, dim=1, dtype=torch.int32) - 1
    ok = first & (rank < cap)
    tgt = torch.where(ok, rank, cap).long()
    ws_ids = torch.full((q, cap + 1), n, dtype=torch.int32, device=dev)
    ws_ids.scatter_(1, tgt, torch.where(ok, ids0, n))
    ws_dist = torch.full((q, cap + 1), INF, dtype=torch.int32, device=dev)
    ws_dist.scatter_(1, tgt, torch.where(ok, 0, INF).to(torch.int32))
    overflow = (first & (rank >= cap)).any(dim=1)
    return ws_ids[:, :cap].contiguous(), ws_dist[:, :cap].contiguous(), overflow


def build_workset(
    nbr: torch.Tensor,  # (N, K) int32 ELL adjacency, sentinel N
    nbr_mask: torch.Tensor,  # (N, K) bool
    seeds: torch.Tensor,  # (Q, S) int32 (pad with -1 or >= N)
    *,
    max_hops: int,
    cap: int,
    use_kernel: Optional[bool] = None,
) -> Workset:
    """Expand seeds into the capacity-``cap`` workset of the max_hops ball."""
    n = nbr.shape[0]
    ws_ids, ws_dist, overflow = _seed_workset(seeds, n, cap)
    for h in range(max_hops):
        ws_ids, ws_dist, _, dropped = fe_ops.expand_hop(
            ws_ids, ws_dist, nbr, nbr_mask, h + 1, band=max_hops + 2, use_kernel=use_kernel,
        )
        overflow = overflow | dropped
    return Workset(ids=ws_ids, dist=ws_dist, overflow=overflow, num_nodes=n)


def localize(ws_ids: torch.Tensor, ids: torch.Tensor):
    """Translate global node ids to workset positions.

    ws_ids (Q, C) sorted ascending; ids (Q, S) global.  Returns
    (pos (Q, S) int32 with sentinel C where absent, found (Q, S) bool).
    """
    c = ws_ids.shape[1]
    ids = ids.to(torch.int32)
    pos = torch.searchsorted(ws_ids.contiguous(), ids.contiguous(), out_int32=True)
    hit = torch.gather(ws_ids, 1, torch.clamp(pos, max=c - 1).long())
    found = (pos < c) & (hit == ids)
    return torch.where(found, pos, c), found


def workset_adjacency(nbr: torch.Tensor, nbr_mask: torch.Tensor, ws_ids: torch.Tensor):
    """Induce the parent adjacency onto workset positions.

    Returns (wnbr (Q, C, K) int32 positions into ws_ids with sentinel C,
    wmask (Q, C, K) bool — True iff the edge is real AND its endpoint is a
    workset member).  ELL row/slot order is preserved, so edge (c, k) here
    is edge (ws_ids[c], k) of the parent graph.
    """
    q, c = ws_ids.shape
    n, k = nbr.shape
    valid = ws_ids < n
    safe = torch.clamp(ws_ids, max=n - 1).long()
    gn = nbr[safe]  # (Q, C, K) global neighbour ids
    gm = valid[:, :, None] & nbr_mask[safe]
    pos, found = localize(ws_ids, gn.reshape(q, c * k))
    ok = gm & found.reshape(q, c, k)
    return torch.where(ok, pos.reshape(q, c, k), c), ok
