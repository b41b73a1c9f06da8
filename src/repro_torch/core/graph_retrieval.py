"""Stage 3 of the RGL pipeline: batched graph retrieval (paper §2.1.3).

RGL-BFS over the ELL adjacency with the dense backend: every hop is one
pull over all N nodes for all Q queries (:mod:`repro_torch.kernels.bfs_frontier`
on the card).  The output contract — nodes, mask, dist, including tie order —
is the reference's (``repro.core.graph_retrieval``).  The compact workset
backend and the other strategies are not ported yet (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.graph.ell import ELLGraph
from repro_torch.kernels.bfs_frontier import ops as bfs_frontier_ops
from repro_torch.kernels.topk_sim.ref import stable_topk

INF = 0x3FFFFFF

# graphs at least this large route to the compact backend under mode="auto"
# in the reference; the port does not have that backend yet
AUTO_COMPACT_MIN_NODES = 100_000

_COMPACT = "ROADMAP Queue 1 item 7 (compact workset backend)"
_STRATEGIES = "ROADMAP Queue 1 item 8 (dense/steiner/ppr strategies)"


@dataclasses.dataclass
class Subgraph:
    """Padded per-query subgraph: ``nodes`` ordered by retrieval priority.
    ``overflow`` is only set by the compact backend (None here)."""

    nodes: torch.Tensor  # (Q, M) int32, sentinel = num_nodes where ~mask
    mask: torch.Tensor  # (Q, M) bool
    dist: torch.Tensor  # (Q, M) int32 hop distance of each picked node
    num_nodes: int  # N of the parent graph
    overflow: Optional[torch.Tensor] = None  # (Q,) bool, compact backend only


def seeds_to_mask(seeds: torch.Tensor, n: int) -> torch.Tensor:
    """(Q, S) seed indices (pad with -1 or >=n) -> (Q, N) bool mask."""
    valid = (seeds >= 0) & (seeds < n)
    safe = torch.where(valid, seeds, 0).long()
    base = torch.zeros((seeds.shape[0], n), dtype=torch.uint8, device=seeds.device)
    return base.scatter_reduce(1, safe, valid.to(torch.uint8), reduce="amax").bool()


def bfs_distances(nbr, nbr_mask, seeds_mask: torch.Tensor, max_hops: int) -> torch.Tensor:
    """Batched BFS hop distances.  (Q, N) int32; INF where unreached."""
    dist = torch.full(seeds_mask.shape, INF, dtype=torch.int32, device=seeds_mask.device)
    dist.masked_fill_(seeds_mask, 0)
    frontier = seeds_mask
    for h in range(max_hops):
        reach = bfs_frontier_ops.frontier_hop(frontier, nbr, nbr_mask)
        frontier = reach & (dist == INF)
        dist.masked_fill_(frontier, h + 1)
    return dist


def _select_by_key(key: torch.Tensor, keep: torch.Tensor, m: int, n: int):
    """Pick m nodes with the smallest ``key`` among ``keep``; pad w/ sentinel n.

    Returns (nodes (Q,m) int32, mask (Q,m) bool, order-aligned gather of key).
    Equal keys keep the lower node first (the reference's ``lax.top_k``).
    """
    big = 0x7FFFFFF0
    k = torch.where(keep, key, big).to(torch.int32)
    topv, topi = stable_topk(-k, m)  # largest of -key == smallest key
    mask = topv > -big
    nodes = torch.where(mask, topi, n).to(torch.int32)
    return nodes, mask, torch.where(mask, -topv, INF).to(torch.int32)


def bfs_subgraph(nbr, nbr_mask, seeds: torch.Tensor, *, max_hops: int = 3,
                 max_nodes: int = 64) -> Subgraph:
    """RGL-BFS: closest-first ball around the retrieved seed nodes."""
    n = nbr.shape[0]
    sm = seeds_to_mask(seeds, n)
    dist = bfs_distances(nbr, nbr_mask, sm, max_hops)
    keep = dist < INF
    d = torch.clamp(dist, max=max_hops + 1)
    key = d * n + torch.arange(n, dtype=torch.int32, device=d.device)[None, :]
    nodes, mask, _ = _select_by_key(key, keep, max_nodes, n)
    picked = torch.gather(d, 1, torch.clamp(nodes, max=n - 1).long())
    dsel = torch.where(mask, picked, INF).to(torch.int32)
    return Subgraph(nodes=nodes, mask=mask, dist=dsel, num_nodes=n)


def retrieve_subgraph(
    g: ELLGraph,
    seeds,
    strategy: str = "bfs",
    *,
    mode: str = "auto",
    workset_cap: int = 2048,
    **kw,
) -> Subgraph:
    """Strategy dispatch over an :class:`ELLGraph` (public entry point).

    Only the dense BFS is ported: ``mode="dense"``, and ``mode="auto"`` on
    graphs below ``AUTO_COMPACT_MIN_NODES`` (where the reference's auto is
    dense too).
    """
    if mode not in ("dense", "compact", "auto"):
        raise ValueError(f"unknown retrieval mode: {mode!r}")
    if strategy != "bfs":
        raise NotImplementedError(f"strategy {strategy!r} is not ported yet: {_STRATEGIES}")
    use_compact = mode == "compact" or (
        mode == "auto"
        and g.num_nodes >= AUTO_COMPACT_MIN_NODES
        and workset_cap < g.num_nodes
    )
    if use_compact:
        raise NotImplementedError(
            f"mode={mode!r} on {g.num_nodes} nodes takes the compact backend, not "
            f"ported yet: {_COMPACT}; pass mode='dense'"
        )
    seeds = torch.as_tensor(seeds, device=g.nbr.device).to(torch.int32)
    return bfs_subgraph(g.nbr, g.nbr_mask, seeds, **kw)


def induced_adjacency(nbr, nbr_mask, sub: Subgraph):
    """Relabel the parent adjacency onto subgraph positions.

    Returns (sub_nbr (Q, M, K) positions into sub.nodes with sentinel M,
    sub_mask (Q, M, K)), batched over queries.
    """
    q, m = sub.nodes.shape
    n, k = nbr.shape
    dev = nbr.device
    safe = torch.where(sub.mask, sub.nodes, n).long()
    lut = torch.full((q, n + 1), m, dtype=torch.int64, device=dev)
    pos = torch.arange(m, device=dev)[None].expand(q, m)
    lut = lut.scatter_reduce(1, safe, pos, reduce="amin")
    lut[:, n] = m
    rows = torch.clamp(safe, max=n - 1)
    gn = nbr[rows]  # (Q, M, K) original neighbor ids
    gm = nbr_mask[rows] & sub.mask[:, :, None]
    pos = torch.gather(lut, 1, gn.reshape(q, -1).long()).reshape(q, m, k)
    ok = gm & (pos < m)
    return torch.where(ok, pos, m).to(torch.int32), ok
