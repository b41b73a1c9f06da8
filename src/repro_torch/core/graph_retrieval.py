"""Stage 3 of the RGL pipeline: batched graph retrieval (paper §2.1.3).

All four strategies — RGL-BFS, RGL-Dense, RGL-Steiner and PPR — as
fixed-shape frontier algebra over the ELL adjacency, each in two backends
with one output contract (the reference's, ``repro.core.graph_retrieval``,
tie order included):

* **dense**   — per-hop work is O(N): every BFS hop is one pull over all N
  nodes for all Q queries (:mod:`repro_torch.kernels.bfs_frontier` on the
  card).  Never truncates.
* **compact** — per-hop work is O(C): seeds are expanded into a
  fixed-capacity sorted workset of C candidate ids
  (:mod:`repro_torch.core.workset`, whose hops run the
  :mod:`repro_torch.kernels.frontier_expand` mark kernel on the card), and
  the strategy runs over the workset-local adjacency.  With no overflow the
  output equals the dense backend's exactly; overflow is reported per query
  (``mode="auto"`` re-runs dense when any query overflows).

Graphs must be symmetric (the generators symmetrize; pull-BFS reads
in-neighbours).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.workset import Workset, build_workset, localize, workset_adjacency
from repro_torch.graph.ell import ELLGraph
from repro_torch.kernels.bfs_frontier import ops as bfs_frontier_ops
from repro_torch.kernels.topk_sim.ref import stable_topk
from repro_torch.tracing import span

INF = 0x3FFFFFF
_INT32_MAX = 2**31 - 1  # what an empty segment of a segment-min holds

# graphs at least this large route to the compact backend under mode="auto"
AUTO_COMPACT_MIN_NODES = 100_000


@dataclasses.dataclass
class Subgraph:
    """Padded per-query subgraph: ``nodes`` ordered by retrieval priority.

    ``overflow`` is only set by the compact backend: True for queries whose
    candidate ball exceeded the workset capacity (output truncated
    deterministically).  ``None`` means the dense backend ran.
    """

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


def voronoi_bfs(nbr, nbr_mask, seeds: torch.Tensor, max_hops: int):
    """Multi-source BFS with source labels.

    Returns (dist (Q,N) int32, label (Q,N) int32 in [0,T) or T for none).
    Ties: lowest terminal slot wins.
    """
    q, t = seeds.shape
    n = nbr.shape[0]
    dev = seeds.device
    valid = (seeds >= 0) & (seeds < n)
    safe = torch.where(valid, seeds, 0).long()
    slot = torch.arange(t, dtype=torch.int32, device=dev)[None].expand(q, t)
    slot = torch.where(valid, slot, t)
    label = torch.full((q, n), t, dtype=torch.int32, device=dev)
    label = label.scatter_reduce(1, safe, slot, reduce="amin")
    dist = torch.where(label < t, 0, INF).to(torch.int32)
    frontier = dist == 0
    idx = nbr.long()
    for h in range(max_hops):
        fp = torch.cat([frontier, frontier.new_zeros((q, 1))], 1)
        lp = torch.cat([label, label.new_full((q, 1), t)], 1)
        active = fp[:, idx] & nbr_mask[None]  # (Q, N, K) neighbour in frontier
        best = torch.where(active, lp[:, idx], t).amin(dim=-1)  # lowest frontier label
        frontier = active.any(dim=-1) & (dist == INF)
        dist = torch.where(frontier, h + 1, dist)
        label = torch.where(frontier, best, label)
    return dist, label


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


def _select_ws(key: torch.Tensor, keep: torch.Tensor, ws: Workset, m: int):
    """Workset-local ``_select_by_key``: same keys, positions mapped back to
    global ids.  Keys embed the global node id, so with identical (key, keep)
    sets the selection — values, order, padding — matches the dense path.

    Returns (nodes (Q,m) int32 global, mask (Q,m) bool, topi (Q,m) positions).
    """
    n = ws.num_nodes
    big = 0x7FFFFFF0
    k = torch.where(keep & (ws.ids < n), key, big).to(torch.int32)
    topv, topi = stable_topk(-k, m)
    mask = topv > -big
    nodes = torch.where(mask, torch.gather(ws.ids, 1, topi), n)
    return nodes.to(torch.int32), mask, topi


def _gather_local(rowvals: torch.Tensor, wnbr: torch.Tensor, fill) -> torch.Tensor:
    """Gather per-slot values over the local adjacency with a slack column.

    rowvals (Q, C); wnbr (Q, C, K) positions with sentinel C; ``fill`` is the
    value served for sentinel slots.  Returns (Q, C, K).
    """
    q, c, k = wnbr.shape
    padded = torch.cat([rowvals, rowvals.new_full((q, 1), fill)], 1)
    return torch.gather(padded, 1, wnbr.reshape(q, c * k).long()).reshape(q, c, k)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row-wise gather ``x[q, idx[q, ...]]`` (``take_along_axis`` on axis 1)."""
    return torch.gather(x, 1, idx.long())


# ---------------------------------------------------------------- BFS --------


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
    picked = _take(d, torch.clamp(nodes, max=n - 1))
    dsel = torch.where(mask, picked, INF).to(torch.int32)
    return Subgraph(nodes=nodes, mask=mask, dist=dsel, num_nodes=n)


def bfs_subgraph_compact(nbr, nbr_mask, seeds: torch.Tensor, *, max_hops: int = 3,
                         max_nodes: int = 64, workset_cap: int = 2048) -> Subgraph:
    """RGL-BFS over the workset: O(C) per hop instead of O(N)."""
    n = nbr.shape[0]
    ws = build_workset(nbr, nbr_mask, seeds, max_hops=max_hops, cap=workset_cap)
    # padding rows (dist INF) are not kept; the clamp only keeps their key in range
    key = torch.clamp(ws.dist, max=max_hops + 1) * n + torch.where(ws.ids < n, ws.ids, 0)
    nodes, mask, topi = _select_ws(key, ws.ids < n, ws, max_nodes)
    dsel = torch.where(mask, _take(ws.dist, topi), INF).to(torch.int32)
    return Subgraph(nodes=nodes, mask=mask, dist=dsel, num_nodes=n, overflow=ws.overflow)


# ---------------------------------------------------------------- Dense ------


def _peel(cand, sm, indeg, n_rounds: int, m: int):
    """``n_rounds`` of greedy peeling: keep candidates whose internal degree
    reaches the m-th largest, and every seed."""
    for _ in range(n_rounds):
        deg = indeg(cand)
        kth = torch.topk(torch.where(cand, deg, -1), m, dim=1).values[:, -1]
        cand = (cand & (deg >= kth[:, None])) | sm
    return cand


def dense_subgraph(nbr, nbr_mask, seeds: torch.Tensor, *, max_hops: int = 2,
                   max_nodes: int = 64, n_rounds: int = 3) -> Subgraph:
    """RGL-Dense: greedy internal-degree peeling of the k-hop candidate ball."""
    n, k = nbr.shape
    q = seeds.shape[0]
    sm = seeds_to_mask(seeds, n)
    dist = bfs_distances(nbr, nbr_mask, sm, max_hops)
    idx = nbr.long()

    def indeg(c):
        cp = torch.cat([c, c.new_zeros((q, 1))], 1)
        return (cp[:, idx] & nbr_mask[None]).sum(-1, dtype=torch.int32) * c

    cand = _peel(dist < INF, sm, indeg, n_rounds, min(max_nodes, n))
    deg = indeg(cand)
    # final pick: highest internal degree first, then closer, then lower id;
    # seeds get the minimal key band (always < n) so they are never evicted
    d = torch.clamp(dist, max=max_hops + 1)
    ar = torch.arange(n, dtype=torch.int32, device=d.device)[None, :]
    key = (k + 1 - deg) * ((max_hops + 2) * n) + d * n + ar
    key = torch.where(sm, ar, key)
    nodes, mask, _ = _select_by_key(key, cand, max_nodes, n)
    dsel = torch.where(mask, _take(d, torch.clamp(nodes, max=n - 1)), INF).to(torch.int32)
    return Subgraph(nodes=nodes, mask=mask, dist=dsel, num_nodes=n)


def dense_subgraph_compact(nbr, nbr_mask, seeds: torch.Tensor, *, max_hops: int = 2,
                           max_nodes: int = 64, n_rounds: int = 3,
                           workset_cap: int = 2048) -> Subgraph:
    """RGL-Dense over the workset: peeling scores C nodes per round, not N."""
    n, k = nbr.shape
    ws = build_workset(nbr, nbr_mask, seeds, max_hops=max_hops, cap=workset_cap)
    wnbr, wmask = workset_adjacency(nbr, nbr_mask, ws.ids)
    valid = ws.ids < n
    sm = valid & (ws.dist == 0)  # seed slots: the distinct valid seeds

    def indeg(c):
        g = _gather_local(c, wnbr, False) & wmask
        return g.sum(-1, dtype=torch.int32) * c

    # every workset entry is inside the max_hops ball
    cand = _peel(valid, sm, indeg, n_rounds, min(max_nodes, workset_cap))
    deg = indeg(cand)
    d = torch.clamp(ws.dist, max=max_hops + 1)
    gid = torch.where(valid, ws.ids, 0)
    key = (k + 1 - deg) * ((max_hops + 2) * n) + d * n + gid
    key = torch.where(sm, gid, key)
    nodes, mask, topi = _select_ws(key, cand, ws, max_nodes)
    dsel = torch.where(mask, _take(d, topi), INF).to(torch.int32)
    return Subgraph(nodes=nodes, mask=mask, dist=dsel, num_nodes=n, overflow=ws.overflow)


# ---------------------------------------------------------------- Steiner ----


def _seg_min(vals: torch.Tensor, segs: torch.Tensor, t: int) -> torch.Tensor:
    """Per-row segment min over ``t*t`` segments; an empty segment holds
    int32 max (``jax.ops.segment_min``'s identity), not INF."""
    out = torch.full((vals.shape[0], t * t), _INT32_MAX, dtype=torch.int32, device=vals.device)
    return out.scatter_reduce(1, segs.long(), vals.to(torch.int32), reduce="amin")


def _terminal_metric(d_src, d_dst, l_src, l_dst, e_mask, eid, t: int, eid_sentinel: int):
    """Terminal-pair shortest-path metric from bridge edges.

    All inputs are flattened edge tables (Q, E) — the dense path passes the
    full N*K edge set, the compact path the C*K workset edge set; ``eid``
    carries *global* edge ids in both, so the per-pair argmin tie-break is
    backend independent.  Returns (w (Q,T,T) symmetric pair lengths with INF
    diagonal, best_eid (Q,T,T) global edge id realizing each pair).
    """
    q = d_src.shape[0]
    e_ok = (e_mask & (l_src < t) & (l_dst < t) & (l_src != l_dst)
            & (d_src < INF) & (d_dst < INF))
    plen = torch.where(e_ok, d_src + 1 + d_dst, INF)  # (Q, E)
    pair = torch.where(e_ok, l_src * t + l_dst, 0)  # (Q, E) in [0, T*T)
    w = _seg_min(plen, pair, t)  # (Q, T*T) pairwise path lengths
    # best bridge edge per pair: two-pass argmin (value then edge id)
    at_min = e_ok & (plen == _take(w, pair))
    best_eid = _seg_min(torch.where(at_min, eid, eid_sentinel), pair, t)
    w = w.reshape(q, t, t)
    w = torch.minimum(w, w.transpose(1, 2))  # symmetrize
    eye = torch.eye(t, dtype=torch.bool, device=w.device)[None]
    w = torch.where(eye, INF, w)
    best_eid = best_eid.reshape(q, t, t)
    best_eid = torch.minimum(best_eid, best_eid.transpose(1, 2))
    return w, best_eid


def _prim_mst(w: torch.Tensor, t: int) -> torch.Tensor:
    """Fixed-iteration Prim MST over the (Q, T, T) terminal metric.
    Returns (Q, max(T-1, 1), 2) edges, -1 where no edge was added."""
    q = w.shape[0]
    dev = w.device
    rows = torch.arange(q, device=dev)
    in_tree = torch.zeros((q, t), dtype=torch.bool, device=dev)
    in_tree[:, 0] = True
    edges = torch.full((q, max(t - 1, 1), 2), -1, dtype=torch.int32, device=dev)
    for step in range(max(t - 1, 0)):
        m = torch.where(in_tree[:, :, None] & ~in_tree[:, None, :], w, INF)
        flat = m.reshape(q, t * t)
        best = torch.argmin(flat, dim=1)  # first minimum, as jnp.argmin
        a, b = best // t, best % t
        ok = flat[rows, best] < INF
        bt = torch.where(ok, b, 0)
        in_tree[rows, bt] = in_tree[rows, bt] | ok
        edges[:, step, 0] = torch.where(ok, a, -1).to(torch.int32)
        edges[:, step, 1] = torch.where(ok, b, -1).to(torch.int32)
    return edges


def _descend_paths(marked, start, start_ok, dist, dp, row_fn, length: int):
    """Walk from ``start`` toward its terminal by strict dist descent,
    marking every visited position (``marked`` is updated in place and
    returned).  ``row_fn(cur)`` returns the (Q, K) neighbour positions +
    mask of each query's current node — global adjacency for the dense
    path, workset-local for the compact path."""
    rows = torch.arange(start.shape[0], device=start.device)
    cur, ok = start.long(), start_ok
    for _ in range(length):
        at = torch.where(ok, cur, 0)
        marked[rows, at] = marked[rows, at] | ok
        dcur = dist[rows, cur]
        nb, nbm = row_fn(cur)  # (Q, K) each
        want = nbm & (_take(dp, nb) == (dcur - 1)[:, None])
        pick = torch.argmax(want.to(torch.uint8), dim=1)  # first True
        nxt = nb[rows, pick].long()
        ok = ok & want.any(dim=1) & (dcur > 0)
        cur = torch.where(ok, nxt, cur)
    return marked


def _mark_mst_paths(marked, mst, best_eid, endpoints, dist, dp, row_fn, nk: int, k: int,
                    length: int):
    """Mark the bridge endpoints of every MST edge and the descents from
    them to their terminals.  ``endpoints(be_edge, slot, ok)`` maps the
    global edge id's row and slot to (u, u_ok, v, v_ok) start positions."""
    q = mst.shape[0]
    rows = torch.arange(q, device=mst.device)
    for e in range(mst.shape[1]):  # T is small (<= 16): one pass per MST edge
        a, b = mst[:, e, 0], mst[:, e, 1]
        be = best_eid[rows, torch.clamp(a, min=0).long(), torch.clamp(b, min=0).long()]
        ok = (a >= 0) & (be < nk)
        be = torch.where(ok, be, 0)
        u, u_ok, v, v_ok = endpoints(be // k, be % k, ok)
        marked = _descend_paths(marked, u, u_ok, dist, dp, row_fn, length)
        marked = _descend_paths(marked, v, v_ok, dist, dp, row_fn, length)
    return marked


def steiner_subgraph(nbr, nbr_mask, seeds: torch.Tensor, *, max_hops: int = 4,
                     max_nodes: int = 64) -> Subgraph:
    """RGL-Steiner: KMB/Mehlhorn 2-approx Steiner tree over the terminals.

    1. Voronoi BFS: dist-to-nearest-terminal + owning terminal per node.
    2. Bridge edges (u,v), label(u) != label(v) give candidate terminal-pair
       path lengths dist(u)+1+dist(v); segment-min over label pairs.
    3. Prim MST over the (T, T) terminal metric (fixed T-1 iterations).
    4. Mark MST-edge bridge endpoints; distance-descent backtrace marks the
       connecting shortest paths.  Tree nodes ranked closest-first.
    """
    n, k = nbr.shape
    q, t = seeds.shape
    dev = seeds.device
    dist, label = voronoi_bfs(nbr, nbr_mask, seeds, max_hops)

    # ---- bridge edges between Voronoi cells (edge u*K + slot) -------------
    dp = torch.cat([dist, dist.new_full((q, 1), INF)], 1)
    lp = torch.cat([label, label.new_full((q, 1), t)], 1)
    flat = nbr.reshape(-1).long()
    d_src = dist[:, :, None].expand(q, n, k).reshape(q, n * k)
    l_src = label[:, :, None].expand(q, n, k).reshape(q, n * k)
    eid = torch.arange(n * k, dtype=torch.int32, device=dev)[None].expand(q, n * k)
    w, best_eid = _terminal_metric(d_src, dp[:, flat], l_src, lp[:, flat],
                                   nbr_mask.reshape(1, -1), eid, t, n * k)
    mst = _prim_mst(w, t)

    # ---- mark tree nodes: terminals + bridge endpoints + backtraces --------
    def endpoints(u, slot, ok):
        v = nbr[u.long(), slot.long()]
        return u, ok, torch.clamp(v, max=n - 1), ok & (v < n)

    def row_fn(cur):
        return nbr[cur], nbr_mask[cur]

    marked = _mark_mst_paths(seeds_to_mask(seeds, n), mst, best_eid, endpoints, dist, dp,
                             row_fn, n * k, k, max_hops + 1)
    d = torch.clamp(dist, max=max_hops + 1)
    key = d * n + torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    nodes, mask, _ = _select_by_key(key, marked, max_nodes, n)
    dsel = torch.where(mask, _take(d, torch.clamp(nodes, max=n - 1)), INF).to(torch.int32)
    return Subgraph(nodes=nodes, mask=mask, dist=dsel, num_nodes=n)


def _workset_voronoi_labels(ws: Workset, wnbr, wmask, seeds: torch.Tensor, max_hops: int):
    """Voronoi owner labels over the workset.  ``ws.dist`` *is* the
    multi-source BFS distance from the terminal set, so only the label
    propagation re-runs: nodes at distance h inherit the minimum label among
    neighbours at distance h-1 — the dense path's tie-break exactly."""
    q, t = seeds.shape
    n = ws.num_nodes
    c = ws.ids.shape[1]
    dev = seeds.device
    valid_s = (seeds >= 0) & (seeds < n)
    pos, found = localize(ws.ids, torch.where(valid_s, seeds, n))
    ok = valid_s & found
    slot = torch.arange(t, dtype=torch.int32, device=dev)[None].expand(q, t)
    tgt = torch.where(ok, pos, c).long()  # slack column
    label = torch.full((q, c + 1), t, dtype=torch.int32, device=dev)
    label = label.scatter_reduce(1, tgt, torch.where(ok, slot, t), reduce="amin")[:, :c]
    g_d = _gather_local(ws.dist, wnbr, INF)
    for h in range(1, max_hops + 1):
        g_l = _gather_local(label, wnbr, t)
        best = torch.where(wmask & (g_d == h - 1), g_l, t).amin(dim=-1)
        label = torch.where(ws.dist == h, best, label)
    return label


def steiner_subgraph_compact(nbr, nbr_mask, seeds: torch.Tensor, *, max_hops: int = 4,
                             max_nodes: int = 64, workset_cap: int = 2048) -> Subgraph:
    """RGL-Steiner over the workset: the bridge scan walks C*K workset edges
    instead of N*K, Voronoi labels propagate over the local adjacency, and
    backtracing descends in workset coordinates."""
    n, k = nbr.shape
    q, t = seeds.shape
    dev = seeds.device
    ws = build_workset(nbr, nbr_mask, seeds, max_hops=max_hops, cap=workset_cap)
    c = ws.ids.shape[1]
    wnbr, wmask = workset_adjacency(nbr, nbr_mask, ws.ids)
    label = _workset_voronoi_labels(ws, wnbr, wmask, seeds, max_hops)

    # ---- bridge edges over the C*K workset edge table ---------------------
    dp = torch.cat([ws.dist, ws.dist.new_full((q, 1), INF)], 1)
    lp = torch.cat([label, label.new_full((q, 1), t)], 1)
    flat_nbr = wnbr.reshape(q, c * k)
    d_src = ws.dist[:, :, None].expand(q, c, k).reshape(q, c * k)
    l_src = label[:, :, None].expand(q, c, k).reshape(q, c * k)
    gid = torch.where(ws.ids < n, ws.ids, 0)
    eid = (gid[:, :, None] * k
           + torch.arange(k, dtype=torch.int32, device=dev)[None, None, :]).reshape(q, c * k)
    w, best_eid = _terminal_metric(d_src, _take(dp, flat_nbr), l_src, _take(lp, flat_nbr),
                                   wmask.reshape(q, c * k), eid, t, n * k)
    mst = _prim_mst(w, t)
    rows = torch.arange(q, device=dev)

    def endpoints(u_g, slot, ok):
        u_l, found_u = localize(ws.ids, u_g[:, None])
        ok = ok & found_u[:, 0]
        u_l = torch.clamp(u_l[:, 0], max=c - 1)
        v_l = wnbr[rows, u_l.long(), slot.long()]  # already in workset coordinates
        return u_l, ok, torch.clamp(v_l, max=c - 1), ok & (v_l < c)

    def row_fn(cur):
        return wnbr[rows, cur], wmask[rows, cur]

    marked = _mark_mst_paths((ws.ids < n) & (ws.dist == 0), mst, best_eid, endpoints,
                             ws.dist, dp, row_fn, n * k, k, max_hops + 1)
    d = torch.clamp(ws.dist, max=max_hops + 1)
    nodes, mask, topi = _select_ws(d * n + gid, marked, ws, max_nodes)
    dsel = torch.where(mask, _take(d, topi), INF).to(torch.int32)
    return Subgraph(nodes=nodes, mask=mask, dist=dsel, num_nodes=n, overflow=ws.overflow)


# ---------------------------------------------------------------- PPR --------


def _pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a fixed pairwise order (slot i + slot i+h,
    halving).  The order depends on the axis length only, so the sum is the
    same bits on the CPU and the card, and for the dense (Q, N, K) and
    compact (Q, C, K) tables."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = torch.cat([x[..., :h] + x[..., h:2 * h], x[..., 2 * h:]], -1)
    return x[..., 0]


def _ppr_rank(p: torch.Tensor) -> torch.Tensor:
    """Rank of each entry by score descending, ties by position (a stable
    sort of -p, as the reference's ``jnp.argsort(-p)``)."""
    q, m = p.shape
    order = torch.sort(-p, dim=1, stable=True).indices
    ar = torch.arange(m, dtype=torch.int32, device=p.device)[None].expand(q, m)
    return torch.empty((q, m), dtype=torch.int32, device=p.device).scatter_(1, order, ar)


def _ppr_power(s, deg, pull, alpha: float, n_iter: int):
    """Fixed-iteration power method p <- (1-a)·s + a · pull(p / deg)."""
    p = s
    for _ in range(n_iter):
        p = (1 - alpha) * s + alpha * pull(p / deg)
    return p


def ppr_scores(nbr, nbr_mask, seeds_mask: torch.Tensor, *, alpha: float = 0.85,
               n_iter: int = 10) -> torch.Tensor:
    """(Q, N) float32 PPR mass after ``n_iter`` pull iterations from the
    uniform distribution over each query's seeds."""
    q = seeds_mask.shape[0]
    s = seeds_mask.float()
    s = s / torch.clamp(s.sum(dim=1, keepdim=True), min=1.0)
    deg = torch.clamp(nbr_mask.sum(dim=1).float(), min=1.0)[None, :]  # (1, N)
    idx = nbr.long()

    def pull(contrib):
        cp = torch.cat([contrib, contrib.new_zeros((q, 1))], 1)
        return _pairwise_sum(torch.where(nbr_mask[None], cp[:, idx], 0.0))

    return _ppr_power(s, deg, pull, alpha, n_iter)


def ppr_subgraph(nbr, nbr_mask, seeds: torch.Tensor, *, alpha: float = 0.85, n_iter: int = 10,
                 max_nodes: int = 64, max_hops: Optional[int] = None) -> Subgraph:
    """Personalized-PageRank retrieval (paper's PPR baseline, batched).

    Fixed-iteration power method in pull form over the ELL adjacency:
      p <- (1-a)·s + a · sum_k p[nbr[v,k]] / deg[nbr[v,k]]
    Nodes ranked by PPR mass; ``dist`` carries the score rank.  ``max_hops``
    is accepted for strategy-API parity: PPR's reach is ``n_iter``.
    """
    n = nbr.shape[0]
    sm = seeds_to_mask(seeds, n)
    p = ppr_scores(nbr, nbr_mask, sm, alpha=alpha, n_iter=n_iter)
    rank = _ppr_rank(p)
    nodes, mask, _ = _select_by_key(rank, (p > 0) | sm, max_nodes, n)
    rsel = torch.where(mask, _take(rank, torch.clamp(nodes, max=n - 1)), INF).to(torch.int32)
    return Subgraph(nodes=nodes, mask=mask, dist=rsel, num_nodes=n)


def ppr_subgraph_compact(nbr, nbr_mask, seeds: torch.Tensor, *, alpha: float = 0.85,
                         n_iter: int = 10, max_nodes: int = 64, max_hops: Optional[int] = None,
                         workset_cap: int = 2048) -> Subgraph:
    """PPR over the workset.  After ``n_iter`` pull iterations mass reaches at
    most ``n_iter`` hops from the seeds, so the n_iter-hop workset carries the
    full support of p: with no overflow the power method over the local
    adjacency gives the dense scores bit for bit (same per-slot values, same
    summation order), and ranks of all positive-mass nodes coincide."""
    n, k = nbr.shape
    ws = build_workset(nbr, nbr_mask, seeds, max_hops=n_iter, cap=workset_cap)
    wnbr, wmask = workset_adjacency(nbr, nbr_mask, ws.ids)
    valid = ws.ids < n
    sm = valid & (ws.dist == 0)
    s = sm.float()
    s = s / torch.clamp(s.sum(dim=1, keepdim=True), min=1.0)
    safe = torch.clamp(ws.ids, max=n - 1).long()
    deg = torch.clamp(nbr_mask[safe].sum(dim=-1).float(), min=1.0)

    def pull(contrib):
        return _pairwise_sum(torch.where(wmask, _gather_local(contrib, wnbr, 0.0), 0.0))

    p = _ppr_power(s, deg, pull, alpha, n_iter)
    rank = _ppr_rank(p)  # stable: ties by position = by global id
    nodes, mask, topi = _select_ws(rank, ((p > 0) | sm) & valid, ws, max_nodes)
    rsel = torch.where(mask, _take(rank, topi), INF).to(torch.int32)
    return Subgraph(nodes=nodes, mask=mask, dist=rsel, num_nodes=n, overflow=ws.overflow)


# ---------------------------------------------------------------- dispatch ---

STRATEGIES = {
    "bfs": bfs_subgraph,
    "dense": dense_subgraph,
    "steiner": steiner_subgraph,
    "ppr": ppr_subgraph,
}

COMPACT_STRATEGIES = {
    "bfs": bfs_subgraph_compact,
    "dense": dense_subgraph_compact,
    "steiner": steiner_subgraph_compact,
    "ppr": ppr_subgraph_compact,
}


def retrieve_subgraph(
    g: ELLGraph,
    seeds,
    strategy: str = "bfs",
    *,
    mode: str = "auto",
    workset_cap: int = 2048,
    counters: Optional[dict] = None,
    **kw,
) -> Subgraph:
    """Strategy dispatch over an :class:`ELLGraph` (public entry point).

    ``mode`` selects the backend: ``"dense"`` (O(N) per hop, never
    truncates), ``"compact"`` (O(workset_cap) per hop, per-query
    ``overflow`` flags), or ``"auto"`` — compact for graphs with at least
    ``AUTO_COMPACT_MIN_NODES`` nodes (except ``ppr``, whose ``n_iter``-hop
    radius overflows any practical cap on large connected graphs — it stays
    dense under auto), with a dense re-run when any query overflows.  The
    overflow check is on the host (one device sync).

    ``counters`` (an ``RGLPipeline``'s) counts the batch, its rows, the
    compact pass and, under ``auto``, the overflowed queries and the dense
    re-run; ``compact`` mode reads no flag on the host, so it counts no
    overflow.
    """
    if mode not in ("dense", "compact", "auto"):
        raise ValueError(f"unknown retrieval mode: {mode!r}")
    seeds = torch.as_tensor(seeds, device=g.nbr.device).to(torch.int32)

    def count(key: str, n: int = 1) -> None:
        if counters is not None:
            counters[key] = counters.get(key, 0) + n

    count("batches")
    count("rows", int(seeds.shape[0]))
    use_compact = mode == "compact" or (
        mode == "auto"
        and strategy != "ppr"
        and g.num_nodes >= AUTO_COMPACT_MIN_NODES
        and workset_cap < g.num_nodes
    )
    if not use_compact:
        with span("rgl.retrieve.subgraph.dense"):
            return STRATEGIES[strategy](g.nbr, g.nbr_mask, seeds, **kw)
    cap = max(workset_cap, kw.get("max_nodes", 64), seeds.shape[1])
    with span("rgl.retrieve.subgraph.compact"):
        sub = COMPACT_STRATEGIES[strategy](g.nbr, g.nbr_mask, seeds, workset_cap=cap, **kw)
        overflowed = int(sub.overflow.sum()) if mode == "auto" else 0
    count("compact_runs")
    count("overflowed_queries", overflowed)
    if overflowed:
        count("dense_reruns")
        with span("rgl.retrieve.subgraph.rerun"):
            return STRATEGIES[strategy](g.nbr, g.nbr_mask, seeds, **kw)
    return sub


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
