"""NetworkX-class pure-Python baseline for graph retrieval.

Same complexity class as the paper's NetworkX baseline (adjacency-dict
traversal, one query at a time, interpreted).  Used both as the correctness
oracle for the batched retrieval (:mod:`repro_torch.core.graph_retrieval`,
over ``CSRGraph.to_adj_dict``) and as the slow side of the paper's Fig. 2/4
speedup comparison.  Host-only Python: it runs the same on any machine.
"""
from __future__ import annotations

import heapq
from collections import deque


def bfs_distances(adj: dict, seeds, max_hops: int) -> dict:
    dist = {s: 0 for s in seeds}
    dq = deque(seeds)
    while dq:
        u = dq.popleft()
        if dist[u] >= max_hops:
            continue
        for v in adj[u]:
            if v not in dist:
                dist[v] = dist[u] + 1
                dq.append(v)
    return dist


def bfs_subgraph(adj: dict, seeds, max_hops: int, max_nodes: int) -> list:
    """Closest-first ball; ties by node id (matches the batched kernel)."""
    dist = bfs_distances(adj, seeds, max_hops)
    order = sorted(dist.items(), key=lambda kv: (kv[1], kv[0]))
    return [u for u, _ in order[:max_nodes]]


def dense_subgraph(
    adj: dict, seeds, max_hops: int, max_nodes: int, n_rounds: int = 3
) -> list:
    """Greedy internal-degree peeling (mirror of the batched heuristic)."""
    cand = set(bfs_distances(adj, seeds, max_hops))
    dist = bfs_distances(adj, seeds, max_hops)
    seeds = set(seeds)
    for _ in range(n_rounds):
        deg = {u: sum(1 for v in adj[u] if v in cand) for u in cand}
        if len(cand) <= max_nodes:
            break
        kth = sorted(deg.values(), reverse=True)[min(max_nodes, len(deg)) - 1]
        cand = {u for u in cand if deg[u] >= kth} | seeds
    deg = {u: sum(1 for v in adj[u] if v in cand) for u in cand}
    order = sorted(cand, key=lambda u: (-deg[u], dist.get(u, 1 << 30), u))
    return order[:max_nodes]


def steiner_subgraph(adj: dict, terminals, max_hops: int, max_nodes: int) -> list:
    """KMB 2-approximation with BFS metric (unweighted graphs)."""
    terminals = [t for t in terminals if t >= 0]
    if not terminals:
        return []
    # Voronoi: nearest terminal (lowest slot wins ties), dist field
    dist, label = {}, {}
    dq = deque()
    for slot, s in enumerate(terminals):
        if s not in dist:
            dist[s], label[s] = 0, slot
            dq.append(s)
    frontier = list(dq)
    d = 0
    while frontier and d < max_hops:
        nxt = {}
        for u in frontier:
            for v in adj[u]:
                if v not in dist:
                    cand = label[u]
                    if v not in nxt or cand < nxt[v]:
                        nxt[v] = cand
        for v, lb in nxt.items():
            dist[v] = d + 1
            label[v] = lb
        frontier = list(nxt)
        d += 1
    # bridge edges -> terminal-pair metric
    t = len(terminals)
    w = {}
    bridge = {}
    for u in dist:
        for v in adj[u]:
            if v in dist and label[u] != label[v]:
                key = (min(label[u], label[v]), max(label[u], label[v]))
                plen = dist[u] + 1 + dist[v]
                eid = (u, v) if label[u] <= label[v] else (v, u)
                if key not in w or (plen, eid) < (w[key], bridge[key]):
                    w[key], bridge[key] = plen, eid
    # Prim MST over terminals
    in_tree = {0}
    mst = []
    while len(in_tree) < t:
        best = None
        for (a, b), pw in w.items():
            if (a in in_tree) != (b in in_tree):
                if best is None or pw < best[0]:
                    best = (pw, a, b)
        if best is None:
            break
        _, a, b = best
        in_tree.add(a if b in in_tree else b)
        mst.append((a, b))
    # mark terminals + backtraced paths
    marked = set(terminals)

    def descend(u):
        while dist[u] > 0:
            marked.add(u)
            nxts = [v for v in adj[u] if v in dist and dist[v] == dist[u] - 1]
            if not nxts:
                break
            u = min(nxts)
        marked.add(u)

    for a, b in mst:
        u, v = bridge[(min(a, b), max(a, b))]
        descend(u)
        descend(v)
    order = sorted(marked, key=lambda u: (dist.get(u, 1 << 30), u))
    return order[:max_nodes]


def knn_nodes(emb, query, k: int) -> list:
    """Per-query python kNN (the paper's kNN baseline, naive form)."""
    scores = []
    for i in range(len(emb)):
        s = sum(float(a) * float(b) for a, b in zip(emb[i], query))
        heapq.heappush(scores, (-s, i))
    return [heapq.heappop(scores)[1] for _ in range(k)]


def ppr_scores(adj: dict, seeds, alpha: float = 0.85, n_iter: int = 10) -> dict:
    """Per-query personalized PageRank, dict-based power iteration."""
    s0 = 1.0 / max(len(seeds), 1)
    p = {u: s0 for u in seeds}
    for _ in range(n_iter):
        nxt = {u: (1 - alpha) * s0 for u in seeds}
        for u, pu in p.items():
            if not adj[u]:
                continue
            share = alpha * pu / len(adj[u])
            for v in adj[u]:
                nxt[v] = nxt.get(v, 0.0) + share
        p = nxt
    return p


def ppr_subgraph(adj: dict, seeds, max_nodes: int, alpha: float = 0.85,
                 n_iter: int = 10) -> list:
    p = ppr_scores(adj, seeds, alpha, n_iter)
    order = sorted(p, key=lambda u: (-p[u], u))
    return order[:max_nodes]
