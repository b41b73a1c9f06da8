"""Plain NumPy reference of the RGL retrieval path, and the comparison.

Stages, as the configuration states them:

1. seeds: the ``k_seeds`` nodes whose L2-normalized embedding (norm plus
   1e-6 in the denominator) has the largest dot product with the
   normalized query, ties to the lower id;
2. subgraph (``bfs``): every node within ``max_hops`` hops of a seed over
   the symmetric CSR graph, ordered by (hop distance, id), the first
   ``max_nodes`` of them;
3. filter: the seeds first (in subgraph order), then the other members by
   cosine relevance to the query (same normalization), highest first, ties
   by subgraph position, ``filter_budget`` nodes in all.

Scores are float64 here.  The program scores in float32, so two nodes
whose scores lie within ``NEAR_TIE`` of each other may come out in either
order: a difference of that kind is a near-tie, not an error.  Every other
difference counts as a mismatch.
"""
from __future__ import annotations

import numpy as np

NEAR_TIE = 1e-4  # float32 scores of unit vectors err by ~1e-6; bfloat16 by ~4e-3
INF = np.iinfo(np.int32).max


def normalize(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    return x / (np.sqrt(np.sum(x * x, axis=-1, keepdims=True)) + 1e-6)


def scores(emb_n: np.ndarray, query: np.ndarray, dtype=np.float64) -> np.ndarray:
    """Cosine relevance of every node to one query, in ``dtype``."""
    q = normalize(query[None])[0]
    if dtype == np.float64:
        return emb_n @ q
    import torch  # bfloat16 for the control: NumPy has no such type

    e = torch.from_numpy(emb_n).to(torch.bfloat16)
    return (e @ torch.from_numpy(q).to(torch.bfloat16)).double().numpy()


def top_ids(s: np.ndarray, k: int) -> np.ndarray:
    """The k largest, ties to the lower id."""
    return np.lexsort((np.arange(s.shape[0]), -s))[:k]


def bfs_candidates(indptr, indices, seeds, max_hops: int, max_nodes: int):
    """(ids ordered by (distance, id), their distances)."""
    n = indptr.shape[0] - 1
    dist = np.full(n, INF, np.int64)
    frontier = np.unique(np.asarray(seeds, np.int64))
    dist[frontier] = 0
    for h in range(1, max_hops + 1):
        starts, ends = indptr[frontier], indptr[frontier + 1]
        lens = ends - starts
        if lens.sum() == 0:
            break
        offs = np.repeat(starts - np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
        nb = indices[np.arange(lens.sum()) + offs]
        nb = np.unique(nb[dist[nb] == INF])
        dist[nb] = h
        frontier = nb
    reached = np.flatnonzero(dist < INF)
    order = np.lexsort((reached, dist[reached]))[:max_nodes]
    return reached[order], dist[reached[order]]


def filtered(cand: np.ndarray, seeds, s: np.ndarray, budget: int) -> np.ndarray:
    is_seed = np.isin(cand, np.asarray(seeds))
    key = np.where(is_seed, np.inf, s[cand])
    order = np.lexsort((np.arange(cand.shape[0]), -key))[:budget]
    return cand[order]


def retrieve(emb_n, indptr, indices, query, rc: dict, dtype=np.float64) -> dict:
    """The reference's seeds and filtered nodes for one query."""
    s = scores(emb_n, query, dtype)
    seeds = top_ids(s, rc["k_seeds"])
    cand, _ = bfs_candidates(indptr, indices, seeds, rc["max_hops"], rc["max_nodes"])
    return {"seeds": seeds, "nodes": filtered(cand, seeds, s, rc["filter_budget"]), "scores": s}


def compare(emb_n, indptr, indices, query, rc: dict, got_nodes, got_seeds=None) -> dict:
    """Judge one query's program output (filtered nodes in order, and the
    seeds where the program hands them out).  Returns ``mismatch`` (bool)
    and ``tie_gap``: the widest score gap accepted as a near-tie."""
    ref = retrieve(emb_n, indptr, indices, query, rc)
    s = ref["scores"]
    got_nodes = np.asarray(got_nodes, np.int64)
    tie = 0.0
    seeds = ref["seeds"]
    if got_seeds is not None:
        got_seeds = np.asarray(got_seeds, np.int64)
        if got_seeds.shape != seeds.shape or np.any((got_seeds < 0) | (got_seeds >= s.shape[0])):
            return {"mismatch": True, "tie_gap": tie, "why": "seed shape or range"}
        if not np.array_equal(got_seeds, seeds):
            gap = float(np.max(np.abs(s[got_seeds] - s[seeds])))
            if gap > NEAR_TIE or np.unique(got_seeds).shape != got_seeds.shape:
                return {"mismatch": True, "tie_gap": tie, "why": f"seeds differ by {gap:.3g}"}
            tie, seeds = max(tie, gap), got_seeds
    else:
        # the seeds lead the filtered list (they score +inf), in id order
        k = rc["k_seeds"]
        lead = got_nodes[:k]
        if not np.array_equal(np.sort(lead), np.sort(seeds)):
            if lead.shape != seeds.shape or np.any((lead < 0) | (lead >= s.shape[0])):
                return {"mismatch": True, "tie_gap": tie, "why": "seed shape or range"}
            gap = float(np.max(np.abs(np.sort(s[lead]) - np.sort(s[seeds]))))
            if gap > NEAR_TIE:
                return {"mismatch": True, "tie_gap": tie, "why": f"seeds differ by {gap:.3g}"}
            tie, seeds = max(tie, gap), lead
    cand, _ = bfs_candidates(indptr, indices, seeds, rc["max_hops"], rc["max_nodes"])
    want = filtered(cand, seeds, s, rc["filter_budget"])
    if got_nodes.shape != want.shape or not np.all(np.isin(got_nodes, cand)):
        return {"mismatch": True, "tie_gap": tie, "why": "filtered nodes outside the subgraph"}
    n_seed = int(np.isin(want, seeds).sum())
    if not np.array_equal(got_nodes[:n_seed], want[:n_seed]):
        return {"mismatch": True, "tie_gap": tie, "why": "seed order"}
    if not np.array_equal(got_nodes, want):
        if np.unique(got_nodes).shape != got_nodes.shape:
            return {"mismatch": True, "tie_gap": tie, "why": "repeated node"}
        gap = float(np.max(np.abs(s[got_nodes[n_seed:]] - s[want[n_seed:]])))
        if gap > NEAR_TIE:
            return {"mismatch": True, "tie_gap": tie, "why": f"filter differs by {gap:.3g}"}
        tie = max(tie, gap)
    return {"mismatch": False, "tie_gap": tie, "why": ""}
