"""The port's pure-Python retrieval baselines (``repro_torch.core.naive``)
against the reference's, and the port's batched retrieval on the CPU against
its own naive copy, as the reference's tests hold theirs.

The copy's outputs equal the reference's exactly (lists and dicts; PPR
scores within 1e-12).  The batched retrieval (``core/graph_retrieval.py``
over ``csr_to_ell`` and ``CSRGraph.to_adj_dict``) equals the naive
baseline where the reference's tests require it: BFS subgraphs and hop
distances exactly (both backends), the compact workset's ball and its
overflow truncation exactly, PPR's top-12 set; Steiner and dense by their
properties (terminals kept and connected, size within 2x + 4 of the naive
tree, density no worse than BFS).
"""
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro.core import naive as ref_naive
from repro.graph import generators as ref_gen
from repro_torch.core import graph_retrieval as gr
from repro_torch.core import naive
from repro_torch.core.workset import build_workset
from repro_torch.graph import generators
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.ell import csr_to_ell


@pytest.fixture(scope="module")
def graph():
    g = generators.citation_graph(300, avg_deg=6, seed=7)
    return g, csr_to_ell(g, device="cpu"), g.to_adj_dict()


@pytest.fixture(scope="module")
def ref_adj():
    return ref_gen.citation_graph(300, avg_deg=6, seed=7).to_adj_dict()


def _seeds(n, q=6, s=4, seed=0):
    return np.random.default_rng(seed).integers(0, n, size=(q, s)).astype(np.int32)


def _members(sub, qi):
    return [int(v) for v, m in zip(sub.nodes[qi].tolist(), sub.mask[qi].tolist()) if m]


# ------------------------------------------------------- copy vs reference ---
def test_adj_dict_equals_reference(graph, ref_adj):
    assert graph[2] == ref_adj


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_naive_equals_reference(graph, ref_adj, seed):
    """Every baseline on the same seeded queries: equal lists and dicts."""
    g, _, adj = graph
    for qi, row in enumerate(_seeds(g.num_nodes, q=5, s=4, seed=seed)):
        s = sorted(set(row.tolist()))
        for hops in (1, 3):
            assert naive.bfs_distances(adj, s, hops) == ref_naive.bfs_distances(ref_adj, s, hops)
            assert naive.bfs_subgraph(adj, s, hops, 40) == \
                ref_naive.bfs_subgraph(ref_adj, s, hops, 40)
        assert naive.dense_subgraph(adj, s, 2, 24) == ref_naive.dense_subgraph(ref_adj, s, 2, 24)
        assert naive.dense_subgraph(adj, s, 2, 8, n_rounds=1) == \
            ref_naive.dense_subgraph(ref_adj, s, 2, 8, n_rounds=1)
        terminals = row.tolist() + [-1]  # padding is dropped
        assert naive.steiner_subgraph(adj, terminals, 4, 64) == \
            ref_naive.steiner_subgraph(ref_adj, terminals, 4, 64)
        a = naive.ppr_scores(adj, s, n_iter=8)
        b = ref_naive.ppr_scores(ref_adj, s, n_iter=8)
        assert sorted(a) == sorted(b)
        assert max(abs(a[u] - b[u]) for u in a) <= 1e-12
        assert naive.ppr_subgraph(adj, s, 24, n_iter=8) == \
            ref_naive.ppr_subgraph(ref_adj, s, 24, n_iter=8)
    assert naive.steiner_subgraph(adj, [-1, -1], 4, 64) == [] == \
        ref_naive.steiner_subgraph(ref_adj, [-1, -1], 4, 64)
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((50, 8)).astype(np.float32)
    q = rng.standard_normal(8).astype(np.float32)
    assert naive.knn_nodes(emb, q, 5) == ref_naive.knn_nodes(emb, q, 5)


# -------------------------------------------- batched retrieval vs naive ---
@pytest.mark.parametrize("mode", ["dense", "compact"])
def test_bfs_matches_naive(graph, mode):
    g, ell, adj = graph
    seeds = _seeds(g.num_nodes)
    sub = gr.retrieve_subgraph(ell, seeds, "bfs", mode=mode, workset_cap=512, max_hops=3,
                               max_nodes=40)
    for qi in range(len(seeds)):
        assert _members(sub, qi) == naive.bfs_subgraph(adj, sorted(set(seeds[qi].tolist())), 3, 40)


def test_bfs_distances_match_naive(graph):
    g, ell, adj = graph
    seeds = _seeds(g.num_nodes, q=4)
    sm = gr.seeds_to_mask(torch.from_numpy(seeds), g.num_nodes)
    dist = gr.bfs_distances(ell.nbr, ell.nbr_mask, sm, 4).numpy()
    for qi in range(4):
        ref = naive.bfs_distances(adj, sorted(set(seeds[qi].tolist())), 4)
        want = np.array([ref.get(v, gr.INF) for v in range(g.num_nodes)])
        np.testing.assert_array_equal(dist[qi], want)


def _connected_within(nodes: set, adj: dict) -> set:
    start = next(iter(nodes))
    seen, frontier = {start}, [start]
    while frontier:
        nxt = []
        for u in frontier:
            for w in adj[u]:
                if w in nodes and w not in seen:
                    seen.add(w)
                    nxt.append(w)
        frontier = nxt
    return seen


@pytest.mark.parametrize("mode", ["dense", "compact"])
def test_steiner_contains_terminals_and_is_connected(graph, mode):
    g, ell, adj = graph
    seeds = _seeds(g.num_nodes, q=5, s=5, seed=3)
    sub = gr.retrieve_subgraph(ell, seeds, "steiner", mode=mode, workset_cap=512, max_hops=4,
                               max_nodes=64)
    for qi in range(5):
        got = set(_members(sub, qi))
        terminals = set(seeds[qi].tolist())
        assert terminals <= got
        ref = naive.steiner_subgraph(adj, sorted(terminals), 4, 64)
        if set(ref) >= terminals:  # the naive tree connected them
            assert terminals <= _connected_within(got, adj)


def test_steiner_size_close_to_naive(graph):
    g, ell, adj = graph
    seeds = _seeds(g.num_nodes, q=8, s=4, seed=11)
    sub = gr.retrieve_subgraph(ell, seeds, "steiner", max_hops=4, max_nodes=64)
    for qi in range(8):
        ref = naive.steiner_subgraph(adj, sorted(set(seeds[qi].tolist())), 4, 64)
        assert int(sub.mask[qi].sum()) <= 2 * len(ref) + 4  # both 2-approximations


def test_dense_subgraph_keeps_seeds_and_density(graph):
    g, ell, adj = graph
    seeds = _seeds(g.num_nodes, q=4, s=3, seed=5)
    sub = gr.retrieve_subgraph(ell, seeds, "dense", max_hops=2, max_nodes=24)
    bfs = gr.retrieve_subgraph(ell, seeds, "bfs", max_hops=2, max_nodes=24)

    def internal_edges(nodes):
        s = set(nodes)
        return sum(1 for u in s for w in adj[u] if w in s)

    for qi in range(4):
        got = _members(sub, qi)
        assert set(seeds[qi].tolist()) <= set(got)
        assert internal_edges(got) >= internal_edges(_members(bfs, qi)) - 2


def test_ppr_matches_naive_top_set():
    g = generators.citation_graph(250, avg_deg=6, seed=11)
    ell, adj = csr_to_ell(g, device="cpu"), g.to_adj_dict()
    seeds = np.asarray([[3, 40], [99, 7]], np.int32)
    sub = gr.retrieve_subgraph(ell, seeds, "ppr", max_nodes=24, n_iter=8)
    for qi in range(2):
        ref = naive.ppr_subgraph(adj, sorted(set(seeds[qi].tolist())), 24, n_iter=8)
        # same top set (order may differ at float ties)
        assert set(_members(sub, qi)[:12]) == set(ref[:12])


def test_workset_is_exact_ball_without_overflow(graph):
    g, ell, adj = graph
    seeds = torch.from_numpy(_seeds(g.num_nodes, q=4, seed=5))
    ws = build_workset(ell.nbr, ell.nbr_mask, seeds, max_hops=3, cap=512)
    assert not ws.overflow.any()
    ids, dist = ws.ids.numpy(), ws.dist.numpy()
    for qi in range(4):
        ball = naive.bfs_distances(adj, sorted(set(seeds[qi].tolist())), 3)
        real = ids[qi][ids[qi] < g.num_nodes]
        assert (np.diff(real) > 0).all()  # sorted, unique
        assert set(real.tolist()) == set(ball)
        for v, dv in zip(ids[qi], dist[qi]):
            if v < g.num_nodes:
                assert ball[int(v)] == int(dv)


def test_workset_overflow_truncation_is_deterministic(graph):
    """A truncated workset is the first ``cap`` of the ball by (dist, id),
    with the flag set."""
    g, ell, adj = graph
    seeds = torch.from_numpy(_seeds(g.num_nodes, q=4, seed=9))
    cap = 48
    ws = build_workset(ell.nbr, ell.nbr_mask, seeds, max_hops=3, cap=cap)
    ws2 = build_workset(ell.nbr, ell.nbr_mask, seeds, max_hops=3, cap=cap)
    assert torch.equal(ws.ids, ws2.ids) and torch.equal(ws.dist, ws2.dist)
    for qi in range(4):
        ball = naive.bfs_distances(adj, sorted(set(seeds[qi].tolist())), 3)
        assert bool(ws.overflow[qi]) == (len(ball) > cap)
        want = sorted(ball.items(), key=lambda kv: (kv[1], kv[0]))[:cap]
        got = sorted((int(v), int(dv)) for v, dv in zip(ws.ids[qi].tolist(), ws.dist[qi].tolist())
                     if v < g.num_nodes)
        assert got == sorted(want)


@settings(max_examples=15, deadline=None)
@given(n=st.integers(20, 120), deg=st.integers(1, 5), hops=st.integers(1, 4),
       seed=st.integers(0, 1000))
def test_bfs_property_vs_naive(n, deg, hops, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=n * deg)
    dst = rng.integers(0, n, size=n * deg)
    g = CSRGraph.from_edges(src, dst, n, symmetrize=True)
    ell, adj = csr_to_ell(g, device="cpu"), g.to_adj_dict()
    seeds = rng.integers(0, n, size=(2, 2)).astype(np.int32)
    m = min(16, n)
    sub = gr.retrieve_subgraph(ell, seeds, "bfs", max_hops=hops, max_nodes=m)
    for qi in range(2):
        assert _members(sub, qi) == naive.bfs_subgraph(adj, sorted(set(seeds[qi].tolist())),
                                                       hops, m)
