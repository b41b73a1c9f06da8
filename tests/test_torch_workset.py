"""Port workset backend vs the reference on the same graphs and seeds:
``build_workset`` (both hop arms), ``localize``, ``workset_adjacency``, all
four strategies in both backends (generous, tight and overflowing caps),
``auto``'s dense re-run and ``auto`` keeping PPR dense.

Ids, masks, dists and overflow flags are exact.  PPR scores: the port sums
each pull in a fixed pairwise order and XLA in its own, so scores are held
to ``PPR_ATOL`` (float32 sums of at most a few hundred terms, each <= 1) and
node ids exactly wherever neighbouring scores are further apart than that;
inside the port compact PPR equals dense PPR bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph_retrieval as ref_gr
from repro.core import workset as ref_ws
from repro.core.filters import dynamic_filter as ref_dynamic_filter
from repro.core.filters import similarity_scores as ref_similarity_scores
from repro.graph import CSRGraph as RefCSRGraph
from repro.graph import csr_to_ell as ref_csr_to_ell
from repro.graph import generators as ref_gen
from repro_torch.core import filters, graph_retrieval as gr, workset
from repro_torch.graph import generators
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.ell import csr_to_ell

PPR_ATOL = 1e-6
STRAT_KW = {
    "bfs": dict(max_hops=3, max_nodes=40),
    "dense": dict(max_hops=2, max_nodes=24),
    "steiner": dict(max_hops=4, max_nodes=64),
    "ppr": dict(max_nodes=40, n_iter=6),
}


@pytest.fixture(scope="module")
def graphs():
    g_ref = ref_gen.citation_graph(300, avg_deg=6, seed=7, with_text=False)
    g = generators.citation_graph(300, avg_deg=6, seed=7, with_text=False)
    return g, ref_csr_to_ell(g_ref), csr_to_ell(g, device="cpu")


def _seeds(n, q=6, s=4, seed=0):
    seeds = np.random.default_rng(seed).integers(0, n, size=(q, s)).astype(np.int32)
    seeds[0, -1] = -1  # padding
    return seeds


def _same(a, b, fields=("nodes", "mask", "dist")):
    for name in fields:
        np.testing.assert_array_equal(getattr(b, name).numpy(), np.asarray(getattr(a, name)),
                                      err_msg=name)


def _same_sub(a, b):
    _same(a, b)
    assert b.num_nodes == a.num_nodes
    if a.overflow is None:
        assert b.overflow is None
    else:
        np.testing.assert_array_equal(b.overflow.numpy(), np.asarray(a.overflow))


# ------------------------------------------------------------ the workset ----
@pytest.mark.parametrize("cap,hops", [(512, 3), (48, 3), (256, 2), (5, 1)])
def test_build_workset_matches(graphs, cap, hops):
    """Exact ball (generous cap) and deterministic truncation (tight cap),
    through both hop arms of the port."""
    g, er, e = graphs
    seeds = _seeds(g.num_nodes, seed=cap)
    want = ref_ws.build_workset(er.nbr, er.nbr_mask, jnp.asarray(seeds), max_hops=hops, cap=cap)
    for use_kernel in (False, True):
        got = workset.build_workset(e.nbr, e.nbr_mask, torch.from_numpy(seeds), max_hops=hops,
                                    cap=cap, use_kernel=use_kernel)
        _same(want, got, ("ids", "dist", "overflow"))
        assert got.num_nodes == want.num_nodes and got.cap == cap
    assert bool(np.asarray(want.overflow).any()) == (cap < 256)


def test_seed_workset_overflow():
    """More distinct seeds than slots: the extras go to the slack column."""
    seeds = np.array([[7, 3, 3, 9, -1, 12, 5], [2, 2, 2, 2, 2, 2, 2]], np.int32)
    want = ref_ws._seed_workset(jnp.asarray(seeds), 20, 3)
    got = workset._seed_workset(torch.from_numpy(seeds), 20, 3)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert got[2].tolist() == [True, False]


def test_localize_and_workset_adjacency_match(graphs):
    g, er, e = graphs
    seeds = _seeds(g.num_nodes, q=3, seed=4)
    ws_ref = ref_ws.build_workset(er.nbr, er.nbr_mask, jnp.asarray(seeds), max_hops=2, cap=256)
    ws = workset.build_workset(e.nbr, e.nbr_mask, torch.from_numpy(seeds), max_hops=2, cap=256)
    ids = np.random.default_rng(1).integers(-1, g.num_nodes + 2, (3, 50)).astype(np.int32)
    ids[:, :4] = np.asarray(ws_ref.ids)[:, :4]  # some present for sure
    for a, b in zip(ref_ws.localize(ws_ref.ids, jnp.asarray(ids)),
                    workset.localize(ws.ids, torch.from_numpy(ids))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(ref_ws.workset_adjacency(er.nbr, er.nbr_mask, ws_ref.ids),
                    workset.workset_adjacency(e.nbr, e.nbr_mask, ws.ids)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# ------------------------------------------------------------ strategies -----
def _both(er, e, seeds, strategy, mode, **kw):
    a = ref_gr.retrieve_subgraph(er, jnp.asarray(seeds), strategy, mode=mode, **kw)
    b = gr.retrieve_subgraph(e, torch.from_numpy(seeds), strategy, mode=mode, **kw)
    return a, b


@pytest.mark.parametrize("strategy", sorted(gr.STRATEGIES))
@pytest.mark.parametrize("mode,cap", [("dense", 2048), ("compact", 512), ("compact", 48)])
def test_strategy_matches_reference(graphs, strategy, mode, cap):
    """Every strategy in both backends; cap 48 overflows every query."""
    g, er, e = graphs
    seeds = _seeds(g.num_nodes)
    a, b = _both(er, e, seeds, strategy, mode, workset_cap=cap, **STRAT_KW[strategy])
    _same_sub(a, b)
    if mode == "compact":
        assert b.overflow.all() if cap == 48 else not b.overflow.any()


@pytest.mark.parametrize("strategy", sorted(gr.STRATEGIES))
def test_compact_equals_dense_tight_cap(graphs, strategy):
    """cap < n but >= every ball: the compact output is the dense output."""
    g, _, e = graphs
    seeds = torch.from_numpy(_seeds(g.num_nodes, q=4, seed=3))
    kw = dict(STRAT_KW[strategy])
    kw.update({"bfs": dict(max_hops=2), "steiner": dict(max_hops=2),
               "ppr": dict(n_iter=2)}.get(strategy, {}))
    comp = gr.COMPACT_STRATEGIES[strategy](e.nbr, e.nbr_mask, seeds, workset_cap=256, **kw)
    assert not comp.overflow.any(), "cap too tight for this test"
    _same(gr.STRATEGIES[strategy](e.nbr, e.nbr_mask, seeds, **kw), comp)


@pytest.mark.parametrize("trial", range(3))
def test_random_graphs_match_reference(trial):
    """Random (non-preferential-attachment) graphs, all strategies, both
    backends, through the dispatcher."""
    rng = np.random.default_rng(100 + trial)
    n = int(rng.integers(60, 200))
    src = rng.integers(0, n, size=n * 3)
    dst = rng.integers(0, n, size=n * 3)
    er = ref_csr_to_ell(RefCSRGraph.from_edges(src, dst, n, symmetrize=True))
    e = csr_to_ell(CSRGraph.from_edges(src, dst, n, symmetrize=True), device="cpu")
    np.testing.assert_array_equal(e.nbr.numpy(), np.asarray(er.nbr))
    seeds = rng.integers(0, n, size=(3, 3)).astype(np.int32)
    for strategy in sorted(gr.STRATEGIES):
        kw = dict(STRAT_KW[strategy], max_nodes=min(32, n))
        for mode in ("dense", "compact"):
            a, b = _both(er, e, seeds, strategy, mode, workset_cap=max(256, n), **kw)
            _same_sub(a, b)


def _ref_ppr_scores(er, seeds, alpha, n_iter):
    """The reference's power method (``repro.core.graph_retrieval.ppr_subgraph``
    lines, which return no scores), in jnp."""
    n = er.nbr.shape[0]
    sm = ref_gr.seeds_to_mask(jnp.asarray(seeds), n)
    s = sm.astype(jnp.float32)
    s = s / jnp.maximum(s.sum(axis=1, keepdims=True), 1.0)
    deg = jnp.maximum(er.nbr_mask.sum(axis=1).astype(jnp.float32), 1.0)
    p = s
    for _ in range(n_iter):
        cp = jnp.concatenate([p / deg[None, :], jnp.zeros((p.shape[0], 1))], axis=1)
        pulled = jnp.sum(jnp.where(er.nbr_mask[None], cp[:, er.nbr], 0.0), axis=-1)
        p = (1 - alpha) * s + alpha * pulled
    return np.asarray(p)


@pytest.mark.parametrize("n_iter,alpha", [(6, 0.85), (10, 0.5)])
def test_ppr_scores_within_tolerance_and_ids_where_separated(graphs, n_iter, alpha):
    g, er, e = graphs
    seeds = _seeds(g.num_nodes, seed=n_iter)
    p_ref = _ref_ppr_scores(er, seeds, alpha, n_iter)
    t_seeds = torch.from_numpy(seeds)
    p = gr.ppr_scores(e.nbr, e.nbr_mask, gr.seeds_to_mask(t_seeds, g.num_nodes), alpha=alpha,
                      n_iter=n_iter).numpy()
    np.testing.assert_allclose(p, p_ref, rtol=0, atol=PPR_ATOL)
    a = ref_gr.ppr_subgraph(er.nbr, er.nbr_mask, jnp.asarray(seeds), alpha=alpha, n_iter=n_iter,
                            max_nodes=40)
    b = gr.ppr_subgraph(e.nbr, e.nbr_mask, t_seeds, alpha=alpha, n_iter=n_iter, max_nodes=40)
    np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))
    picked = np.take_along_axis(p, np.minimum(b.nodes.numpy(), g.num_nodes - 1), 1)
    gap = np.abs(np.diff(picked, axis=1))
    clear = np.ones_like(picked, bool)  # a node whose score is clear of both neighbours
    clear[:, 1:] &= gap > PPR_ATOL
    clear[:, :-1] &= gap > PPR_ATOL
    clear &= b.mask.numpy()
    assert clear.sum() > picked.shape[0]  # the check is not vacuous
    np.testing.assert_array_equal(b.nodes.numpy()[clear], np.asarray(a.nodes)[clear])
    # inside the port: compact PPR is the dense computation, bit for bit
    c = gr.ppr_subgraph_compact(e.nbr, e.nbr_mask, t_seeds, alpha=alpha, n_iter=n_iter,
                                max_nodes=40, workset_cap=512)
    assert not c.overflow.any()
    _same(b, c)


# --------------------------------------------------------------- auto --------
def test_auto_runs_compact_then_dense_on_overflow(graphs, monkeypatch):
    """auto at or above the size threshold: compact when nothing overflows,
    the flagless dense re-run when any query does — as the reference."""
    g, er, e = graphs
    monkeypatch.setattr(ref_gr, "AUTO_COMPACT_MIN_NODES", 1)
    monkeypatch.setattr(gr, "AUTO_COMPACT_MIN_NODES", 1)
    seeds = _seeds(g.num_nodes, q=4, seed=2)
    for strategy in ("bfs", "dense", "steiner"):
        kw = dict(STRAT_KW[strategy], max_hops=2)
        a, b = _both(er, e, seeds, strategy, "auto", workset_cap=256, **kw)
        _same_sub(a, b)
        assert b.overflow is not None and not b.overflow.any()  # compact ran
        a, b = _both(er, e, seeds, strategy, "auto", workset_cap=48, **kw)
        _same_sub(a, b)
        assert b.overflow is None  # the dense re-run came back
        _same(gr.retrieve_subgraph(e, torch.from_numpy(seeds), strategy, mode="dense", **kw), b)


def test_auto_keeps_ppr_dense(graphs, monkeypatch):
    g, er, e = graphs
    monkeypatch.setattr(ref_gr, "AUTO_COMPACT_MIN_NODES", 1)
    monkeypatch.setattr(gr, "AUTO_COMPACT_MIN_NODES", 1)
    seeds = _seeds(g.num_nodes, q=3, seed=6)
    a, b = _both(er, e, seeds, "ppr", "auto", workset_cap=48, max_nodes=16)
    _same_sub(a, b)
    assert b.overflow is None


def test_filter_preserves_overflow_flags(graphs):
    g, er, e = graphs
    seeds = _seeds(g.num_nodes, q=4, seed=2)
    a, b = _both(er, e, seeds, "bfs", "compact", workset_cap=48, max_hops=3, max_nodes=32)
    q = g.node_feat[np.maximum(seeds[:, 0], 0)]
    fa = ref_dynamic_filter(a, ref_similarity_scores(jnp.asarray(g.node_feat), jnp.asarray(q)),
                            jnp.asarray(seeds), budget=8)
    fb = filters.dynamic_filter(b, filters.similarity_scores(torch.from_numpy(g.node_feat),
                                                             torch.from_numpy(q)),
                                torch.from_numpy(seeds), budget=8)
    _same_sub(fa, fb)
    assert fb.overflow is b.overflow and fb.overflow.any()
