"""Port online mutation against the reference, case for case with
``tests/test_mutation.py``: ``DeltaGraph`` under one seeded op sequence,
``assign_to_centroids``, ``build_inverted_lists_slack`` and both mutable
indexes on the reference's arrays, ``MutableGraphStore`` (brute, and IVF on
the reference's quantizer) batch for batch through slack overflow, capacity
overflow and mid-apply compactions, compaction against a from-scratch
build, the two regressions the reference fixed, the cache's versioned
invalidation, seeded mutating serves of ``RAGServeEngine`` over both arenas
and both schedules, the engine and launcher knobs, and pipeline copies.

Integers are exact: node ids, masks, mirrors, lists, counts, reports,
tokens, cache and mutation counters.  Float embeddings and scores are held
within 1e-6 (the two frameworks normalize and multiply in their own order).
"""
import argparse
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.graph.delta as ref_delta
from _serving_twins import MODEL, Clock, Side, _Forced, same_outcomes, same_stats, ticking
from repro.core import indexing as ref_ix
from repro.graph import csr_to_ell as ref_csr_to_ell
from repro.graph import generators as ref_gen
from repro.launch import serve as ref_serve
from repro.models.transformer import TransformerConfig as RefConfig
from repro.models.transformer import model as ref_tm
from repro.serving import CachedRetrieval as RefEntry
from repro.serving import RetrievalCache as RefCache
from repro_torch.core import indexing as ix
from repro_torch.core.mutation import MutableGraphStore, MutationBatch
from repro_torch.core.pipeline import PipelineConfig, RGLPipeline
from repro_torch.core.tokenization import GraphTokenizer, Vocab
from repro_torch.graph import generators
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.delta import CapacityOverflow, DeltaGraph, SlackOverflow
from repro_torch.graph.ell import csr_to_ell
from repro_torch.launch import serve
from repro_torch.models.transformer import model as tm
from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.serving import CachedRetrieval, RetrievalCache, ServingConfig
from repro_torch.serving import prefetch as port_prefetch

N = 80
D = 16
ATOL = 1e-6


def _graphs(seed, n=N):
    return (ref_gen.citation_graph(n, avg_deg=5, d_feat=D, seed=seed),
            generators.citation_graph(n, avg_deg=5, d_feat=D, seed=seed))


def _outcome(fn):
    """``fn()``'s value, or the name and message of what it raised."""
    try:
        return ("ok", fn())
    except (ValueError, RuntimeError) as exc:
        return (type(exc).__name__, str(exc))


# ------------------------------------------------------------- DeltaGraph ----
MIRRORS = ("h_base_nbr", "h_base_mask", "h_kill", "h_extra", "h_extra_cnt", "tomb")


def _same_delta(ref, port):
    assert (port.n_nodes, port.capacity, port.extra_deg, port.base_deg) == \
        (ref.n_nodes, ref.capacity, ref.extra_deg, ref.base_deg)
    for name in MIRRORS:
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name), err_msg=name)
    nbr_h, mask_h = port.merged_host()
    ref_nbr_h, ref_mask_h = ref.merged_host()
    np.testing.assert_array_equal(nbr_h, ref_nbr_h)
    np.testing.assert_array_equal(mask_h, ref_mask_h)
    m, rm = port.merged(), ref.merged()
    assert m.num_nodes == rm.num_nodes == port.capacity
    np.testing.assert_array_equal(m.nbr.numpy(), np.asarray(rm.nbr))
    np.testing.assert_array_equal(m.nbr_mask.numpy(), np.asarray(rm.nbr_mask))
    np.testing.assert_array_equal(m.nbr.numpy(), nbr_h)
    src, dst = port.live_edge_list()
    rsrc, rdst = ref.live_edge_list()
    np.testing.assert_array_equal(src, rsrc)
    np.testing.assert_array_equal(dst, rdst)


@pytest.mark.parametrize("seed,extra_deg,headroom", [(3, 4, 10), (5, 1, 3), (8, 2, 0)])
def test_delta_graph_matches_reference_under_one_op_sequence(seed, extra_deg, headroom):
    """One seeded sequence of adds, deletes, node adds past the capacity,
    node deletes and ops on tombstoned or unknown ids, on both sides: the
    same return values and exceptions, then equal mirrors, merged views
    (device fold and host oracle) and live edge lists after every op."""
    g_ref, _ = _graphs(seed)
    ell = ref_csr_to_ell(g_ref)
    nbr, mask = np.asarray(ell.nbr), np.asarray(ell.nbr_mask)
    cap = N + headroom
    ref = ref_delta.DeltaGraph(nbr, mask, N, cap, extra_deg=extra_deg)
    port = DeltaGraph(nbr, mask, N, cap, extra_deg=extra_deg, device="cpu")
    _same_delta(ref, port)
    r = np.random.default_rng(seed + 100)
    names = set()
    for step in range(140):
        op = r.random()
        n = ref.n_nodes
        live = np.flatnonzero(~ref.tomb[:n])
        u, v = int(r.choice(live)), int(r.choice(live))
        if r.random() < 0.05:  # a tombstoned or unknown endpoint
            v = int(r.choice(np.flatnonzero(ref.tomb[:n]))) if ref.tomb[:n].any() else n + 3
        if op < 0.35:
            calls = (lambda d: d.add_edge(u, v))
        elif op < 0.45:  # re-add a base edge after deleting it (resurrects the slot)
            w = int(nbr[u % N][0])
            calls = (lambda d: (d.del_edge(u % N, w), d.add_edge(u % N, w)))
        elif op < 0.7:
            calls = (lambda d: d.del_edge(u, v))
        elif op < 0.85:
            calls = (lambda d: d.add_node())
        elif live.size > 4:
            calls = (lambda d: d.del_node(u))
        else:
            continue
        got, want = _outcome(lambda: calls(port)), _outcome(lambda: calls(ref))
        assert got == want, (step, got, want)
        names.add(got[0])
        _same_delta(ref, port)
        if step % 20 == 0:
            np.testing.assert_array_equal(port.neighbors_live(u), ref.neighbors_live(u))
    assert "ok" in names and "ValueError" in names


def test_delta_edge_semantics_and_exceptions():
    """The reference's edge semantics case on the port: dedup, idempotent
    delete, re-add, slack overflow, capacity overflow, tombstoned ids."""
    base_nbr = np.zeros((2, 1), np.int32)
    base_mask = np.zeros((2, 1), bool)
    d = DeltaGraph(base_nbr, base_mask, 2, 4, extra_deg=2, device="cpu")
    assert d.add_edge(0, 1) and not d.add_edge(0, 1)
    assert d.del_edge(0, 1) and not d.del_edge(0, 1)
    assert d.add_edge(0, 1)
    u = d.add_node()
    assert u == 2
    assert d.add_edge(0, u)
    with pytest.raises(SlackOverflow):
        d.add_edge(0, 3 if d.add_node() == 3 else 0)
    with pytest.raises(CapacityOverflow):
        d.add_node()
    d.del_node(1)
    assert 1 not in d.neighbors_live(0)
    with pytest.raises(ValueError, match="tombstoned"):
        d.add_edge(0, 1)
    with pytest.raises(ValueError, match="out of range"):
        d.del_edge(7, 0)


def test_fold_returns_fresh_tensors_and_keeps_old_snapshots():
    """Every fold allocates new tensors: a snapshot taken before a mutation
    keeps its values after it; an unchanged graph reuses its cached fold."""
    _, g = _graphs(2)
    nbr, mask = (t.numpy() for t in (lambda e: (e.nbr, e.nbr_mask))(csr_to_ell(g, device="cpu")))
    d = DeltaGraph(nbr, mask, N, N + 4, extra_deg=2, device="cpu")
    m0 = d.merged()
    assert d.merged() is m0
    before = (m0.nbr.clone(), m0.nbr_mask.clone())
    d.add_edge(0, 5)
    d.del_node(int(nbr[0][0]))
    m1 = d.merged()
    assert m1.nbr.data_ptr() != m0.nbr.data_ptr()
    assert torch.equal(m0.nbr, before[0]) and torch.equal(m0.nbr_mask, before[1])
    assert not torch.equal(m1.nbr_mask, m0.nbr_mask)


# ----------------------------------------------------------- mutable tier ----
def test_assign_to_centroids_and_slack_lists_match_reference():
    """The same normalized rows and centroids (duplicate centroids: ties to
    the lower one) give the same assignment; the slack lists of it match."""
    rng = np.random.default_rng(4)
    embn = np.array(ref_ix.l2_normalize(jnp.asarray(rng.normal(size=(300, D)).astype(np.float32))))
    cent = embn[rng.choice(300, 12, replace=False)].copy()
    cent[7] = cent[3]  # a tie: argmin takes the lower index
    want = np.asarray(ref_ix.assign_to_centroids(jnp.asarray(embn), jnp.asarray(cent)))
    got = ix.assign_to_centroids(torch.from_numpy(embn), torch.from_numpy(cent)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not (got == 7).any()
    ids = np.sort(rng.choice(400, 300, replace=False)).astype(np.int32)
    for slack in (0, 3, 8):
        lists, counts = ix.build_inverted_lists_slack(got, ids, 400, 12, slack)
        rl, rc = ref_ix.build_inverted_lists_slack(want, ids, 400, 12, slack)
        np.testing.assert_array_equal(lists, rl)
        np.testing.assert_array_equal(counts, rc)
    lists, counts = ix.build_inverted_lists_slack(np.zeros(0, np.int64), np.zeros(0, np.int32),
                                                  50, 4, 3)
    rl, rc = ref_ix.build_inverted_lists_slack(np.zeros(0, np.int64), np.zeros(0, np.int32),
                                               50, 4, 3)
    np.testing.assert_array_equal(lists, rl)
    np.testing.assert_array_equal(counts, rc)


def _close_scores(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=ATOL, rtol=0)


@pytest.mark.parametrize("k", [3, 40])
def test_mutable_brute_search_matches_reference(k):
    """Capacity-padded rows with dead rows masked to -inf: ids exact, lowest
    id first among ties (duplicate rows; at k = 40 past the 30 live rows the
    -inf tail too), scores within 1e-6."""
    rng = np.random.default_rng(k)
    emb = np.array(ref_ix.l2_normalize(jnp.asarray(rng.normal(size=(48, D)).astype(np.float32))))
    emb[5] = emb[2]
    valid = np.zeros(48, bool)
    valid[rng.choice(48, 30, replace=False)] = True
    valid[[2, 5]] = True
    emb = emb * valid[:, None]
    q = rng.normal(size=(6, D)).astype(np.float32)
    q[0] = emb[2]
    idx = ix.MutableBruteIndex(emb=torch.from_numpy(emb), valid=torch.from_numpy(valid))
    s, i = idx.search(q, k)
    rs, ri = ref_ix.MutableBruteIndex(emb=jnp.asarray(emb), valid=jnp.asarray(valid)).search(q, k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    assert i.dtype == torch.int32
    _close_scores(s.numpy(), rs)


def _ivf_pair(rng, cap=120, n_alive=90, c=6, slack=4):
    emb = np.array(ref_ix.l2_normalize(jnp.asarray(rng.normal(size=(cap, D)).astype(np.float32))))
    valid = np.zeros(cap, bool)
    valid[:n_alive] = True
    valid[rng.choice(n_alive, 10, replace=False)] = False
    emb = emb * valid[:, None]
    cent = emb[np.flatnonzero(valid)[:c]].copy()
    ids = np.flatnonzero(valid).astype(np.int32)
    assign = np.asarray(ref_ix.assign_to_centroids(jnp.asarray(emb[ids]), jnp.asarray(cent)))
    lists, counts = ref_ix.build_inverted_lists_slack(assign, ids, cap, c, slack)
    ref = ref_ix.MutableIVFIndex(jnp.asarray(emb), jnp.asarray(cent), lists.copy(), counts.copy(),
                                 jnp.asarray(valid), nprobe=3, slack=slack)
    port = ix.MutableIVFIndex(torch.from_numpy(emb), torch.from_numpy(cent), lists.copy(),
                              counts.copy(), torch.from_numpy(valid), nprobe=3, slack=slack)
    return ref, port, emb, valid


def test_mutable_ivf_search_add_and_deletes_match_reference():
    """Search on the reference's arrays (deleted rows masked out of the
    candidates before the scan), ``add`` (its assignment, idempotence on an
    indexed id, slack overflow) and search after it: equal on both sides."""
    rng = np.random.default_rng(11)
    ref, port, emb, valid = _ivf_pair(rng)
    q = rng.normal(size=(5, D)).astype(np.float32)
    for k in (4, 30):
        s, i = port.search(q, k)
        rs, ri = ref.search(q, k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        _close_scores(s.numpy(), rs)
        assert not np.isin(i.numpy(), np.flatnonzero(~valid[:90])).any()
    new = np.array([95, 96, 97], np.int32)  # rows past the alive prefix, written first
    rows = np.array(ref_ix.l2_normalize(jnp.asarray(rng.normal(size=(3, D)).astype(np.float32))))
    ref.emb, ref.valid = ref.emb.at[new].set(rows), ref.valid.at[new].set(True)
    at = torch.from_numpy(new.astype(np.int64))
    port.emb, port.valid = port.emb.clone(), port.valid.clone()
    port.emb[at], port.valid[at] = torch.from_numpy(rows), True
    np.testing.assert_array_equal(port.add(new), ref.add(new))
    np.testing.assert_array_equal(port.h_lists, ref.h_lists)
    np.testing.assert_array_equal(port.h_counts, ref.h_counts)
    before = (port.h_lists.copy(), port.h_counts.copy())
    port.add(new[:1])  # already indexed: no second copy
    np.testing.assert_array_equal(port.h_lists, before[0])
    np.testing.assert_array_equal(port.h_counts, before[1])
    _, i = port.search(q, 6)
    _, ri = ref.search(q, 6)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    port.h_counts[0] = port.h_lists.shape[1]  # list 0 at its width
    port.emb[98] = torch.from_numpy(np.asarray(ref.centroids)[0])  # nearest to list 0
    with pytest.raises(SlackOverflow):
        port.add(np.array([98], np.int32))


# -------------------------------------------------------- the store twin ----
def _batch_kw(rng, store):
    """One mixed batch over the reference store's live ids: edge adds and
    deletes, node adds (wired, several at once past the headroom), node
    deletes, an edge burst past the slack, a node add followed by a burst
    (the mid-apply compaction)."""
    n = store.n_nodes
    alive = np.flatnonzero(np.asarray(store.alive)[:n])
    u, v = int(rng.choice(alive)), int(rng.choice(alive))
    kind = rng.random()
    if kind < 0.25:
        return dict(add_edges=np.array([[u, v]]))
    if kind < 0.4:
        return dict(del_edges=np.array([[u, v]]))
    if kind < 0.55:
        a = int(rng.integers(1, 4))
        return dict(add_node_feat=rng.normal(size=(a, D)).astype(np.float32),
                    add_node_text=[f"added {n + j}" for j in range(a)],
                    add_edges=np.array([[n + j, int(rng.choice(alive))] for j in range(a)]))
    if kind < 0.7:
        return dict(del_nodes=np.array([u]))
    if kind < 0.85:
        return dict(add_edges=np.array([[u, int(w)] for w in rng.choice(alive, 6)]))
    return dict(add_node_feat=rng.normal(size=(1, D)).astype(np.float32),
                add_node_text=[f"hub {n}"],
                add_edges=np.array([[n, int(w)] for w in rng.choice(alive, 5)]),
                del_edges=np.array([[u, v]]), symmetric=bool(rng.random() < 0.8))


def _same_report(got, want):
    assert got.epoch == want.epoch
    np.testing.assert_array_equal(got.touched, want.touched)
    assert got.added_nodes == tuple(int(a) for a in want.added_nodes)
    assert (got.compactions, got.edges_added, got.edges_deleted, got.nodes_deleted) == \
        (want.compactions, want.edges_added, want.edges_deleted, want.nodes_deleted)


def _same_store(ref, port, q):
    assert port.stats() == ref.stats()
    assert port.active == ref.active
    np.testing.assert_array_equal(port.graph.nbr.numpy(), np.asarray(ref.graph.nbr))
    np.testing.assert_array_equal(port.graph.nbr_mask.numpy(), np.asarray(ref.graph.nbr_mask))
    np.testing.assert_array_equal(port.node_emb.numpy(), np.asarray(ref.node_emb))
    np.testing.assert_array_equal(port.alive, np.asarray(ref.alive))
    assert port.node_text == ref.node_text
    if ref.active:
        for name in MIRRORS:
            np.testing.assert_array_equal(getattr(port.delta, name), getattr(ref.delta, name))
        np.testing.assert_array_equal(port.h_feat, ref.h_feat)
        idx, ridx = port.index, ref.index
        np.testing.assert_allclose(idx.emb.numpy(), np.asarray(ridx.emb), atol=ATOL, rtol=0)
        np.testing.assert_array_equal(idx.valid.numpy(), np.asarray(ridx.valid))
        if ref.index_kind == "ivf":
            np.testing.assert_array_equal(idx.h_lists, ridx.h_lists)
            np.testing.assert_array_equal(idx.h_counts, ridx.h_counts)
            np.testing.assert_array_equal(idx.centroids.numpy(), np.asarray(ridx.centroids))
    for k in (4, 12):
        s, i = port.index.search(q, k)
        rs, ri = ref.index.search(q, k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        _close_scores(s.numpy(), rs)


def _store_pair(kind, seed, **kw):
    g_ref, g = _graphs(seed)
    ref_kw = {"index_kw": {"n_clusters": 6}} if kind == "ivf" else {}
    ref = ref_core.MutableGraphStore.build(g_ref, index_kind=kind, **ref_kw, **kw)
    port_kw = {}
    if kind == "ivf":
        # the reference's quantizer: the port's kmeans draws its initial
        # centroids from NumPy, the reference's from jax.random
        port_kw = {"index_kw": {"n_clusters": 6,
                                "centroids": np.asarray(ref.index.centroids)}}
    port = MutableGraphStore.build(g, index_kind=kind, device="cpu", **port_kw, **kw)
    return g, ref, port


@pytest.mark.parametrize("kind", ["brute", "ivf"])
def test_store_matches_reference_batch_for_batch(kind):
    """A seeded batch sequence that overflows the edge slack, the node
    capacity and (IVF) the list slack, with compactions mid-apply, by
    ``compact()`` and by both at once: after every apply the report, epoch,
    merged graph, mirrors, embeddings, index arrays and searches equal the
    reference's."""
    g, ref, port = _store_pair(kind, 5, extra_deg=2, headroom=3, ivf_slack=2)
    q = np.asarray(g.node_feat[:6], np.float32)
    _same_store(ref, port, q)
    rng = np.random.default_rng(17)
    for r in range(36):
        kw = _batch_kw(rng, ref)
        _same_report(port.apply(MutationBatch(**kw)), ref.apply(ref_core.MutationBatch(**kw)))
        _same_store(ref, port, q)
        if r % 11 == 10:
            port.compact()
            ref.compact()
            _same_store(ref, port, q)
    s = port.stats()
    assert s["compactions"] >= 4 and s["capacity"] > N + 3 and s["alive_nodes"] < s["n_nodes"]


@pytest.mark.parametrize("kind", ["brute", "ivf"])
def test_compaction_bitwise_equals_from_scratch_rebuild(kind):
    """After a batch sequence, ``compact()`` equals
    ``MutableGraphStore.build(..., active=True, alive=...)`` on the merged
    corpus (the same quantizer for IVF): graph, embeddings, index arrays,
    searches."""
    g, ref, store = _store_pair(kind, 5)  # the reference store draws the batches
    rng = np.random.default_rng(42)
    for _ in range(25):
        kw = _batch_kw(rng, ref)
        ref.apply(ref_core.MutationBatch(**kw))
        store.apply(MutationBatch(**kw))
    store.compact()
    src, dst = store.delta.live_edge_list()
    g2 = CSRGraph.from_edges(src, dst, store.n_nodes,
                             node_feat=store.h_feat[:store.n_nodes].copy(),
                             node_text=list(store.node_text[:store.n_nodes]))
    ikw = {}
    if kind == "ivf":
        ikw = {"index_kw": {"centroids": store.index.centroids.numpy(),
                            "nprobe": store.index.nprobe}}
    fresh = MutableGraphStore.build(g2, index_kind=kind, alive=store.alive, active=True,
                                    device="cpu", **ikw)
    assert torch.equal(store.graph.nbr, fresh.graph.nbr)
    assert torch.equal(store.graph.nbr_mask, fresh.graph.nbr_mask)
    assert torch.equal(store.node_emb, fresh.node_emb)
    assert torch.equal(store.index.emb, fresh.index.emb)
    if kind == "ivf":
        np.testing.assert_array_equal(store.index.h_lists, fresh.index.h_lists)
        np.testing.assert_array_equal(store.index.h_counts, fresh.index.h_counts)
    qq = np.asarray(g.node_feat[:5], np.float32)
    s1, i1 = store.index.search(qq, 5)
    s2, i2 = fresh.index.search(qq, 5)
    assert torch.equal(i1, i2) and torch.equal(s1, s2)


def test_mid_apply_compaction_no_duplicate_ivf_entries():
    """The reference's first regression: a batch that adds a node and then
    overflows the edge slack compacts after the add; the rebuilt index
    already holds the new id, so the incremental add must not insert it a
    second time.  The port equals the reference's state after the batch."""
    g, ref, port = _store_pair("ivf", 6, extra_deg=1)
    feat = np.random.default_rng(3).normal(size=(1, D)).astype(np.float32)
    kw = dict(add_node_feat=feat, add_node_text=["fresh"],
              add_edges=np.array([[N, v] for v in range(10)]))
    rep = port.apply(MutationBatch(**kw))
    _same_report(rep, ref.apply(ref_core.MutationBatch(**kw)))
    assert rep.compactions > 0
    idx = port.index
    flat = np.concatenate([idx.h_lists[c, :idx.h_counts[c]] for c in range(idx.n_clusters)])
    assert np.unique(flat, return_counts=True)[1].max() == 1
    _, top = idx.search(feat, 5)
    top = top.numpy()[0].tolist()
    assert top[0] == rep.added_nodes[0] and len(set(top)) == len(top)
    _same_store(ref, port, np.asarray(g.node_feat[:4], np.float32))


def test_is_empty_handles_numpy_edge_arrays():
    """The reference's second regression: ``is_empty`` takes ``len()`` of
    NumPy edge arrays (their truth value raises)."""
    for cls in (MutationBatch, ref_core.MutationBatch):
        assert cls().is_empty
        assert not cls(add_edges=np.array([[0, 1], [1, 2]])).is_empty
        assert not cls(del_edges=np.array([[0, 1]])).is_empty
        assert not cls(del_nodes=np.array([3, 4])).is_empty
        assert not cls(add_node_feat=np.zeros((1, D), np.float32)).is_empty


def test_pristine_store_hands_out_the_frozen_objects():
    """A never-mutated store serves the frozen ELL graph, embeddings and
    ``BruteIndex`` (the kernel's index); the pipeline reports epoch 0 and
    the logical node count; the first apply activates the delta tier."""
    _, g = _graphs(4)
    store = MutableGraphStore.build(g, device="cpu")
    ell = csr_to_ell(g, device="cpu")
    assert store.graph is store._pristine_ell and not store.active and store.epoch == 0
    assert torch.equal(store.graph.nbr, ell.nbr) and torch.equal(store.graph.nbr_mask, ell.nbr_mask)
    assert isinstance(store.index, ix.BruteIndex)
    frozen = ix.BruteIndex.build(g.node_feat, device="cpu")
    q = np.asarray(g.node_feat[:4], np.float32)
    s1, i1 = store.index.search(q, 4)
    s2, i2 = frozen.search(q, 4)
    assert torch.equal(i1, i2) and torch.equal(s1, s2)
    pipe = store.make_pipeline(config=PipelineConfig(strategy="bfs", k_seeds=2, max_hops=2,
                                                     max_nodes=12, filter_budget=6))
    res = pipe.retrieve_many(q[:3], batch_size=4)
    assert res.n_valid == 3 and res.epoch == 0 and pipe.n_valid_nodes == N
    store.apply(MutationBatch(add_node_feat=q[:1], add_edges=np.array([[N, 0]])))
    assert store.active and isinstance(store.index, ix.MutableBruteIndex)
    assert pipe.graph is store.graph and pipe.graph.num_nodes == store.capacity
    assert pipe.retrieve_many(q[:3], batch_size=4).epoch == 1
    assert pipe.n_valid_nodes == N + 1 < pipe.node_emb.shape[0]


def test_copied_pipeline_follows_the_store():
    """A pipeline copied with ``dataclasses.replace`` (as the launcher does
    to change the retrieval mode) is attached too: after an apply it serves
    the new snapshot, not the one it was copied from; discarded copies are
    held only weakly."""
    _, g = _graphs(9)
    store = MutableGraphStore.build(g, device="cpu")
    pipe = store.make_pipeline(config=PipelineConfig(max_hops=2, max_nodes=12, filter_budget=6))
    copy = dataclasses.replace(pipe, config=dataclasses.replace(pipe.config,
                                                                retrieval_mode="dense"))
    assert copy.mutation_store is store
    victim = 3
    store.apply(MutationBatch(del_nodes=np.array([victim])))
    for p in (pipe, copy):
        assert p.graph is store.graph and p.index is store.index and p.epoch == 1
        res = p.retrieve_many(np.asarray(g.node_feat[[victim]], np.float32), batch_size=2)
        assert victim not in res.nodes[0][res.mask[0]].tolist()
    n_attached = len(store._pipelines)
    del copy, p
    store.apply(MutationBatch(add_edges=np.array([[0, 1]])))
    assert len(store._pipelines) == n_attached - 1


def test_prefetch_snapshot_holds_every_tensor_a_wave_reads():
    """``prefetch._snapshot`` lists the graph's, the index's (cached device
    lists included) and the embeddings' tensors: what a wave on the side
    stream holds until its event completes."""
    g, _, store = _store_pair("ivf", 7)
    pipe = store.make_pipeline(config=PipelineConfig(max_hops=2, max_nodes=12, filter_budget=6))
    store.apply(MutationBatch(del_nodes=np.array([2])))
    pipe.retrieve_many(np.asarray(g.node_feat[:2], np.float32), batch_size=2)
    held = {t.data_ptr() for t in port_prefetch._snapshot(pipe)}
    idx = store.index
    for t in (pipe.graph.nbr, pipe.graph.nbr_mask, pipe.node_emb, idx.emb, idx.valid,
              idx.centroids, *idx._dev):
        assert t.data_ptr() in held


# ------------------------------------------------ versioned cache (twins) ----
def _entries(nodes, seeds=None, epoch=0):
    nodes = np.asarray(nodes, np.int32)
    seeds = nodes[:1] if seeds is None else np.asarray(seeds, np.int32)
    kw = dict(nodes=nodes, mask=np.ones_like(nodes, bool), dist=np.zeros(nodes.shape, np.int32),
              seeds=seeds, epoch=epoch)
    return RefEntry(**kw), CachedRetrieval(**kw)


def _cache_twin(script, **kw):
    """Run ``script(cache, make_entry)`` on a reference and a port cache;
    their returns and stats must be equal."""
    outs = []
    for cache_cls, pick in ((RefCache, 0), (RetrievalCache, 1)):
        cache = cache_cls(**kw)
        outs.append((script(cache, lambda *a, **k: _entries(*a, **k)[pick]), cache.stats()))
    assert outs[0] == outs[1]
    return outs[1]


def test_cache_region_invalidation_is_selective():
    def script(c, entry):
        c.put(np.ones(D) * 1, entry([0, 1, 2]))  # buckets {0}
        c.put(np.ones(D) * 2, entry([16, 17]))  # buckets {4}
        c.put(np.ones(D) * 3, entry([40], seeds=[3]))  # buckets {10, 0}
        dropped = c.invalidate_regions(np.array([1]), epoch=1)
        return (dropped, c.get(np.ones(D) * 1) is None, c.get(np.ones(D) * 2) is not None,
                c.get(np.ones(D) * 3) is None, c.graph_epoch)

    out, stats = _cache_twin(script, capacity=8, region_bucket=4)
    assert out == (2, True, True, True, 1)
    assert stats["invalidated"] == 2 and stats["graph_epoch"] == 1


def test_cache_put_gate_rejects_superseded_inflight_results():
    def script(c, entry):
        c.invalidate_regions(np.array([2]), epoch=1)
        c.put(np.ones(D), entry([0, 1, 2], epoch=0))  # superseded region: refused
        c.put(np.ones(D) * 3, entry([32, 33], epoch=0))  # untouched region: kept
        c.put(np.ones(D) * 4, entry([2], epoch=1))  # retrieved at the new epoch: kept
        for e in range(2, 300):  # past the bounded log: an epoch-0 result conflicts
            c.invalidate_regions(np.array([1000 + e]), epoch=e)
        c.put(np.ones(D) * 5, entry([64], epoch=0))
        return [c.get(np.ones(D) * s) is None for s in (1, 3, 4, 5)]

    out, stats = _cache_twin(script, capacity=8, region_bucket=4)
    assert out == [True, False, False, True]
    assert stats["stale_rejects"] == 2


def test_cache_mutation_flush_all_and_kv_pin_release():
    released = []

    def script(c, entry):
        e = entry([0, 1])
        c.put(np.ones(D), e)
        c.put(np.ones(D) * 2, entry([64]))

        def release(en):
            released.append(en)
            en.kv_blocks = None
            return 2

        e.kv_blocks = np.array([3, 4], np.int32)
        e.kv_release = release
        return c.invalidate_regions(np.array([1]), epoch=1), e.kv_blocks is None

    out, stats = _cache_twin(script, capacity=8, mutation_flush="all")
    assert out == (2, True) and stats["resident"] == 0 and len(released) == 2
    released.clear()
    out, stats = _cache_twin(script, capacity=8, region_bucket=4)
    assert out == (1, True) and stats["resident"] == 1 and len(released) == 2
    with pytest.raises(ValueError, match="mutation_flush"):
        RetrievalCache(mutation_flush="sometimes")


# ----------------------------------------------------- serving (twins) ----
@pytest.fixture(scope="module")
def mutation_sides():
    """(reference side, port side) with a pristine brute store each, over
    one graph, with the reference's weights."""
    g_ref, g = _graphs(11, n=120)
    vocab_ref, vocab = ref_core.Vocab.build(g_ref.node_text), Vocab.build(g.node_text)
    pcfg = dict(strategy="bfs", k_seeds=2, max_hops=2, max_nodes=12, filter_budget=6)
    kw = dict(MODEL, name="mut-t", vocab=vocab.size)
    ref_cfg, cfg = RefConfig(**kw), TransformerConfig(**kw)
    import jax

    ref_params = ref_tm.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = tm.params_from_jax(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")

    def fresh(kind="brute"):
        ref_store = ref_core.MutableGraphStore.build(g_ref, index_kind=kind)
        store = MutableGraphStore.build(g, index_kind=kind, device="cpu")
        ref_pipe = ref_store.make_pipeline(
            tokenizer=ref_core.GraphTokenizer(vocab_ref, max_len=48, node_budget=6),
            config=ref_core.PipelineConfig(**pcfg))
        pipe = store.make_pipeline(tokenizer=GraphTokenizer(vocab, max_len=48, node_budget=6),
                                   config=PipelineConfig(**pcfg))
        ref = Side(True, g_ref, _Forced(ref_pipe), ref_cfg, ref_params)
        port = Side(False, g, pipe, cfg, params)
        ref.store, port.store = ref_store, store
        return ref, port

    return fresh


Q_IDS = [3, 14, 15, 9, 3, 14, 2, 6, 9, 3, 40, 15]


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged_share"])
@pytest.mark.parametrize("prefetch", [False, True], ids=["sync", "prefetch"])
def test_seeded_mutating_serve_matches_reference(mutation_sides, paged, prefetch):
    """The launcher's seeded writer (``_drain_with_mutations``, one batch
    after about half the steps) interleaved with a 12-request serve with
    repeats, on the reference and the port: tokens, retrieved nodes,
    prompts, every serving counter and the ``mutation`` and ``cache``
    namespaces equal; prefetched on the virtual clock, so waves launched
    before a batch collect after it."""
    ref, port = mutation_sides()
    args = argparse.Namespace(mutate_rate=0.5, fault_seed=3)
    kw = dict(slots=3, cache_len=96, prefetch=prefetch, compact_every=3)
    if paged:
        kw.update(paged_kv=True, prefix_share=True)
    runs = {}
    for side, drain in ((ref, ref_serve._drain_with_mutations),
                        (port, serve._drain_with_mutations)):
        clock = Clock()
        eng = side.engine(now_fn=clock.now, sleep_fn=clock.sleep, **kw)
        ticking(eng, clock, 0.01)
        for u, qi in enumerate(Q_IDS):
            eng.submit(side.req(qi, uid=u, max_new=4 + u % 3))
        runs[side.is_ref] = (eng, {r.uid: r for r in drain(eng, side.store, args)})
    (ref_eng, ref_done), (eng, done) = runs[True], runs[False]
    same_outcomes(ref_done, done)
    same_stats(ref_eng, eng)
    ns, ref_ns = eng.stats_ns(), ref_eng.stats_ns()
    assert ns["mutation"] == ref_ns["mutation"]
    assert ns["cache"] == ref_ns["cache"]
    m = ns["mutation"]
    assert len(done) == len(Q_IDS) and all(r.done for r in done.values())
    assert m["batches"] >= 5 and m["compactions"] >= 1 and m["epoch"] == m["batches"]
    assert ns["cache"]["invalidated"] + ns["cache"]["stale_rejects"] > 0
    if paged:
        assert eng.engine.kv_pinned_blocks == ref_eng.engine.kv_pinned_blocks


def test_mid_flight_epoch_bump_and_pin_release_match_reference(mutation_sides):
    """A wave launched, then a batch deleting its queried node, then the
    collect: the wave completes against its launch-time snapshot and the
    put-gate refuses its result (``stale_rejects``); with prefix sharing
    the invalidation releases the entry's KV pin.  Equal on both sides."""
    ref, port = mutation_sides()
    outs = []
    for side in (ref, port):
        eng = side.engine(slots=2, cache_len=96, prefetch=True, paged_kv=True,
                          prefix_share=True)
        eng.submit(side.req(4, uid=0))
        r0 = eng.run_to_completion()[0]
        pinned = eng.engine.kv_pinned_blocks
        victim = int(r0.retrieved_nodes[-1])
        mb = ref_core.MutationBatch if side.is_ref else MutationBatch
        eng.apply_mutations(mb(del_nodes=np.array([victim])))
        released = (pinned, eng.engine.kv_pinned_blocks, eng.mutation_invalidated)
        eng.submit(side.req(9, uid=1))
        eng._launch_pending()
        assert eng.prefetcher.in_flight == 1
        rep = eng.apply_mutations(mb(del_nodes=np.array([9])))
        assert eng.cache.graph_epoch == rep.epoch
        r1 = eng.run_to_completion()[0]
        assert r1.done and not r1.failed and victim not in r1.retrieved_nodes.tolist()
        outs.append((released, r1.out_tokens, r1.retrieved_nodes.tolist(), eng.stats_ns()["cache"],
                     eng.stats_ns()["mutation"]))
    assert outs[0] == outs[1]
    (pinned, after, invalidated), _, _, cache, _ = outs[1]
    assert pinned > 0 and after == 0 and invalidated >= 1 and cache["stale_rejects"] >= 1


def test_zero_mutation_store_serve_equals_frozen_serve(mutation_sides):
    """A pristine store-backed serve equals a frozen-pipeline serve on the
    port (tokens, nodes) and the reference's store-backed serve; the store
    is never activated."""
    ref, port = mutation_sides()
    g = port.g
    ell = csr_to_ell(g, device="cpu")
    frozen = RGLPipeline(graph=ell, index=ix.BruteIndex.build(g.node_feat, device="cpu"),
                         node_emb=ell.node_feat, tokenizer=port.pipe.tokenizer,
                         node_text=g.node_text, config=port.pipe.config, device="cpu")
    runs = []
    for side, pipe in ((port, frozen), (port, None), (ref, None)):
        eng = side.engine(pipe, slots=2, cache_len=96)
        for u, qi in enumerate([3, 14, 15, 9, 2, 6]):
            eng.submit(side.req(qi, uid=u))
        runs.append({r.uid: r for r in eng.run_to_completion()})
    same_outcomes(runs[0], runs[1])
    same_outcomes(runs[2], runs[1])
    assert port.store.epoch == 0 and not port.store.active


def test_compact_every_and_mutation_knobs(mutation_sides, monkeypatch):
    """``compact_every`` compacts every N batches (reference counts); the
    ``RGL_MUTATION`` / ``RGL_COMPACT_EVERY`` knobs resolve; a frozen
    pipeline refuses ``apply_mutations`` as the reference's does."""
    ref, port = mutation_sides()
    counts = []
    for side in (ref, port):
        eng = side.engine(slots=2, cache_len=96, compact_every=2)
        mb = ref_core.MutationBatch if side.is_ref else MutationBatch
        rng = np.random.default_rng(3)
        for _ in range(5):
            n = side.store.n_nodes
            eng.apply_mutations(mb(add_edges=np.array([[rng.integers(0, n),
                                                        rng.integers(0, n)]])))
        counts.append((side.store.compactions, side.store.mutations_since_compact,
                       eng.stats_ns()["mutation"]))
    assert counts[0] == counts[1] and counts[1][:2] == (2, 1)
    monkeypatch.setenv("RGL_MUTATION", "1")
    monkeypatch.setenv("RGL_COMPACT_EVERY", "7")
    cfg = ServingConfig.from_env()
    assert cfg.mutation is True and cfg.compact_every == 7
    eng = port.engine(slots=2, cache_len=96)
    assert eng.compact_every == 7
    ell = csr_to_ell(port.g, device="cpu")
    frozen = RGLPipeline(graph=ell, index=ix.BruteIndex.build(port.g.node_feat, device="cpu"),
                         node_emb=ell.node_feat, tokenizer=port.pipe.tokenizer,
                         node_text=port.g.node_text, config=port.pipe.config, device="cpu")
    with pytest.raises(RuntimeError, match="MutableGraphStore"):
        port.engine(frozen, slots=2, cache_len=96).apply_mutations(MutationBatch())


@pytest.mark.parametrize("flags", [["--mutate-rate", "0.3", "--compact-every", "2"],
                                   ["--mutate-rate", "0.5", "--index", "ivf", "--prefetch"]])
def test_launcher_mutate_rate_matches_reference(capsys, monkeypatch, flags):
    """``launch.serve --rag --mutate-rate`` prints the reference launcher's
    mutation line with the same counts (retrieval and the step schedule do
    not depend on the weights, which the launchers draw from different
    generators); other index kinds exit as the reference's do."""
    common = ["--arch", "starcoder2-3b", "--rag", "--nodes", "300", "--requests", "10"]
    out = serve.main(common + flags + ["--device", "cpu"])
    port_lines = capsys.readouterr().out.splitlines()
    monkeypatch.setattr("sys.argv", ["serve"] + common + flags)
    ref_serve.main()
    ref_lines = capsys.readouterr().out.splitlines()
    assert any(line.startswith("  mutation: ") for line in port_lines)
    untimed = lambda lines: [x for x in lines[1:] if "overlapped" not in x]  # noqa: E731
    assert untimed(port_lines) == untimed(ref_lines)
    assert out["stats"]["mutation_batches"] > 0
    with pytest.raises(SystemExit, match="--index"):
        serve.main(common + ["--mutate-rate", "0.2", "--index", "sharded", "--device", "cpu"])
