"""Port sharded index vs the reference and vs the port's own brute index:
the hierarchical top-k merge, sharded brute search (logical shards on one
device), sharded IVF search on the reference's per-shard centroids and
lists, and the reference's recall / empty-shard / build_index cases.

Tolerances: ids exact everywhere, tie order included.  Scores within
``atol = 1e-6`` (a few ulp of unit-vector dot products): the reference's
own sharded scores are not bitwise equal to its brute scores (ROADMAP
Queue 3), so no score is held bitwise across layouts.  The merge itself only
selects, so its scores are held bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BruteIndex as RefBruteIndex
from repro.core import ShardedIndex as RefShardedIndex
from repro.core import hierarchical_topk_merge as ref_merge
from repro_torch.core.indexing import BruteIndex, build_index
from repro_torch.core.pipeline import PipelineConfig, index_from_config
from repro_torch.core.sharding import ShardedIndex, hierarchical_topk_merge

ATOL = 1e-6


def T(a):
    return torch.from_numpy(np.array(a))


def _same(s, i, ws, wi):
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))


# ---------------------------------------------------------------- merge ----
@pytest.mark.parametrize("s,q,w,k", [(2, 3, 5, 4), (5, 2, 7, 9), (8, 4, 3, 6), (1, 2, 6, 3),
                                     (3, 2, 4, 20), (7, 3, 2, 5)])
def test_merge_matches_reference(s, q, w, k):
    """Odd shard counts pad a level with (-inf, INT32_MAX); -inf entries and
    equal scores are ordered by id."""
    rng = np.random.default_rng(s * 100 + w)
    scores = rng.standard_normal((s, q, w)).astype(np.float32)
    scores[0, :, -1] = -np.inf
    scores[-1, :, 0] = scores[0, :, 0]  # a tie across shards
    ids = rng.permutation(s * q * w).reshape(s, q, w).astype(np.int32)
    ws, wi = ref_merge(jnp.asarray(scores), jnp.asarray(ids), k)
    ms, mi = hierarchical_topk_merge(T(scores), T(ids), k)
    np.testing.assert_array_equal(ms.numpy().view(np.uint32), np.asarray(ws).view(np.uint32))
    np.testing.assert_array_equal(mi.numpy(), np.asarray(wi))
    flat_s = scores.transpose(1, 0, 2).reshape(q, -1)
    flat_i = ids.transpose(1, 0, 2).reshape(q, -1)
    for qi in range(q):
        order = np.lexsort((flat_i[qi], -flat_s[qi]))[:min(k, s * w)]
        np.testing.assert_array_equal(mi[qi, :len(order)].numpy(), flat_i[qi][order])


def test_merge_breaks_ties_by_id():
    s, q, w, k = 4, 2, 3, 5
    perm = np.tile(np.random.default_rng(1).permutation(s * w), (q, 1))
    ids = T(perm.reshape(q, s, w).transpose(1, 0, 2).astype(np.int32))
    _, mi = hierarchical_topk_merge(torch.ones((s, q, w)), ids, k)
    np.testing.assert_array_equal(mi.numpy(), np.tile(np.arange(k), (q, 1)))


# ------------------------------------------------------- sharded brute ----
@pytest.mark.parametrize("n,n_shards,k", [(101, 3, 7), (96, 4, 5), (60, 7, 60), (2500, 2, 11),
                                          (5, 4, 5), (700, 7, 9)])
def test_sharded_brute_matches_brute(n, n_shards, k):
    """N not divisible by S, k == N, an empty trailing shard (5 rows in 4
    shards of 2), S = 7."""
    rng = np.random.default_rng(n + n_shards)
    emb = rng.standard_normal((n, 32)).astype(np.float32)
    q = rng.standard_normal((5, 32)).astype(np.float32)
    bs, bi = BruteIndex.build(emb, device="cpu").search(q, k)
    idx = ShardedIndex.build(emb, n_shards=n_shards, device="cpu")
    assert idx.n_shards == min(n_shards, n)
    ss, si = idx.search(q, k)
    _same(ss, si, bs, bi)
    _same(ss, si, *RefShardedIndex.build(emb, n_shards=n_shards).search(jnp.asarray(q), k))
    _same(ss, si, *RefBruteIndex.build(emb).search(jnp.asarray(q), k))


def test_sharded_brute_ties_with_duplicate_rows():
    """Rows i, i + 40 and i + 80 are equal and fall in different shards: the
    merge gives the lowest global id first, as the unsharded scan does."""
    base = np.random.default_rng(2).standard_normal((40, 16)).astype(np.float32)
    emb = np.concatenate([base, base, base])
    q = base[:4].copy()
    bs, bi = BruteIndex.build(emb, device="cpu").search(q, 9)
    ss, si = ShardedIndex.build(emb, n_shards=5, device="cpu").search(q, 9)
    _same(ss, si, bs, bi)
    assert si[:, :3].tolist() == [[i, i + 40, i + 80] for i in range(4)]
    _same(ss, si, *RefBruteIndex.build(emb).search(jnp.asarray(q), 9))


# --------------------------------------------------------- sharded IVF ----
def _port_from_reference(r):
    return ShardedIndex(
        emb_shards=T(r.emb_shards), n_total=r.n_total, rows_per_shard=r.rows_per_shard,
        normalized=r.normalized, inner=r.inner, centroids=T(r.centroids), lists=T(r.lists),
        list_mask=T(r.list_mask), nprobe=r.nprobe)


@pytest.mark.parametrize("n,n_shards,n_clusters,nprobe,k", [
    (1200, 3, 8, 2, 10), (1000, 4, 16, 3, 7), (5, 4, 4, 4, 3), (333, 7, 4, 1, 40)])
def test_sharded_ivf_matches_reference_on_its_shards(n, n_shards, n_clusters, nprobe, k):
    rng = np.random.default_rng(n)
    emb = rng.standard_normal((n, 32)).astype(np.float32)
    q = rng.standard_normal((6, 32)).astype(np.float32)
    r = RefShardedIndex.build(emb, n_shards=n_shards, inner="ivf", n_clusters=n_clusters,
                              nprobe=nprobe)
    ws, wi = r.search(jnp.asarray(q), k)
    s, i = _port_from_reference(r).search(q, k)
    _same(s, i, ws, wi)


def test_sharded_ivf_recall_vs_brute():
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((1200, 32)).astype(np.float32)
    q = rng.standard_normal((12, 32)).astype(np.float32)
    _, bi = BruteIndex.build(emb, device="cpu").search(q, 10)
    sivf = ShardedIndex.build(emb, n_shards=3, inner="ivf", n_clusters=8, nprobe=8, device="cpu")
    _, si = sivf.search(q, 10)  # nprobe == C: exhaustive in every shard
    rec = np.mean([len(set(si[r].tolist()) & set(bi[r].tolist())) / 10 for r in range(12)])
    assert rec >= 0.99, rec


def test_sharded_ivf_empty_trailing_shard():
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((5, 8)).astype(np.float32)
    q = rng.standard_normal((2, 8)).astype(np.float32)
    sv = ShardedIndex.build(emb, n_shards=4, inner="ivf", n_clusters=4, nprobe=4, device="cpu")
    s, i = sv.search(q, 3)
    assert int(i.max()) < 5 and torch.isfinite(s).all()
    bs, bi = BruteIndex.build(emb, device="cpu").search(q, 3)
    _same(s, i, bs, bi)  # every list probed in every shard: exact


def test_build_index_kinds_and_config_shards():
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((50, 8)).astype(np.float32)
    q = rng.standard_normal((3, 8)).astype(np.float32)
    bs, bi = BruteIndex.build(emb, device="cpu").search(q, 4)
    one = build_index(emb, kind="sharded", n_shards=1, device="cpu")
    _same(*one.search(q, 4), bs, bi)
    sivf = build_index(emb, kind="sharded_ivf", n_shards=2, n_clusters=4, nprobe=4, device="cpu")
    s2, i2 = sivf.search(q, 4)
    assert s2.shape == (3, 4) and int(i2.max()) < 50 and sivf.inner == "ivf"
    for kind in ("sharded", "sharded_ivf"):
        idx = index_from_config(emb, PipelineConfig(index_kind=kind, index_shards=3), device="cpu")
        assert isinstance(idx, ShardedIndex) and idx.n_shards == 3
    assert index_from_config(emb, PipelineConfig(index_kind="sharded"), device="cpu").n_shards == 1
    with pytest.raises(ValueError, match="unknown inner"):
        ShardedIndex.build(emb, inner="hnsw", device="cpu")
