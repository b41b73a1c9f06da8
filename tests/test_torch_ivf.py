"""Port IVF index vs the reference on the same numpy inputs: the inverted
lists, the Lloyd iterations from the reference's own initial centroids,
both plain arms of the candidate scan against the reference's tiled scan and
dense ``ref``, ``IVFIndex.search`` on the reference's index arrays, the
reference's recall / clamp / empty-cluster cases, and the RAG pipeline with
``index_kind="ivf"``.

Tolerances: ids, lists, masks, nodes and prompts exact.  Scores on
integer-valued data bitwise (every dot product is exact in fp32 in any
order); on float data within ``atol = rtol = 1e-6`` (fp32 dot products of
the same terms summed in another order: a few ulp), with ids exact wherever
neighbouring scores are more than 1e-4 apart.  Centroids within
``atol = 1e-5`` (the port sums clusters in float64, the reference in
float32); assignments exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import indexing as ref_ix
from repro.core import GraphTokenizer as RefTokenizer
from repro.core import PipelineConfig as RefPipelineConfig
from repro.core import RGLPipeline as RefPipeline
from repro.core import Vocab as RefVocab
from repro.graph import csr_to_ell as ref_csr_to_ell
from repro.graph import generators as ref_gen
from repro.kernels.ivf_scan import kernel as ref_kernel
from repro.kernels.ivf_scan import ops as ref_ops
from repro.kernels.ivf_scan import ref as ref_ref
from repro_torch.core import indexing as ix
from repro_torch.core.pipeline import PipelineConfig, RGLPipeline
from repro_torch.core.tokenization import GraphTokenizer, Vocab
from repro_torch.graph import generators
from repro_torch.graph.ell import csr_to_ell
from repro_torch.kernels.ivf_scan import ops, ref


def T(a):
    return torch.from_numpy(np.array(a))


def _clustered(rng, n_centers=10, per=120, d=24, spread=0.15):
    centers = rng.standard_normal((n_centers, d)).astype(np.float32) * 3
    pts = (centers[None].repeat(per, 0)
           + spread * rng.standard_normal((per, n_centers, d))).reshape(-1, d)
    return pts.astype(np.float32), centers


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


# ------------------------------------------------------------ list build ----
@pytest.mark.parametrize("n,c", [(0, 4), (1, 1), (37, 5), (400, 7), (10, 4)])
def test_build_inverted_lists_matches_reference(n, c):
    assign = np.random.default_rng(n + c).integers(0, c, n).astype(np.int64)
    if n == 10:
        assign[:] = 0  # every point in cluster 0: three empty clusters
    lists, mask = ix.build_inverted_lists(assign, n, c)
    ref_lists, ref_mask = ref_ix.build_inverted_lists(assign, n, c)
    np.testing.assert_array_equal(lists, ref_lists)
    np.testing.assert_array_equal(mask, ref_mask)
    assert lists.dtype == np.int32


# ---------------------------------------------------------------- kmeans ----
def _jax_init(x, n_clusters, seed):
    n = x.shape[0]
    idx = jax.random.choice(jax.random.PRNGKey(seed), n, shape=(n_clusters,),
                            replace=n_clusters > n)
    return x[np.asarray(idx)]


@pytest.mark.parametrize("case", ["clustered", "normalized", "gaussian", "more_clusters"])
def test_lloyd_matches_reference_from_its_initial_centroids(case):
    rng = np.random.default_rng(21)
    if case == "gaussian":
        x, c = rng.standard_normal((300, 16)).astype(np.float32), 8
    elif case == "more_clusters":  # duplicate initial centroids: empty clusters stay frozen
        x, c = rng.standard_normal((5, 8)).astype(np.float32), 12
    else:
        x, c = _clustered(rng)[0], 16
        if case == "normalized":
            x = np.asarray(ref_ix.l2_normalize(jnp.asarray(x)))
    seed = 3
    ref_cent, ref_assign = ref_ix.kmeans(jnp.asarray(x), c, n_iter=10, seed=seed)
    cent, assign = ix._lloyd(T(x), T(_jax_init(x, c, seed)), 10)
    assert cent.dtype == torch.float32 and cent.shape == (c, x.shape[1])
    np.testing.assert_array_equal(assign.numpy(), np.asarray(ref_assign))
    np.testing.assert_allclose(cent.numpy(), np.asarray(ref_cent), atol=1e-5, rtol=0)


def test_kmeans_more_clusters_than_points():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((5, 8)).astype(np.float32))
    cent, assign = ix.kmeans(x, 12)
    assert cent.shape == (12, 8) and assign.shape == (5,)
    assert int(assign.max()) < 12


# ----------------------------------------------------------- scan arms ----
def _scan_inputs(rng, integer, n=400, d=16, qn=6):
    w = int(rng.integers(12, 900))
    k = int(rng.integers(1, 24))
    draw = (lambda s: rng.integers(-3, 4, s)) if integer else rng.standard_normal
    emb = draw((n, d)).astype(np.float32)
    q = draw((qn, d)).astype(np.float32)
    cand = rng.integers(0, n + 1, (qn, w)).astype(np.int32)
    if integer:
        m = w // 3
        cand[:, :m] = cand[:, m:2 * m]  # duplicate ids -> score ties
    cmask = (rng.random((qn, w)) < 0.7) & (cand < n)
    return q, emb, cand, cmask, k


def _reference_arms(q, emb, cand, cmask, k, c_blk):
    args = tuple(jnp.asarray(a) for a in (q, emb, cand, cmask))
    dense = ref_ops.ivf_candidate_scan(*args, k, tiled=False)
    tiled = ref_ops.ivf_candidate_scan(*args, k, tiled=True, c_blk=c_blk)
    return [tuple(map(np.asarray, r)) for r in (dense, tiled)]


def _port_arms(q, emb, cand, cmask, k, c_blk):
    args = tuple(T(a) for a in (q, emb, cand, cmask))
    out = []
    for tiled in (False, True):
        s, i = ops.ivf_candidate_scan(*args, k, tiled=tiled, c_blk=c_blk)
        assert s.dtype == torch.float32 and i.dtype == torch.int32 and s.shape == (q.shape[0], k)
        out.append((s.numpy(), i.numpy()))
    return out


@pytest.mark.parametrize("trial", range(4))
def test_scan_arms_bitwise_match_reference_exact_arithmetic(trial):
    """Integer-valued data: both port arms give the reference's dense and
    tiled results bit for bit, duplicate-id ties and -inf tails included;
    the c_blk = 128 tiles leave W ragged (padded to a tile multiple)."""
    q, emb, cand, cmask, k = _scan_inputs(np.random.default_rng(100 + trial), True)
    want = _reference_arms(q, emb, cand, cmask, k, 128)
    for s, i in _port_arms(q, emb, cand, cmask, k, 128):
        for ws, wi in want:
            np.testing.assert_array_equal(_bits(s), _bits(ws))
            np.testing.assert_array_equal(i, wi)


@pytest.mark.parametrize("trial", range(3))
def test_scan_arms_match_reference_float_within_ulp(trial):
    q, emb, cand, cmask, k = _scan_inputs(np.random.default_rng(200 + trial), False)
    (sd, idd), (st, idt) = _reference_arms(q, emb, cand, cmask, k, 128)
    port = _port_arms(q, emb, cand, cmask, k, 128)
    # the port's two arms sum every score in one order: bitwise equal
    np.testing.assert_array_equal(_bits(port[0][0]), _bits(port[1][0]))
    np.testing.assert_array_equal(port[0][1], port[1][1])
    gap_prev = np.abs(np.diff(sd, axis=1, prepend=np.inf))
    gap_next = np.abs(np.diff(sd, axis=1, append=-np.inf))
    clear = np.minimum(gap_prev, gap_next) > 1e-4
    for s, i in port:
        for ws, wi in ((sd, idd), (st, idt)):
            np.testing.assert_allclose(s, ws, rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(i[clear], wi[clear])


def test_scan_all_masked_rows_return_raw_masked_ids():
    """Fewer live candidates than k: a -inf tail holding the raw ids of the
    lowest-position masked slots (real ids here, not the sentinel)."""
    rng = np.random.default_rng(7)
    n, d, qn, w, k = 200, 8, 3, 300, 6
    emb = rng.integers(-3, 4, (n, d)).astype(np.float32)
    q = rng.integers(-3, 4, (qn, d)).astype(np.float32)
    cand = rng.integers(0, n, (qn, w)).astype(np.int32)
    cmask = np.zeros((qn, w), bool)
    cmask[:, :2] = True  # 2 live < k
    cmask[2] = False  # a row with no live slot
    want = _reference_arms(q, emb, cand, cmask, k, 64)
    for s, i in _port_arms(q, emb, cand, cmask, k, 64):
        assert np.all(np.isneginf(s[:, 2:])) and np.all(np.isneginf(s[2]))
        np.testing.assert_array_equal(i[2], cand[2, :k])
        for ws, wi in want:
            np.testing.assert_array_equal(_bits(s), _bits(ws))
            np.testing.assert_array_equal(i, wi)


def test_scan_narrow_candidates_pad_to_k():
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 8)).astype(np.float32)
    emb = rng.standard_normal((30, 8)).astype(np.float32)
    cand = rng.integers(0, 31, (2, 5)).astype(np.int32)
    cmask = cand < 30
    want = _reference_arms(q, emb, cand, cmask, 9, 1024)
    for s, i in _port_arms(q, emb, cand, cmask, 9, 1024):
        assert np.all(np.isneginf(s[:, 5:])) and np.all(i[:, 5:] == 30)
        for ws, wi in want:
            np.testing.assert_allclose(s, ws, rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(i, wi)


def test_tiled_arm_matches_reference_tiled_kernel_directly():
    """``ref.ivf_scan_tiled`` against ``ivf_scan_tiled`` on a W that is a
    multiple of c_blk, k > c_blk (each tile keeps all its slots)."""
    rng = np.random.default_rng(9)
    n, d, qn, w, k, c_blk = 300, 12, 4, 256, 80, 64
    emb = rng.integers(-3, 4, (n, d)).astype(np.float32)
    q = rng.integers(-3, 4, (qn, d)).astype(np.float32)
    cand = rng.integers(0, n + 1, (qn, w)).astype(np.int32)
    cmask = (rng.random((qn, w)) < 0.5) & (cand < n)
    ws, wi = ref_kernel.ivf_scan_tiled(*(jnp.asarray(a) for a in (q, emb, cand, cmask)), k,
                                       c_blk=c_blk)
    s, i = ref.ivf_scan_tiled(T(q), T(emb), T(cand), T(cmask), k, c_blk=c_blk)
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(ws))
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    ds, di = ref_ref.ivf_candidate_scan(*(jnp.asarray(a) for a in (q, emb, cand, cmask)), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(di))


def test_dot_scores_sums_in_the_kernel_order():
    """32 lane-strided partial sums from +0, then a halving tree (the order
    the card's kernel is held to bit for bit), D not a multiple of 32."""
    rng = np.random.default_rng(10)
    q = rng.standard_normal((2, 70)).astype(np.float32)
    ce = rng.standard_normal((2, 5, 70)).astype(np.float32)
    p = np.zeros((2, 5, 96), np.float32)
    p[..., :70] = ce * q[:, None, :]
    acc = np.zeros((2, 5, 32), np.float32)
    for j in range(3):
        acc = acc + p[..., 32 * j:32 * (j + 1)]
    for o in (16, 8, 4, 2, 1):
        acc = acc[..., :o] + acc[..., o:2 * o]
    np.testing.assert_array_equal(ref.dot_scores(T(q), T(ce)).numpy(), acc[..., 0])


# ---------------------------------------------------------------- index ----
def _port_index(r, nprobe=None):
    return ix.IVFIndex(emb=T(np.asarray(r.emb)), centroids=T(np.asarray(r.centroids)),
                       lists=T(np.asarray(r.lists)), list_mask=T(np.asarray(r.list_mask)),
                       nprobe=r.nprobe if nprobe is None else nprobe)


@pytest.mark.parametrize("k", [1, 7, 40])
def test_ivf_search_matches_reference_on_its_index(k):
    rng = np.random.default_rng(11)
    emb, _ = _clustered(rng, n_centers=6, per=80)
    r = ref_ix.IVFIndex.build(emb, n_clusters=8, nprobe=3)
    q = rng.standard_normal((5, emb.shape[1])).astype(np.float32)
    ws, wi = r.search(jnp.asarray(q), k)
    s, i = _port_index(r).search(q, k)
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    # the tiled arm of the reference's search gives the same ids
    q_n = ref_ix.l2_normalize(jnp.asarray(q))
    _, ti = ref_ix._ivf_search(r.emb, r.centroids, r.lists, r.list_mask, q_n, r.nprobe, k,
                               tiled=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ti))


def test_ivf_build_matches_reference_given_its_initial_centroids():
    """The whole build (normalize, Lloyd, lists) from the reference's draw."""
    rng = np.random.default_rng(12)
    emb, _ = _clustered(rng, n_centers=6, per=80)
    r = ref_ix.IVFIndex.build(emb, n_clusters=8, nprobe=3, seed=5)
    x = ix.l2_normalize(T(emb))
    cent, assign = ix._lloyd(x, T(_jax_init(x.numpy(), 8, 5)), 10)
    lists, mask = ix.build_inverted_lists(assign.numpy(), emb.shape[0], 8)
    # normalized rows within a few ulp: sums of squares in another order
    np.testing.assert_allclose(x.numpy(), np.asarray(r.emb), atol=1e-6, rtol=0)
    np.testing.assert_allclose(cent.numpy(), np.asarray(r.centroids), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(lists, np.asarray(r.lists))
    np.testing.assert_array_equal(mask, np.asarray(r.list_mask))


def _recall(a, b, k):
    return np.mean([len(set(a[r].tolist()) & set(b[r].tolist())) / k for r in range(len(a))])


def test_ivf_recall_on_clustered_data():
    rng = np.random.default_rng(0)
    emb, centers = _clustered(rng)
    q = (centers[:8] + 0.1 * rng.standard_normal((8, centers.shape[1]))).astype(np.float32)
    _, bi = ix.BruteIndex.build(emb, device="cpu").search(q, 10)
    _, ii = ix.IVFIndex.build(emb, n_clusters=16, nprobe=16, device="cpu").search(q, 10)
    assert _recall(ii.numpy(), bi.numpy(), 10) >= 0.9  # all lists probed


def test_ivf_recall_degrades_gracefully_with_fewer_probes():
    rng = np.random.default_rng(0)
    emb, centers = _clustered(rng)
    q = centers[:8].astype(np.float32)
    _, bi = ix.BruteIndex.build(emb, device="cpu").search(q, 10)
    _, ii = ix.IVFIndex.build(emb, n_clusters=16, nprobe=2, device="cpu").search(q, 10)
    assert _recall(ii.numpy(), bi.numpy(), 10) >= 0.5


def test_ivf_build_clamps_clusters_and_nprobe():
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((6, 8)).astype(np.float32)
    ivf = ix.IVFIndex.build(emb, n_clusters=32, nprobe=64, device="cpu")
    assert ivf.centroids.shape[0] <= 6 and ivf.nprobe <= ivf.centroids.shape[0]
    s, i = ivf.search(rng.standard_normal((2, 8)).astype(np.float32), 6)
    assert set(i.flatten().tolist()) <= set(range(6)) and s.shape == (2, 6)


def test_ivf_keeps_requested_k_when_candidates_are_narrow():
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((30, 8)).astype(np.float32)
    ivf = ix.IVFIndex.build(emb, n_clusters=8, nprobe=1, device="cpu")
    w = ivf.nprobe * ivf.lists.shape[1]
    s, i = ivf.search(rng.standard_normal((3, 8)).astype(np.float32), w + 5)
    assert s.shape == i.shape == (3, w + 5)
    assert torch.all(torch.isneginf(s[:, w:])) and torch.all(i[:, w:] == 30)


def test_ivf_empty_cluster_probe_is_safe():
    rng = np.random.default_rng(3)
    emb = np.tile(rng.standard_normal((3, 8)).astype(np.float32), (20, 1))
    ivf = ix.IVFIndex.build(emb, n_clusters=8, nprobe=8, device="cpu")
    s, i = ivf.search(emb[:4], 5)
    assert int(i.max()) < 60 and torch.isfinite(s).all()


# ------------------------------------------------------------- pipeline ----
def test_rag_pipeline_with_ivf_matches_reference():
    """Seeds, subgraphs and prompts of the pipeline with ``index_kind="ivf"``
    equal the reference's, both indexes holding the reference's arrays."""
    n = 2000
    g_ref = ref_gen.citation_graph(n, avg_deg=8, seed=3)
    g = generators.citation_graph(n, avg_deg=8, seed=3)
    kw = dict(strategy="bfs", k_seeds=3, max_hops=2, max_nodes=16, filter_budget=6,
              retrieval_mode="dense", index_kind="ivf")
    r_ix = ref_ix.build_index(jnp.asarray(g_ref.node_feat), kind="ivf", n_clusters=16)
    ref_pipe = RefPipeline(
        graph=ref_csr_to_ell(g_ref), index=r_ix, node_emb=jnp.asarray(g_ref.node_feat),
        tokenizer=RefTokenizer(RefVocab.build(g_ref.node_text), max_len=96, node_budget=8),
        node_text=g_ref.node_text, config=RefPipelineConfig(**kw))
    ell = csr_to_ell(g, device="cpu")
    pipe = RGLPipeline(
        graph=ell, index=_port_index(r_ix), node_emb=ell.node_feat,
        tokenizer=GraphTokenizer(Vocab.build(g.node_text), max_len=96, node_budget=8),
        node_text=g.node_text, config=PipelineConfig(**kw), device="cpu")
    rng = np.random.default_rng(4)
    q = g.node_feat[rng.choice(n, 5)] + 0.01 * rng.standard_normal((5, 128)).astype(np.float32)
    a = ref_pipe.retrieve_many(q, batch_size=8)
    b = pipe.retrieve_many(q, batch_size=8)
    np.testing.assert_array_equal(np.asarray(a.seeds), b.seeds.numpy())
    for name in ("nodes", "mask", "dist"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)), getattr(b, name).numpy())
    texts = [g.node_text[i][:40] for i in range(8)]
    ids_a, mask_a = ref_pipe.tokenize(texts, a.sub)
    ids_b, mask_b = pipe.tokenize(texts, b.sub)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_array_equal(mask_a, mask_b)


# ------------------------------------------- the CUDA kernel's plan and walk ----
# A NumPy emulation of csrc/ivf_scan.cu (and the merge of
# csrc/topk_merge.cuh: tests/_topk_emulation.py): each block's
# slot range, each warp's runs of 32 slots, the masked-slot fillers while a
# list ends in -inf, the live slots in batches of 8 scored in the kernel's
# order, the running lists with their entry threshold, then the tree merge
# of the query's lists; ids read from cand at the winning positions.
from repro_torch.kernels import topk_merge  # noqa: E402
from repro_torch.kernels.ivf_scan import kernel as ivf_kernel  # noqa: E402

from _topk_emulation import PAD, insert, key, merge_tree  # noqa: E402


def _kernel_dot(q, ce):
    """q (D,) . ce (..., D) in the kernel's order, in float32 arithmetic:
    lane l sums its rounded products of columns l, l + 32, ... from +0, then
    the halving tree."""
    d = q.shape[0]
    dp = -(-d // 32) * 32
    p = np.zeros(ce.shape[:-1] + (dp,), np.float32)
    p[..., :d] = ce * q
    acc = np.zeros(ce.shape[:-1] + (32,), np.float32)
    for m in range(dp // 32):
        acc = acc + p[..., 32 * m:32 * (m + 1)]
    for o in (16, 8, 4, 2, 1):
        acc = acc[..., :o] + acc[..., o:2 * o]
    return acc[..., 0]


def _emulate_ivf(q, emb, cand, cmask, k, plan, stats=None):
    stats = {} if stats is None else stats
    qn, w = cand.shape
    n = emb.shape[0]
    large = k > topk_merge.CAP
    assert plan.kk == (topk_merge.CAP if large else k) and 1 <= k <= w
    assert plan.span % ivf_kernel.RUN == 0 and plan.grid_x == -(-w // plan.span)
    out_s = np.full((qn, k), np.nan, np.float32)
    out_i = np.full((qn, k), -1, np.int64)
    for qi in range(qn):
        scores = _kernel_dot(q[qi], emb[np.clip(cand[qi], 0, n - 1)])
        seen = np.zeros(w, np.int64)
        lists = []  # block x's warp wp at x * 8 + wp
        for x in range(plan.grid_x):
            s0, s1 = x * plan.span, min(w, (x + 1) * plan.span)
            for wp in range(ivf_kernel.WARPS):
                lst, covered = [PAD] * plan.kk, 0
                for base in range(s0 + ivf_kernel.RUN * wp, s1, ivf_kernel.RUN * ivf_kernel.WARPS):
                    p = np.arange(base, min(base + ivf_kernel.RUN, s1))
                    seen[p] += 1
                    covered += len(p)
                    live = cmask[qi, p]
                    if lst[-1][1] == -np.inf:  # fillers, in lane order
                        for pos in p[~live]:
                            if pos < lst[-1][2]:
                                insert(lst, (key(-np.inf, pos), np.float32(-np.inf), pos), stats)
                    lp = p[live]
                    for b0 in range(0, len(lp), 8):  # gathered 8 rows at a time
                        for pos in lp[b0:b0 + 8]:
                            e = (key(scores[pos], pos), scores[pos], pos)
                            if e[0] > lst[-1][0]:
                                insert(lst, e, stats)
                if large:
                    assert covered <= topk_merge.CAP  # the list keeps all its slots
                lists.append(lst)
        assert (seen == 1).all()
        fin = merge_tree(lists, k, plan.stride)
        out_s[qi] = [e[1] for e in fin]
        out_i[qi] = [cand[qi, e[2]] for e in fin]
    return out_s, out_i


def _hold_ivf(q, emb, cand, cmask, k, sm=132, integer=True):
    """The emulation against both port arms (bit for bit: the same order),
    and the reference's tiled and dense arms: bit for bit on integer data,
    else within 1e-6 with ids exact where neighbouring scores are clear."""
    plan = ivf_kernel.launch_plan(q.shape[0], cand.shape[1], k, sm)
    stats = {}
    s, i = _emulate_ivf(q, emb, cand, cmask, k, plan, stats)
    for ps, pi in _port_arms(q, emb, cand, cmask, k, 128):
        np.testing.assert_array_equal(_bits(s), _bits(ps))
        np.testing.assert_array_equal(i, pi)
    want = _reference_arms(q, emb, cand, cmask, k, 128)
    for ws, wi in want:
        if integer:
            np.testing.assert_array_equal(_bits(s), _bits(ws))
            np.testing.assert_array_equal(i, wi)
        else:
            np.testing.assert_allclose(s, ws, rtol=1e-6, atol=1e-6)
            gap_prev = np.abs(np.diff(ws, axis=1, prepend=np.inf))
            gap_next = np.abs(np.diff(ws, axis=1, append=-np.inf))
            clear = np.minimum(gap_prev, gap_next) > 1e-4
            np.testing.assert_array_equal(i[clear], wi[clear])
    return plan, stats


def test_ivf_launch_plan_main_path():
    """The IVF wave (Q = 4, W = 14,916 slots, k = 3) on an H100 (132 SMs):
    59 blocks of 256 slots a query, a run a warp; Q = 64, k = 32: 5 blocks of
    3,072 slots a query."""
    plan = ivf_kernel.launch_plan(4, 14_916, 3, 132)
    assert plan == ivf_kernel.IvfPlan(3, 256, 59, 59 * 8 * 3)
    assert ivf_kernel.launch_plan(64, 14_916, 32, 132) == ivf_kernel.IvfPlan(
        32, 3_072, 5, 5 * 8 * 32)
    # the last block stages the merge: two copies of the query's lists
    assert ivf_kernel.ivf_smem_bytes(128, 3, plan.stride) == 512 + 16 * 59 * 8 * 3


def test_ivf_layout_constants_match_cuda_source():
    import re
    from pathlib import Path

    src = (Path(ivf_kernel.__file__).parents[2] / "csrc" / "ivf_scan.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kWarps"]) == ivf_kernel.WARPS and int(consts["kRun"]) == ivf_kernel.RUN
    assert int(consts["kRows"]) == 8


@pytest.mark.parametrize("q,w,k", [(4, 14_916, 3), (64, 14_916, 32), (1, 1, 1), (2, 5, 5),
                                   (3, 31, 7), (5, 2049, 32), (4, 3000, 300), (2, 700, 300),
                                   (1, 20_000, 256), (1, 20_000, 257), (7, 899, 23),
                                   (300, 100, 9), (2, 4096, 4096), (9, 33, 33)])
def test_ivf_launch_plan_covers_every_slot_once(q, w, k):
    """Every slot in exactly one run of one warp of one block; past k = 256
    no warp's list spans more than 256 slots; the scratch holds every merge
    level; about two blocks an SM."""
    for sm in (1, 3, 132):
        plan = ivf_kernel.launch_plan(q, w, k, sm)
        assert plan.kk == min(k, 256) and plan.span % 256 == 0
        assert plan.grid_x == -(-w // plan.span)
        seen = np.zeros(w, np.int64)
        for x in range(plan.grid_x):
            s0, s1 = x * plan.span, min(w, (x + 1) * plan.span)
            assert s1 > s0
            for wp in range(8):
                runs = range(s0 + 32 * wp, s1, 256)
                for base in runs:
                    seen[base:min(base + 32, s1)] += 1
                if k > 256:
                    assert 32 * len(runs) <= 256
        assert (seen == 1).all()
        assert plan.stride == topk_merge.merge_stride(plan.grid_x * 8, plan.kk, k)
        assert ivf_kernel.ivf_smem_bytes(128, plan.kk, plan.stride) <= ivf_kernel.SMEM_PER_BLOCK
        if k <= 256:
            assert plan.grid_x * q <= max(2 * sm + q, q * -(-w // 32))
    with pytest.raises(ValueError, match="k="):
        ivf_kernel.launch_plan(1, 5, 6, 132)


def _ivf_case(seed, qn, n, d, w, integer, live=0.6):
    rng = np.random.default_rng(seed)
    draw = (lambda s: rng.integers(-3, 4, s)) if integer else rng.standard_normal
    emb = draw((n, d)).astype(np.float32)
    emb[n // 2:n // 2 + n // 8] = emb[:n // 8]  # duplicate rows
    q = draw((qn, d)).astype(np.float32)
    cand = rng.integers(0, n + 1, (qn, w)).astype(np.int32)
    cand[:, :w // 3] = cand[:, w // 3:2 * (w // 3)]  # duplicate ids: exact ties
    cmask = (rng.random((qn, w)) < live) & (cand < n)
    return q, emb, cand, cmask


@pytest.mark.parametrize("qn,n,d,w,k,sm,integer", [
    (4, 400, 16, 1500, 3, 132, True),  # a run a warp, many blocks
    (4, 400, 16, 1500, 3, 1, True),  # few blocks: each warp walks many runs
    (3, 300, 40, 900, 23, 4, False),
    (2, 300, 70, 700, 256, 132, True),  # k at the list capacity
    (2, 300, 24, 700, 300, 132, True),  # k past it: the tree merge
    (1, 50, 8, 300, 300, 2, True),  # k = W past the capacity
    (3, 100, 8, 20, 9, 132, True),  # W smaller than a warp's run
    (2, 100, 130, 64, 5, 132, False),  # two 128-column blocks a row
])
def test_emulated_ivf_scan_matches_reference(qn, n, d, w, k, sm, integer):
    q, emb, cand, cmask = _ivf_case(qn * w + k, qn, n, d, w, integer)
    cmask[-1] = False  # a row with no live slot: raw ids of its first slots
    _hold_ivf(q, emb, cand, cmask, k, sm=sm, integer=integer)


@pytest.mark.parametrize("seed", range(3))
def test_emulated_ivf_live_slots_in_the_last_block_only(seed):
    """A row whose live slots all lie in its last block and the tail of its
    last run, another with fewer live slots than k: the masked fillers of
    the earlier blocks lead the -inf tail."""
    q, emb, cand, cmask = _ivf_case(40 + seed, 3, 200, 8, 1000, True)
    plan = ivf_kernel.launch_plan(3, 1000, 12, 132)
    assert plan.grid_x > 2
    cmask[0, :(plan.grid_x - 1) * plan.span] = False
    cmask[1] = False
    cmask[1, -5:] = cand[1, -5:] < 200
    _hold_ivf(q, emb, cand, cmask, 12)
    s, i = _emulate_ivf(q, emb, cand, cmask, 12, plan)
    nl = int(cmask[1].sum())
    assert np.isneginf(s[1, nl:]).all()
    np.testing.assert_array_equal(i[1, nl:], cand[1][~cmask[1]][:12 - nl])
