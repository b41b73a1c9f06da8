"""Hand-written kernels against their plain versions on the card, at edge
shapes the main path does not reach (query groups, odd widths, tiny N,
ragged candidate rows, worksets of one id or of more than 48 KB).
Needs an NVIDIA Hopper GPU and nvcc; skips elsewhere.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Scores within ``atol=1e-5`` (fp32 dot products of unit vectors, summed in
another order); ids, BFS reach, workset marks and retrieved subgraphs exact.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _unit(rng, shape, dev):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    return x / x.norm(dim=-1, keepdim=True)


@pytest.mark.parametrize("q,n,d,k", [(1, 1, 8, 1), (3, 255, 40, 7), (9, 3000, 128, 3),
                                     (20, 5000, 96, 64), (4, 700, 1024, 300)])
def test_topk_sim_kernel_matches_plain(dev, q, n, d, k):
    from repro_torch.kernels.topk_sim import kernel, ops

    rng = np.random.default_rng(n)
    qv, ev = _unit(rng, (q, d), dev), _unit(rng, (n, d), dev)
    before = kernel.launches.count
    s_k, i_k = ops.topk_similarity(qv, ev, k)
    torch.cuda.synchronize()
    assert kernel.launches.count == before + 1
    s_p, i_p = ops.topk_similarity(qv, ev, k, use_kernel=False)
    assert (s_k - s_p).abs().max().item() <= 1e-5
    assert torch.equal(i_k, i_p)


def test_topk_sim_ties_lowest_id_first(dev):
    from repro_torch.kernels.topk_sim import ops

    rng = np.random.default_rng(0)
    ev = _unit(rng, (2000, 64), dev)
    ev[[10, 300, 1999]] = ev[7].clone()
    s, i = ops.topk_similarity(ev[7:8].clone(), ev, 5)
    assert i[0, :4].tolist() == [7, 10, 300, 1999]
    zeros = torch.zeros((2, 64), device=dev)  # padded serving rows: all scores tie
    assert ops.topk_similarity(zeros, ev, 3)[1].tolist() == [[0, 1, 2], [0, 1, 2]]


@pytest.mark.parametrize("q,n,k,p", [(1, 1, 8, 0.5), (3, 1000, 13, 0.05), (40, 2000, 16, 0.01),
                                     (5, 4097, 24, 0.0), (2, 3000, 8, 1.0)])
def test_bfs_frontier_kernel_matches_plain(dev, q, n, k, p):
    from repro_torch.kernels.bfs_frontier import kernel, ops

    rng = np.random.default_rng(q * n)
    nbr = torch.from_numpy(rng.integers(0, n + 1, (n, k)).astype(np.int32)).to(dev)
    msk = torch.from_numpy(rng.random((n, k)) < 0.6).to(dev)
    fr = torch.from_numpy(rng.random((q, n)) < p).to(dev)
    before = kernel.launches.count
    got = ops.frontier_hop(fr, nbr, msk)
    torch.cuda.synchronize()
    assert kernel.launches.count == before + 1
    assert torch.equal(got, ops.frontier_hop(fr, nbr, msk, use_kernel=False))


def test_kernels_refuse_bad_inputs(dev):
    from repro_torch.kernels.bfs_frontier import ops as bops
    from repro_torch.kernels.topk_sim import ops as tops

    ev = torch.zeros((10, 4), device=dev)
    with pytest.raises(ValueError, match="width"):
        tops.topk_similarity(torch.zeros((1, 4), device=dev), ev[:, :3].contiguous(), 2)
    with pytest.raises(ValueError, match="int32"):
        bops.frontier_hop(torch.zeros((1, 10), dtype=torch.bool, device=dev),
                          torch.zeros((10, 8), dtype=torch.int64, device=dev),
                          torch.zeros((10, 8), dtype=torch.bool, device=dev))


def _sorted_rows(rng, q, c, n, dev):
    """Ascending int32 rows with repeats and sentinel-n padding."""
    ws = np.full((q, c), n, np.int32)
    for qi in range(q):
        fill = int(rng.integers(1, c + 1))
        ws[qi, :fill] = np.sort(rng.integers(0, n, fill))
    return torch.from_numpy(ws).to(dev)


@pytest.mark.parametrize("q,c,w", [(1, 1, 1), (3, 7, 1001), (4, 2048, 40_000), (2, 300, 4096),
                                   (5, 20_000, 9_999), (1, 58_112, 4100)])
def test_frontier_expand_kernel_matches_plain(dev, q, c, w):
    """Rows of one id, C not a power of two, rows past 48 KB of shared
    memory, ragged W; candidates equal to the sentinel and int32 max."""
    from repro_torch.kernels.frontier_expand import kernel, ops

    rng = np.random.default_rng(c + w)
    n = max(2 * c, 50)
    ws = _sorted_rows(rng, q, c, n, dev)
    cand = torch.from_numpy(rng.integers(0, n + 1, (q, w)).astype(np.int32)).to(dev)
    cand[:, : min(w, 3)] = n
    cand[:, -1] = torch.iinfo(torch.int32).max
    before = kernel.launches.count
    got = ops.ws_member(ws, cand)
    torch.cuda.synchronize()
    assert kernel.launches.count == before + 1
    assert torch.equal(got, ops.ws_member(ws, cand, use_kernel=False))
    # a candidate row that starts off 16-byte alignment takes the scalar loads
    off = cand[:, 1:]
    assert torch.equal(ops.ws_member(ws, off), ops.ws_member(ws, off, use_kernel=False))


def test_frontier_expand_refuses_rows_past_shared_memory(dev):
    from repro_torch.kernels.frontier_expand import kernel, ops

    ws = torch.zeros((1, 58_113), dtype=torch.int32, device=dev)
    before = kernel.launches.count
    with pytest.raises(ValueError, match="shared memory"):
        ops.ws_member(ws, torch.zeros((1, 8), dtype=torch.int32, device=dev))
    assert kernel.launches.count == before


def test_expand_hop_mark_arm_matches_sort_arm_on_the_card(dev):
    from repro_torch.kernels.frontier_expand import ops

    rng = np.random.default_rng(4)
    n, k, q, c = 5000, 24, 3, 256
    nbr = torch.from_numpy(rng.integers(0, n + 1, (n, k)).astype(np.int32)).to(dev)
    msk = torch.from_numpy(rng.random((n, k)) < 0.5).to(dev)
    ws = np.full((q, c), n, np.int32)
    for qi in range(q):
        fill = int(rng.integers(1, c))
        ws[qi, :fill] = np.sort(rng.choice(n, fill, replace=False))
    dist = np.where(ws < n, rng.integers(0, 2, (q, c)), ops.INF).astype(np.int32)
    args = (torch.from_numpy(ws).to(dev), torch.from_numpy(dist).to(dev), nbr, msk, 2)
    mark = ops.expand_hop(*args, band=5)
    plain = ops.expand_hop(*args, band=5, use_kernel=False)
    for a, b in zip(mark, plain):
        assert torch.equal(a, b)


def test_compact_retrieval_on_the_card_matches_the_cpu(dev):
    """Every strategy through the compact backend (frontier_expand on the
    card), with and without overflow, equals the CPU's plain versions."""
    from repro_torch.core import graph_retrieval as gr
    from repro_torch.graph import generators
    from repro_torch.graph.ell import csr_to_ell

    g = generators.citation_graph(5000, seed=2, with_text=False)
    seeds = np.random.default_rng(3).integers(0, 5000, (4, 3)).astype(np.int32)
    for strategy in ("bfs", "dense", "steiner", "ppr"):
        for cap in (64, 2048):
            out = []
            for d in (dev, torch.device("cpu")):
                sub = gr.retrieve_subgraph(csr_to_ell(g, device=d), seeds, strategy,
                                           mode="compact", workset_cap=cap, max_hops=2,
                                           max_nodes=16)
                out.append([t.cpu() for t in (sub.nodes, sub.mask, sub.dist, sub.overflow)])
            for a, b in zip(*out):
                assert torch.equal(a, b), (strategy, cap)


def test_retrieval_on_the_card_matches_the_cpu(dev):
    """Batched retrieval through both kernels on the card equals the plain
    versions on the CPU, on the same graph and queries."""
    from repro_torch.core.indexing import BruteIndex
    from repro_torch.core.pipeline import PipelineConfig, RGLPipeline
    from repro_torch.graph import generators
    from repro_torch.graph.ell import csr_to_ell

    g = generators.citation_graph(5000, seed=2)
    cfg = PipelineConfig(k_seeds=3, max_nodes=16, filter_budget=6, retrieval_mode="dense")
    out = []
    for d in (dev, torch.device("cpu")):
        ell = csr_to_ell(g, device=d)
        pipe = RGLPipeline(graph=ell, index=BruteIndex.build(g.node_feat, device=d),
                           node_emb=ell.node_feat, config=cfg, device=d)
        res = pipe.retrieve_many(g.node_feat[:5], batch_size=8)
        out.append([t.cpu() for t in (res.seeds, res.nodes, res.mask, res.dist)])
    for a, b in zip(*out):
        assert torch.equal(a, b)
