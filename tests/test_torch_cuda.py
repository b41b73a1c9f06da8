"""Hand-written kernels against their plain versions on the card, at edge
shapes the main path does not reach (query groups, odd widths, tiny N).
Needs an NVIDIA Hopper GPU and nvcc; skips elsewhere.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Scores within ``atol=1e-5`` (fp32 dot products of unit vectors, summed in
another order); ids and BFS reach exact.
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
