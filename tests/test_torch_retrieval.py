"""Port retrieval stages vs the reference on the same graph and queries:
BFS subgraphs, the strategy and backend dispatch, the dynamic filter,
padded batched retrieval and tokenized prompts.  Every output here is integer or bool and
must match exactly, tie order included."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BruteIndex as RefBruteIndex
from repro.core import GraphTokenizer as RefTokenizer
from repro.core import PipelineConfig as RefPipelineConfig
from repro.core import RGLPipeline as RefPipeline
from repro.core import Vocab as RefVocab
from repro.core import filters as ref_filters
from repro.core import graph_retrieval as ref_gr
from repro.graph import ELLGraph as RefELLGraph
from repro.graph import csr_to_ell as ref_csr_to_ell
from repro.graph import generators as ref_gen
from repro_torch.core import filters, graph_retrieval as gr
from repro_torch.core.indexing import BruteIndex, build_index
from repro_torch.core.pipeline import PipelineConfig, RGLPipeline
from repro_torch.core.tokenization import GraphTokenizer, Vocab
from repro_torch.graph import generators
from repro_torch.graph.ell import ELLGraph, csr_to_ell

N = 2000
PCFG = dict(strategy="bfs", k_seeds=3, max_hops=2, max_nodes=16, filter_budget=6,
            retrieval_mode="dense")


@pytest.fixture(scope="module")
def stacks():
    g_ref = ref_gen.citation_graph(N, avg_deg=8, seed=3)
    g = generators.citation_graph(N, avg_deg=8, seed=3)
    ref_pipe = RefPipeline(
        graph=ref_csr_to_ell(g_ref), index=RefBruteIndex.build(jnp.asarray(g_ref.node_feat)),
        node_emb=jnp.asarray(g_ref.node_feat),
        tokenizer=RefTokenizer(RefVocab.build(g_ref.node_text), max_len=96, node_budget=8),
        node_text=g_ref.node_text, config=RefPipelineConfig(**PCFG),
    )
    ell = csr_to_ell(g, device="cpu")
    pipe = RGLPipeline(
        graph=ell, index=BruteIndex.build(g.node_feat, device="cpu"), node_emb=ell.node_feat,
        tokenizer=GraphTokenizer(Vocab.build(g.node_text), max_len=96, node_budget=8),
        node_text=g.node_text, config=PipelineConfig(**PCFG), device="cpu",
    )
    return g, ref_pipe, pipe


def _seeds(rng, q, s, n):
    seeds = rng.integers(0, n, (q, s)).astype(np.int32)
    seeds[0, -1] = -1  # padding
    seeds[1, 1] = seeds[1, 0]  # duplicate
    return seeds


def _same_sub(a, b):
    for name in ("nodes", "mask", "dist"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)), getattr(b, name).numpy(),
                                      err_msg=name)
    assert a.num_nodes == b.num_nodes


@pytest.mark.parametrize("max_hops,max_nodes", [(1, 16), (2, 64), (3, 40)])
def test_bfs_subgraph_matches(stacks, max_hops, max_nodes):
    _, ref_pipe, pipe = stacks
    seeds = _seeds(np.random.default_rng(max_hops), 5, 3, N)
    a = ref_gr.bfs_subgraph(ref_pipe.graph.nbr, ref_pipe.graph.nbr_mask, jnp.asarray(seeds),
                            max_hops=max_hops, max_nodes=max_nodes)
    b = gr.bfs_subgraph(pipe.graph.nbr, pipe.graph.nbr_mask, torch.from_numpy(seeds),
                        max_hops=max_hops, max_nodes=max_nodes)
    _same_sub(a, b)


@pytest.mark.parametrize("mode", ["dense", "auto"])
def test_retrieve_subgraph_matches(stacks, mode):
    _, ref_pipe, pipe = stacks
    seeds = _seeds(np.random.default_rng(9), 4, 3, N)
    a = ref_gr.retrieve_subgraph(ref_pipe.graph, jnp.asarray(seeds), mode=mode, max_hops=3,
                                 max_nodes=32)
    b = gr.retrieve_subgraph(pipe.graph, torch.from_numpy(seeds), mode=mode, max_hops=3,
                             max_nodes=32)
    _same_sub(a, b)
    assert b.overflow is None


@pytest.mark.parametrize("budget", [4, 16, 40])
def test_dynamic_filter_matches(stacks, budget):
    """Seeds all score +inf and padding -inf: the survivors among equal scores
    follow position order in both."""
    g, ref_pipe, pipe = stacks
    rng = np.random.default_rng(budget)
    seeds = _seeds(rng, 4, 3, N)
    q = g.node_feat[rng.choice(N, 4)]
    sub_a = ref_gr.bfs_subgraph(ref_pipe.graph.nbr, ref_pipe.graph.nbr_mask, jnp.asarray(seeds),
                                max_hops=2, max_nodes=32)
    sub_b = gr.bfs_subgraph(pipe.graph.nbr, pipe.graph.nbr_mask, torch.from_numpy(seeds),
                            max_hops=2, max_nodes=32)
    sc_a = ref_filters.similarity_scores(ref_pipe.node_emb, jnp.asarray(q))
    sc_b = filters.similarity_scores(pipe.node_emb, torch.from_numpy(q))
    np.testing.assert_allclose(sc_b.numpy(), np.asarray(sc_a), atol=1e-5, rtol=0)
    a = ref_filters.dynamic_filter(sub_a, sc_a, jnp.asarray(seeds), budget=budget)
    b = filters.dynamic_filter(sub_b, sc_b, torch.from_numpy(seeds), budget=budget)
    _same_sub(a, b)


def test_retrieve_many_padding_and_prompts(stacks):
    g, ref_pipe, pipe = stacks
    rng = np.random.default_rng(11)
    q = g.node_feat[rng.choice(N, 3)] + 0.01 * rng.standard_normal((3, 128)).astype(np.float32)
    a = ref_pipe.retrieve_many(q, batch_size=8)
    b = pipe.retrieve_many(q, batch_size=8)
    assert (a.n_valid, b.n_valid, b.epoch) == (3, 3, 0)
    assert b.seeds.shape[0] == 8
    _same_sub(a.sub, b.sub)
    np.testing.assert_array_equal(np.asarray(a.seeds), b.seeds.numpy())
    # padding rows never perturb real rows
    c = pipe.retrieve(q)
    for name in ("nodes", "mask", "dist"):
        assert torch.equal(getattr(b, name)[:3], getattr(c, name))
    texts = [g.node_text[i][:40] for i in range(8)]
    ids_a, mask_a = ref_pipe.tokenize(texts, a.sub)
    ids_b, mask_b = pipe.tokenize(texts, b.sub)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_array_equal(mask_a, mask_b)


def test_pipeline_run_matches(stacks):
    g, ref_pipe, pipe = stacks
    qe = g.node_feat[:3]
    texts = [g.node_text[i] for i in range(3)]
    a = ref_pipe.run(jnp.asarray(qe), texts)
    b = pipe.run(qe, texts)
    np.testing.assert_array_equal(a["seeds"], b["seeds"])
    for qi in range(3):  # a node's own embedding retrieves itself
        assert qi in b["seeds"][qi]
    np.testing.assert_array_equal(a["prompt_ids"], b["prompt_ids"])
    np.testing.assert_array_equal(a["prompt_mask"], b["prompt_mask"])


def test_induced_adjacency_matches(stacks):
    _, ref_pipe, pipe = stacks
    seeds = _seeds(np.random.default_rng(2), 3, 3, N)
    a = ref_gr.bfs_subgraph(ref_pipe.graph.nbr, ref_pipe.graph.nbr_mask, jnp.asarray(seeds),
                            max_hops=2, max_nodes=24)
    b = gr.bfs_subgraph(pipe.graph.nbr, pipe.graph.nbr_mask, torch.from_numpy(seeds),
                        max_hops=2, max_nodes=24)
    na, ma = ref_gr.induced_adjacency(ref_pipe.graph.nbr, ref_pipe.graph.nbr_mask, a)
    nb, mb = gr.induced_adjacency(pipe.graph.nbr, pipe.graph.nbr_mask, b)
    np.testing.assert_array_equal(np.asarray(na), nb.numpy())
    np.testing.assert_array_equal(np.asarray(ma), mb.numpy())


def test_unported_paths_raise(stacks):
    """Paths that raised in earlier slices now run: the compact backend,
    ``auto`` at >= 100k nodes, the non-BFS strategies (matching the
    reference) and every index kind (held to the reference in
    ``tests/test_torch_ivf.py`` and ``tests/test_torch_sharding.py``); an
    unknown mode, index kind or device still raises."""
    _, ref_pipe, pipe = stacks
    seeds = np.array([[1990, 1995, 1995]], np.int32)
    a = ref_gr.retrieve_subgraph(ref_pipe.graph, jnp.asarray(seeds), mode="compact")
    b = gr.retrieve_subgraph(pipe.graph, torch.from_numpy(seeds), mode="compact")
    _same_sub(a, b)
    np.testing.assert_array_equal(b.overflow.numpy(), np.asarray(a.overflow))
    # auto on a graph claiming >= AUTO_COMPACT_MIN_NODES nodes takes compact
    big_ref = RefELLGraph(nbr=ref_pipe.graph.nbr, nbr_mask=ref_pipe.graph.nbr_mask,
                          num_nodes=ref_gr.AUTO_COMPACT_MIN_NODES)
    big = ELLGraph(nbr=pipe.graph.nbr, nbr_mask=pipe.graph.nbr_mask,
                   num_nodes=gr.AUTO_COMPACT_MIN_NODES)
    for hops in (1, 3):  # 1: compact answers; 3: the ball overflows, dense re-runs
        a = ref_gr.retrieve_subgraph(big_ref, jnp.asarray(seeds), mode="auto", max_hops=hops,
                                     workset_cap=64)
        b = gr.retrieve_subgraph(big, torch.from_numpy(seeds), mode="auto", max_hops=hops,
                                 workset_cap=64)
        _same_sub(a, b)
        assert (b.overflow is None) == (a.overflow is None) == (hops == 3)
    a = ref_gr.retrieve_subgraph(ref_pipe.graph, jnp.asarray(seeds), "steiner", mode="dense")
    _same_sub(a, gr.retrieve_subgraph(pipe.graph, torch.from_numpy(seeds), "steiner",
                                      mode="dense"))
    with pytest.raises(ValueError, match="unknown retrieval mode"):
        gr.retrieve_subgraph(pipe.graph, seeds, mode="fast")
    for kind in ("ivf", "sharded", "sharded_ivf"):
        s, i = build_index(pipe.node_emb, kind=kind, device="cpu").search(pipe.node_emb[:2], 3)
        assert s.shape == i.shape == (2, 3) and i[:, 0].tolist() == [0, 1]
    with pytest.raises(ValueError, match="unknown index kind"):
        build_index(pipe.node_emb, kind="hnsw", device="cpu")
    with pytest.raises(ValueError, match="lives on"):
        dataclasses.replace(pipe, device="meta")


@pytest.mark.parametrize("strategy", ["bfs", "dense", "steiner", "ppr"])
@pytest.mark.parametrize("mode,cap", [("compact", 64), ("compact", 2048), ("auto", 2048)])
def test_pipeline_strategies_and_modes_match(stacks, strategy, mode, cap):
    """Batched retrieval through the pipeline object for every strategy and
    backend; the compact backend's overflow flags reach ``RetrievalResult``
    through the filter (cap 64 overflows at 2 hops on this graph)."""
    g, ref_pipe, pipe = stacks
    kw = dict(strategy=strategy, retrieval_mode=mode, workset_cap=cap, max_hops=2)
    rp = dataclasses.replace(ref_pipe, config=dataclasses.replace(ref_pipe.config, **kw))
    tp = dataclasses.replace(pipe, config=dataclasses.replace(pipe.config, **kw))
    rng = np.random.default_rng(len(strategy) + cap)
    q = g.node_feat[rng.choice(N, 3)] + 0.01 * rng.standard_normal((3, 128)).astype(np.float32)
    a = rp.retrieve_many(q, batch_size=4)
    b = tp.retrieve_many(q, batch_size=4)
    np.testing.assert_array_equal(b.seeds.numpy(), np.asarray(a.seeds))
    _same_sub(a.sub, b.sub)
    if a.overflow is None:
        assert b.overflow is None
    else:
        np.testing.assert_array_equal(b.overflow.numpy(), np.asarray(a.overflow))
    if mode == "compact" and strategy != "ppr":
        assert bool(b.overflow[:3].any()) == (cap == 64)
