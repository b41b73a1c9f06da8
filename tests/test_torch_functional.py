"""The port's functional API (``repro_torch.core.functional``, paper
§2.3.2) and graph converters (``repro_torch.graph.convert``, §2.1.1)
against the reference's: a composed run with a custom stage spliced in, and
the PyG / DGL layout payloads and their round trips (neither library is
installed, so the layout-dict path is the one both packages take)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BruteIndex as RefBruteIndex
from repro.core import GraphTokenizer as RefTokenizer
from repro.core import Vocab as RefVocab
from repro.core import functional as ref_fn
from repro.graph import convert as ref_convert
from repro.graph import csr_to_ell as ref_csr_to_ell
from repro_torch.core import functional as fn
from repro_torch.core.indexing import BruteIndex
from repro_torch.core.pipeline import PipelineConfig, RGLPipeline
from repro_torch.core.tokenization import GraphTokenizer, Vocab
from repro_torch.graph import generators
from repro_torch.graph.convert import from_dgl, from_pyg, to_dgl, to_pyg
from repro_torch.graph.ell import csr_to_ell


@pytest.fixture(scope="module")
def graph():
    g = generators.citation_graph(250, avg_deg=6, seed=11)
    return g, csr_to_ell(g, device="cpu")


def _composed(api, index, ell, emb, vocab_cls, tok_cls, g, strategy, calls, **kw):
    def custom_stage(ctx):  # injected logic between retrieval and filtering
        calls.append(int(ctx["subgraph"].mask.sum()))
        return ctx

    return api.compose(
        api.stage_embed(index),
        api.stage_seeds(k=3),
        api.stage_subgraph(ell, strategy, **kw),
        custom_stage,
        api.stage_filter(emb, budget=10),
        api.stage_tokenize(tok_cls(vocab_cls.build(g.node_text), max_len=128, node_budget=8),
                           g.node_text),
    )


@pytest.mark.parametrize("strategy,kw", [("bfs", dict(max_hops=2, max_nodes=32)),
                                         ("steiner", dict(max_hops=3, max_nodes=24))])
def test_functional_api_composes_with_custom_stage_as_reference(graph, strategy, kw):
    """The composed run of ``tests/test_extensions.py`` on both packages:
    seeds, subgraph nodes and mask, prompt ids and mask, and what the
    custom stage saw are equal."""
    g, ell = graph
    emb = jnp.asarray(g.node_feat)
    ref_calls, calls = [], []
    ref_run = _composed(ref_fn, RefBruteIndex.build(emb), ref_csr_to_ell(g), emb, RefVocab,
                        RefTokenizer, g, strategy, ref_calls, **kw)
    run = _composed(fn, BruteIndex.build(g.node_feat, device="cpu"), ell, ell.node_feat, Vocab,
                    GraphTokenizer, g, strategy, calls, **kw)
    texts = [g.node_text[i] for i in range(4)]
    want = ref_run({"query_emb": emb[:4], "query_texts": texts})
    got = run({"query_emb": g.node_feat[:4], "query_texts": texts})
    assert isinstance(got["query_emb"], torch.Tensor)
    assert calls == ref_calls and calls[0] > 0
    np.testing.assert_array_equal(got["seeds"].numpy(), np.asarray(want["seeds"]))
    np.testing.assert_array_equal(got["subgraph"].nodes.numpy(), np.asarray(want["subgraph"].nodes))
    np.testing.assert_array_equal(got["subgraph"].mask.numpy(), np.asarray(want["subgraph"].mask))
    np.testing.assert_array_equal(got["prompt_ids"], np.asarray(want["prompt_ids"]))
    np.testing.assert_array_equal(got["prompt_mask"], np.asarray(want["prompt_mask"]))
    assert got["prompt_ids"].shape == (4, 128) and got["subgraph"].nodes.shape == (4, 10)


def test_functional_run_equals_the_pipelines_run(graph):
    """The stages composed in the pipeline's order give ``RGLPipeline.run``'s
    seeds, subgraph and prompts."""
    g, ell = graph
    index = BruteIndex.build(g.node_feat, device="cpu")
    tok = GraphTokenizer(Vocab.build(g.node_text), max_len=128, node_budget=8)
    cfg = PipelineConfig(strategy="bfs", k_seeds=3, max_hops=2, max_nodes=32, filter_budget=10)
    pipe = RGLPipeline(graph=ell, index=index, node_emb=ell.node_feat, tokenizer=tok,
                       node_text=g.node_text, config=cfg, device="cpu")
    texts = [g.node_text[i] for i in range(4)]
    want = pipe.run(g.node_feat[:4], texts)
    got = fn.compose(
        fn.stage_embed(index), fn.stage_seeds(k=3),
        fn.stage_subgraph(ell, "bfs", max_hops=2, max_nodes=32),
        fn.stage_filter(ell.node_feat, budget=10), fn.stage_tokenize(tok, g.node_text),
    )({"query_emb": g.node_feat[:4], "query_texts": texts})
    np.testing.assert_array_equal(got["seeds"].numpy(), want["seeds"])
    assert torch.equal(got["subgraph"].nodes, want["subgraph"].nodes)
    np.testing.assert_array_equal(got["prompt_ids"], want["prompt_ids"])
    np.testing.assert_array_equal(got["prompt_mask"], want["prompt_mask"])


def test_stage_generate_and_encoder(graph):
    g, _ = graph
    index = BruteIndex.build(g.node_feat, device="cpu")

    class Echo:
        def generate(self, ids, mask, n):
            return [int(m.sum()) + n for m in mask]

    ctx = fn.compose(fn.stage_embed(index, encoder=lambda q: q * 2), fn.stage_seeds(k=2),
                     fn.stage_generate(Echo(), max_new_tokens=3))(
        {"query_emb": g.node_feat[:2], "prompt_ids": np.zeros((2, 4)),
         "prompt_mask": np.ones((2, 4), bool)})
    assert torch.equal(ctx["query_emb"], torch.from_numpy(g.node_feat[:2]) * 2)
    assert ctx["outputs"] == [7, 7] and ctx["seeds"].shape == (2, 2)


# ------------------------------------------------------------ converters ---
def test_pyg_payload_equals_reference(graph):
    g, _ = graph
    mine, ref = to_pyg(g), ref_convert.to_pyg(g)
    assert set(mine) == set(ref) and mine["num_nodes"] == ref["num_nodes"]
    np.testing.assert_array_equal(mine["edge_index"], ref["edge_index"])
    assert mine["edge_index"].dtype == np.int64
    np.testing.assert_array_equal(mine["x"], ref["x"])


def test_dgl_payload_equals_reference(graph):
    g, _ = graph
    mine, ref = to_dgl(g), ref_convert.to_dgl(g)
    assert mine["num_nodes"] == ref["num_nodes"]
    for a, b in zip(mine["edges"], ref["edges"]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int64
    np.testing.assert_array_equal(mine["ndata"]["feat"], ref["ndata"]["feat"])


@pytest.mark.parametrize("side", ["pyg", "dgl"])
def test_roundtrips_equal_reference(graph, side):
    """``from_*(to_*(g))`` keeps the graph (the reference test's checks) and
    gives the reference's CSR arrays; each side reads the other's payload."""
    g, _ = graph
    to, frm = (to_pyg, from_pyg) if side == "pyg" else (to_dgl, from_dgl)
    ref_to = getattr(ref_convert, f"to_{side}")
    ref_frm = getattr(ref_convert, f"from_{side}")
    g2 = frm(to(g))
    assert g2.num_nodes == g.num_nodes and g2.num_edges == g.num_edges
    np.testing.assert_allclose(g2.node_feat, g.node_feat)
    for u in (0, 17, 123):
        assert sorted(g2.neighbors(u)) == sorted(g.neighbors(u))
    for got, want in ((frm(ref_to(g)), ref_frm(ref_to(g))), (ref_frm(to(g)), ref_frm(ref_to(g)))):
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.node_feat, want.node_feat)


def test_converters_without_features():
    g = generators.citation_graph(30, avg_deg=3, seed=2)
    g.node_feat = None
    assert to_dgl(g)["ndata"] == {} and to_pyg(g)["x"] is None
    assert from_dgl(to_dgl(g)).num_edges == from_pyg(to_pyg(g)).num_edges == g.num_edges
