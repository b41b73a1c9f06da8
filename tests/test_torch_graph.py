"""Port graph substrate vs the reference: the same seeds give byte-identical
graphs, features and texts, and ``csr_to_ell`` the same ELL layout."""
import numpy as np
import pytest
import torch

from repro.graph import csr_to_ell as ref_csr_to_ell
from repro.graph import generators as ref_gen
from repro_torch.graph import generators
from repro_torch.graph.ell import csr_to_ell


def _same_csr(a, b):
    assert a.num_nodes == b.num_nodes
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices, b.indices)
    for name in ("node_feat", "edge_feat"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert a.node_text == b.node_text


@pytest.mark.parametrize("seed", [0, 7])
def test_citation_graph_identical(seed):
    _same_csr(ref_gen.citation_graph(1500, avg_deg=8, seed=seed),
              generators.citation_graph(1500, avg_deg=8, seed=seed))


def test_other_generators_identical():
    _same_csr(ref_gen.random_regular_graph(500, 5, seed=3),
              generators.random_regular_graph(500, 5, seed=3))
    ga, ma, ia = ref_gen.bipartite_recsys_graph(200, 80, 1500, seed=2)
    gb, mb, ib = generators.bipartite_recsys_graph(200, 80, 1500, seed=2)
    _same_csr(ga, gb)
    assert np.array_equal(ma, mb) and np.array_equal(ia, ib)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("max_deg,pad", [(None, 8), (4, 8), (None, 1)])
def test_csr_to_ell_identical(seed, max_deg, pad):
    ga = ref_gen.citation_graph(1500, avg_deg=8, seed=seed)
    gb = generators.citation_graph(1500, avg_deg=8, seed=seed)
    ea = ref_csr_to_ell(ga, max_deg, pad_to_multiple=pad)
    eb = csr_to_ell(gb, max_deg, pad_to_multiple=pad, device="cpu")
    assert eb.nbr.dtype == torch.int32 and eb.nbr_mask.dtype == torch.bool
    np.testing.assert_array_equal(np.asarray(ea.nbr), eb.nbr.numpy())
    np.testing.assert_array_equal(np.asarray(ea.nbr_mask), eb.nbr_mask.numpy())
    np.testing.assert_array_equal(np.asarray(ea.node_feat), eb.node_feat.numpy())
    np.testing.assert_array_equal(np.asarray(ea.degrees()), eb.degrees().numpy())
    assert (ea.max_deg, ea.sentinel) == (eb.max_deg, eb.sentinel)
