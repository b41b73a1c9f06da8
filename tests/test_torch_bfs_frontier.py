"""Port ``bfs_frontier`` vs the reference: the port's plain version against
the Pallas kernel in interpret mode and the reference's ``ref.py``.  Exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bfs_frontier import ops as ref_ops
from repro.kernels.bfs_frontier import ref as ref_ref
from repro_torch.graph import generators
from repro_torch.graph.ell import csr_to_ell
from repro_torch.kernels.bfs_frontier import kernel, ops


def _both(fr, nbr, msk):
    want = np.asarray(ref_ops.frontier_hop(jnp.asarray(fr), jnp.asarray(nbr), jnp.asarray(msk),
                                           use_kernel=True))
    np.testing.assert_array_equal(
        want, np.asarray(ref_ref.frontier_hop(jnp.asarray(fr), jnp.asarray(nbr), jnp.asarray(msk))))
    got = ops.frontier_hop(torch.from_numpy(fr), torch.from_numpy(nbr), torch.from_numpy(msk))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("trial", range(3))
def test_random_ell_matches_reference_kernel(trial):
    rng = np.random.default_rng(100 + trial)
    n = int(rng.integers(300, 1200))
    k = int(rng.integers(2, 14))
    q = int(rng.integers(1, 5))
    nbr = rng.integers(0, n + 1, (n, k)).astype(np.int32)  # n = sentinel, live too
    msk = rng.random((n, k)) < 0.7
    _both(rng.random((q, n)) < 0.03, nbr, msk)


def test_citation_ell_empty_and_full_frontiers():
    ell = csr_to_ell(generators.citation_graph(1500, seed=4), device="cpu")
    nbr, msk = ell.nbr.numpy(), ell.nbr_mask.numpy()
    rng = np.random.default_rng(5)
    fr = np.concatenate([rng.random((3, 1500)) < 0.01, np.zeros((1, 1500), bool),
                         np.ones((1, 1500), bool)])
    _both(fr, nbr, msk)


def test_cpu_takes_plain_version_and_kernel_needs_a_card():
    fr = torch.zeros((1, 10), dtype=torch.bool)
    nbr = torch.full((10, 8), 10, dtype=torch.int32)
    msk = torch.zeros((10, 8), dtype=torch.bool)
    before = kernel.launches.count
    assert not ops.frontier_hop(fr, nbr, msk).any()
    with pytest.raises(ValueError, match="CUDA"):
        ops.frontier_hop(fr, nbr, msk, use_kernel=True)
    assert kernel.launches.count == before
