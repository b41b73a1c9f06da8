"""Port ``topk_sim`` vs the reference: the port's plain version against the
Pallas kernel run in interpret mode (the way ``test_kernel_parity.py`` runs
it) and against the reference's ``ref.py``; the kernel's per-tile output
layout and the port's tile merge against the reference kernel's blocks.

Ids must match exactly; scores within ``atol=1e-5``: both sides are fp32
dot products of unit vectors summed in a different order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.topk_sim import kernel as ref_kernel
from repro.kernels.topk_sim import ops as ref_ops
from repro.kernels.topk_sim import ref as ref_ref
from repro_torch.kernels.topk_sim import kernel, ops, ref

ATOL = 1e-5


def _data(seed, q, n, d, dup=()):
    rng = np.random.default_rng(seed)
    qv = rng.standard_normal((q, d)).astype(np.float32)
    ev = rng.standard_normal((n, d)).astype(np.float32)
    for i in dup:
        ev[i] = ev[dup[0]]
    # unit rows, as the brute index stores them (scores in [-1, 1])
    qv /= np.linalg.norm(qv, axis=1, keepdims=True)
    ev /= np.linalg.norm(ev, axis=1, keepdims=True)
    return qv, ev


def _check(s_t, i_t, s_r, i_r):
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_r), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_r))


# N past, at and between multiples of the reference's 1024-column tile and
# the port kernel's 256-row tile
@pytest.mark.parametrize("q,n,d,k", [(3, 2500, 64, 5), (1, 3072, 128, 3),
                                     (7, 2049, 40, 20), (4, 1300, 128, 3)])
def test_plain_matches_reference_kernel(q, n, d, k):
    qv, ev = _data(n, q, n, d)
    s_k, i_k = ref_ops.topk_similarity(jnp.asarray(qv), jnp.asarray(ev), k, use_kernel=True)
    s_r, i_r = ref_ref.topk_similarity(jnp.asarray(qv), jnp.asarray(ev), k)
    s_t, i_t = ops.topk_similarity(torch.from_numpy(qv), torch.from_numpy(ev), k)
    assert i_t.dtype == torch.int32 and s_t.dtype == torch.float32
    _check(s_t, i_t, s_k, i_k)
    _check(s_t, i_t, s_r, i_r)


def test_duplicate_rows_lowest_id_first():
    dup = (3, 5, 1500, 2400)  # spans three of the reference's tiles
    qv, ev = _data(1, 2, 2500, 32, dup=dup)
    qv[0] = ev[3]
    s_k, i_k = ref_ops.topk_similarity(jnp.asarray(qv), jnp.asarray(ev), 6, use_kernel=True)
    s_t, i_t = ops.topk_similarity(torch.from_numpy(qv), torch.from_numpy(ev), 6)
    assert i_t[0, :4].tolist() == list(dup)
    _check(s_t, i_t, s_k, i_k)
    # the kernel path's tile lists + merge keep the same order
    tiles = ref.topk_sim_tiles(torch.from_numpy(qv), torch.from_numpy(ev), 6, kernel.C_BLK)
    s_m, i_m = ops.merge_tiles(*tiles, 6)
    _check(s_m, i_m, s_k, i_k)


@pytest.mark.parametrize("n,k", [(1000, 4), (2100, 3), (300, 100)])
def test_tile_lists_match_reference_kernel_blocks(n, k):
    """``ref.topk_sim_tiles`` is the CUDA kernel's output in plain PyTorch:
    the same per-tile lists (scores, global ids, -inf padding) as the
    reference kernel's ``topk_sim_blocks`` at the same tile size."""
    c_blk = 256
    qv, ev = _data(n + k, 8, n, 24)
    n_pad = -(-n // c_blk) * c_blk
    ep = np.zeros((n_pad, 128), np.float32)
    ep[:n, :24] = ev
    qp = np.zeros((8, 128), np.float32)
    qp[:, :24] = qv
    s_b, i_b = ref_kernel.topk_sim_blocks(jnp.asarray(qp), jnp.asarray(ep), k=k, q_blk=8,
                                          c_blk=c_blk, n_valid=n, interpret=True)
    s_t, i_t = ref.topk_sim_tiles(torch.from_numpy(qv), torch.from_numpy(ev), k, c_blk)
    assert s_t.shape == s_b.shape
    s_b = np.asarray(s_b)
    finite = np.isfinite(s_b)
    np.testing.assert_array_equal(np.isfinite(s_t.numpy()), finite)
    np.testing.assert_allclose(s_t.numpy()[finite], s_b[finite], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_b))
    s_m, i_m = ops.merge_tiles(s_t, i_t, k)
    s_r, i_r = ref_ref.topk_similarity(jnp.asarray(qv), jnp.asarray(ev), k)
    _check(s_m, i_m, s_r, i_r)


def test_cpu_takes_plain_version_and_kernel_needs_a_card():
    qv, ev = _data(0, 2, 300, 16)
    q, e = torch.from_numpy(qv), torch.from_numpy(ev)
    before = kernel.launches.count
    ops.topk_similarity(q, e, 3)
    assert kernel.launches.count == before
    with pytest.raises(ValueError, match="CUDA"):
        ops.topk_similarity(q, e, 3, use_kernel=True)
    assert kernel.launches.count == before
