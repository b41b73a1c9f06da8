"""Port ``ell_spmm`` vs the reference: the port's plain ``ell_aggregate``
(the function a CPU tensor takes and the card's kernel is held to bit for
bit) against the reference's Pallas kernel run in interpret mode
(``use_kernel=True``, as ``tests/test_kernels.py`` runs it) and against its
``ref.py``, on the same numpy inputs.

Tolerances: fp32 within ``atol = rtol = 1e-5`` (the same fp32 terms summed
in another order: the port adds the slots one after another, the
reference's ``ref`` sums them with ``jnp.sum``); bf16 within one bf16 ulp
(``rtol = 2**-7``, plus ``atol = 2**-7 * max|ref|`` for sums that cancel
near zero), since both sides round an fp32 sum to bf16 once.  Masks and
sentinel handling are exact: a sum of no live slot is 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ell_spmm import ops as ref_ops
from repro.kernels.ell_spmm import ref as ref_ref
from repro_torch.kernels.ell_spmm import ops, ref

ATOL = RTOL = 1e-5


def _data(seed, q, m, k, d, p=0.7, hi=None):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((q, m, d)).astype(np.float32)
    nbr = rng.integers(0, (m + 1) if hi is None else hi, (q, m, k)).astype(np.int32)
    msk = rng.random((q, m, k)) < p
    return feat, nbr, msk


def _port(feat, nbr, msk, dtype=torch.float32):
    out = ops.ell_aggregate(torch.from_numpy(feat).to(dtype), torch.from_numpy(nbr),
                            torch.from_numpy(msk))
    assert out.dtype == dtype and out.shape == feat.shape
    return out.float().numpy()


def _reference(feat, nbr, msk, use_kernel=True, dtype=jnp.float32):
    args = (jnp.asarray(feat, dtype), jnp.asarray(nbr), jnp.asarray(msk))
    if use_kernel:
        return np.asarray(ref_ops.ell_aggregate(*args, use_kernel=True), np.float32)
    return np.asarray(ref_ref.ell_aggregate(*args), np.float32)


# the four sweep shapes of tests/test_kernels.py (D = 48 and 200 are not
# multiples of the kernel's 128-column slab)
@pytest.mark.parametrize("q,m,k,d", [(1, 64, 8, 32), (3, 100, 12, 48), (8, 256, 16, 128),
                                     (2, 50, 4, 200)])
def test_plain_matches_reference_kernel_and_ref(q, m, k, d):
    feat, nbr, msk = _data(m * k + d, q, m, k, d)
    got = _port(feat, nbr, msk)
    np.testing.assert_allclose(got, _reference(feat, nbr, msk), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, _reference(feat, nbr, msk, use_kernel=False),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("trial", range(3))
def test_plain_matches_reference_kernel_random_shapes(trial):
    rng = np.random.default_rng(300 + trial)
    q, m = int(rng.integers(1, 5)), int(rng.integers(20, 200))
    k, d = int(rng.integers(2, 12)), int(rng.integers(8, 96))
    feat, nbr, msk = _data(trial, q, m, k, d, p=0.6)
    np.testing.assert_allclose(_port(feat, nbr, msk), _reference(feat, nbr, msk),
                               atol=ATOL, rtol=RTOL)


def test_plain_matches_segment_sum():
    """The edge-list formulation: every live (row, slot) adds its
    neighbour's row into the row's sum."""
    q, m, k, d = 2, 40, 6, 16
    feat, nbr, msk = _data(9, q, m, k, d, p=0.8, hi=m)
    got = _port(feat, nbr, msk)
    for qi in range(q):
        rows, slots = np.nonzero(msk[qi])
        expect = np.zeros((m, d), np.float64)
        np.add.at(expect, rows, feat[qi, nbr[qi, rows, slots]])
        np.testing.assert_allclose(got[qi], expect, atol=ATOL, rtol=RTOL)


def test_sentinel_ids_and_dead_rows():
    """id = M with its mask set, ids past M, all-masked rows, M = 1, K = 1:
    a slot counts only when its mask is set and its id is below M."""
    feat, nbr, msk = _data(4, 3, 30, 5, 24)
    nbr[:, :, 0] = 30  # the sentinel, mask set
    nbr[:, :, 1] = 30 + np.arange(30)[None, :] + 1  # past the sentinel
    msk[:, :, :2] = True
    msk[1, 7] = False  # an all-masked row
    msk[2] = False  # an all-masked query
    got = _port(feat, nbr, msk)
    assert np.all(got[1, 7] == 0) and np.all(got[2] == 0)
    live = msk & (nbr < 30)
    want = np.einsum("qmk,qmkd->qmd", live, feat[np.arange(3)[:, None, None], np.minimum(nbr, 29)])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, _reference(feat, nbr, msk), atol=ATOL, rtol=RTOL)
    for q, m, k, d in ((2, 1, 3, 8), (3, 17, 1, 40)):
        f, n, mk = _data(q * m, q, m, k, d)
        np.testing.assert_allclose(_port(f, n, mk), _reference(f, n, mk), atol=ATOL, rtol=RTOL)


def test_bf16_within_one_ulp_of_the_reference():
    feat, nbr, msk = _data(5, 4, 64, 16, 48)
    got = _port(feat, nbr, msk, dtype=torch.bfloat16)
    want = _reference(feat, nbr, msk, use_kernel=False, dtype=jnp.bfloat16)
    np.testing.assert_allclose(got, want, rtol=2**-7, atol=2**-7 * np.abs(want).max())
    np.testing.assert_allclose(got, _reference(feat, nbr, msk, dtype=jnp.bfloat16),
                               rtol=2**-7, atol=2**-7 * np.abs(want).max())


def test_plain_sums_slots_in_order():
    """The plain version adds the slots one after another in fp32 (the
    order the card's kernel is held to bit for bit)."""
    feat, nbr, msk = _data(6, 2, 33, 7, 20)
    f = np.concatenate([feat, np.zeros((2, 1, 20), np.float32)], 1)
    acc = np.zeros((2, 33, 20), np.float32)
    for kk in range(7):
        g = f[np.arange(2)[:, None], np.minimum(nbr[:, :, kk], 33)]
        acc = acc + np.where(msk[:, :, kk, None], g, np.float32(0))
    got = ref.ell_aggregate(torch.from_numpy(feat), torch.from_numpy(nbr), torch.from_numpy(msk))
    np.testing.assert_array_equal(got.numpy(), acc)


def test_kernel_wrapper_refuses_cpu_tensors():
    feat, nbr, msk = _data(1, 1, 4, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ops.ell_aggregate(torch.from_numpy(feat), torch.from_numpy(nbr), torch.from_numpy(msk),
                          use_kernel=True)
