"""Port ``frontier_expand`` vs the reference: the plain membership mark
against the reference's Pallas kernel in interpret mode and its ``ref.py``,
and both arms of ``expand_hop`` against the reference's both arms, on the
same numpy-made inputs.  All outputs are integer or bool: exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.frontier_expand import ops as ref_ops
from repro.kernels.frontier_expand import ref as ref_ref
from repro_torch.kernels.frontier_expand import kernel, ops, ref

I32_MAX = np.iinfo(np.int32).max


def _sorted_workset(rng, q, c, n, dups=False):
    """Ascending workset rows with sentinel-n padding; with ``dups`` some
    ids repeat inside a row."""
    ws = np.full((q, c), n, np.int32)
    for qi in range(q):
        fill = int(rng.integers(1, c + 1))
        ids = rng.choice(n, size=min(fill, n), replace=False)
        if dups:
            ids = np.concatenate([ids, ids[: len(ids) // 3]])[:fill]
        ws[qi, : len(ids)] = np.sort(ids)
    return ws


def _member_all(ws, cand):
    want = np.asarray(ref_ops.ws_member(jnp.asarray(ws), jnp.asarray(cand), use_kernel=True))
    np.testing.assert_array_equal(
        want, np.asarray(ref_ref.ws_member(jnp.asarray(ws), jnp.asarray(cand))))
    got = ops.ws_member(torch.from_numpy(ws), torch.from_numpy(cand))
    assert got.dtype == torch.bool and got.shape == cand.shape
    np.testing.assert_array_equal(got.numpy(), want)
    return want


@pytest.mark.parametrize("trial", range(3))
def test_ws_member_matches_reference_kernel(trial):
    rng = np.random.default_rng(200 + trial)
    q = int(rng.integers(1, 5))
    c = int(rng.integers(16, 300))
    n = int(rng.integers(c, 4000))
    w = int(rng.integers(10, 5000))
    ws = _sorted_workset(rng, q, c, n)
    _member_all(ws, rng.integers(0, n + 1, (q, w)).astype(np.int32))


@pytest.mark.parametrize("c", [1, 2, 7, 100, 257])
def test_ws_member_edge_cases(c):
    """Duplicate ids in a row, candidates equal to the sentinel (which match
    a sentinel slot), int32 max, C = 1 and C not a power of two, and a
    ragged W."""
    rng = np.random.default_rng(c)
    n = 500
    ws = _sorted_workset(rng, 3, c, n, dups=True)
    ws[2] = n  # a row of sentinels only
    w = 1001  # not a multiple of 4 or of any tile
    cand = rng.integers(0, n + 1, (3, w)).astype(np.int32)
    cand[:, :5] = n
    cand[:, 5:9] = I32_MAX
    cand[:, 9:12] = ws[:, :1]  # the row's first id
    cand[:, 12:15] = ws[:, -1:]  # and its last
    got = _member_all(ws, cand)
    assert got[2, :5].all() and not got[:, 5:9].any() and got[:, 9:15].all()


def test_ws_member_no_candidates():
    out = ops.ws_member(torch.zeros((2, 4), dtype=torch.int32), torch.zeros((2, 0), dtype=torch.int32))
    assert out.shape == (2, 0) and out.dtype == torch.bool


@pytest.mark.parametrize("trial", range(3))
def test_expand_hop_both_arms_match_reference(trial):
    """Port sort arm, port mark arm (plain ws_member on the CPU), reference
    sort arm and reference kernel arm (interpret mode): bit-identical."""
    rng = np.random.default_rng(300 + trial)
    n = int(rng.integers(100, 800))
    k = int(rng.integers(1, 10))
    q = int(rng.integers(1, 4))
    c = int(rng.integers(8, 64))
    nbr = rng.integers(0, n + 1, (n, k)).astype(np.int32)
    msk = rng.random((n, k)) < 0.7
    ws = _sorted_workset(rng, q, c, n)
    dist = np.where(ws < n, rng.integers(0, 3, (q, c)), ops.INF).astype(np.int32)
    jargs = (jnp.asarray(ws), jnp.asarray(dist), jnp.asarray(nbr), jnp.asarray(msk), 3)
    targs = (torch.from_numpy(ws), torch.from_numpy(dist), torch.from_numpy(nbr),
             torch.from_numpy(msk), 3)
    want = ref_ops.expand_hop(*jargs, band=6, use_kernel=False)
    want_k = ref_ops.expand_hop(*jargs, band=6, use_kernel=True)
    before = kernel.launches.count
    for use_kernel in (None, False, True):
        got = ops.expand_hop(*targs, band=6, use_kernel=use_kernel)
        for a, b, ak, name in zip(want, got, want_k, ("ids", "dist", "fresh", "dropped")):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(ak), err_msg=name)
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"{name} {use_kernel}")
    assert kernel.launches.count == before  # the CPU never launches


def test_expand_hop_overflow_keeps_lowest_fresh_ids():
    """A one-slot-wide workset overflows on its first hop in both arms and in
    the reference, keeping the lowest ids."""
    n = 40
    nbr = np.array([[(i + d) % n for d in (1, 2, 3)] for i in range(n)], np.int32)
    msk = np.ones_like(nbr, bool)
    ws = np.array([[5, 9, n, n]], np.int32)
    dist = np.array([[0, 0, ops.INF, ops.INF]], np.int32)
    want = ref_ops.expand_hop(jnp.asarray(ws), jnp.asarray(dist), jnp.asarray(nbr),
                              jnp.asarray(msk), 1, band=3, use_kernel=False)
    for use_kernel in (False, True):
        got = ops.expand_hop(torch.from_numpy(ws), torch.from_numpy(dist), torch.from_numpy(nbr),
                             torch.from_numpy(msk), 1, band=3, use_kernel=use_kernel)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert got[3].tolist() == [True] and got[0].tolist() == [[5, 6, 7, 9]]


def test_expand_hop_refuses_keys_past_int32():
    ws = torch.zeros((1, 2), dtype=torch.int32)
    nbr = torch.zeros((1, 1), dtype=torch.int32).expand(2**29, 1)  # no memory behind it
    msk = torch.ones((1, 1), dtype=torch.bool).expand(2**29, 1)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        ops.expand_hop(ws, ws, nbr, msk, 1, band=5)


def test_cpu_takes_plain_version_and_kernel_needs_a_card():
    ws = torch.tensor([[1, 3, 5]], dtype=torch.int32)
    cand = torch.tensor([[0, 1, 2, 3, 4, 5, 6]], dtype=torch.int32)
    before = kernel.launches.count
    assert ops.ws_member(ws, cand).tolist() == [[False, True, False, True, False, True, False]]
    assert torch.equal(ops.ws_member(ws, cand, use_kernel=False), ref.ws_member(ws, cand))
    with pytest.raises(ValueError, match="CUDA"):
        ops.ws_member(ws, cand, use_kernel=True)
    assert kernel.launches.count == before
