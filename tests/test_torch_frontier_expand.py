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


# --------------------------------------------------------------------------
# The launch plan and a NumPy emulation of the CUDA mark's walk
# (csrc/frontier_expand.cu), held to the reference's Pallas kernel in
# interpret mode: each block's tiles, each warp's loads in the kernel's
# order, the branch-free search, and the warp's (value, mark) pair with the
# __any_sync skip.
from repro_torch.graph import generators  # noqa: E402
from repro_torch.graph.ell import csr_to_ell  # noqa: E402


def _member(s, x):
    """The kernel's branch-free lower-bound search, lane by lane."""
    c = len(s)
    base = np.zeros(len(x), np.int64)
    ln = c
    while ln > 1:
        half = ln >> 1
        base = np.where(s[base + half] < x, base + half, base)
        ln -= half
    pos = base + (s[base] < x)
    return ((pos < c) & (s[np.minimum(pos, c - 1)] == x)).astype(np.uint8)


def _emulate_mark(ws, cand, plan):
    """Returns the marks and the share of warp steps that issued a search."""
    q, c = ws.shape
    w = cand.shape[1]
    tiles = -(-w // kernel.TILE)
    out = np.full((q, w), 2, np.uint8)  # 2: not written yet
    steps = searched = 0
    lanes = np.arange(32)
    per_thread = [(v, j) for v in range(kernel.VECS) for j in range(4)] if plan.vec \
        else [(v, 0) for v in range(4 * kernel.VECS)]
    for qi in range(q):
        row = ws[qi]
        for bx in range(plan.blocks_per_q):
            for warp in range(kernel.THREADS // 32):
                cv, cm = int(row[c - 1]), 1  # the pair starts as (ws[q, C - 1], 1)
                tid = 32 * warp + lanes
                for t in range(bx, tiles, plan.blocks_per_q):
                    for v, j in per_thread:
                        if plan.vec:
                            base = t * kernel.TILE + 4 * (v * kernel.THREADS + tid)
                        else:
                            base = t * kernel.TILE + v * kernel.THREADS + tid
                        inn = base < w  # vec: the four of a load are in or out together
                        idx = base + j
                        x = np.where(inn, cand[qi, np.minimum(idx, w - 1)], cv).astype(np.int64)
                        differ = x != cv
                        m = np.full(32, cm, np.uint8)
                        steps += 1
                        if differ.any():  # __any_sync: else no search at all
                            searched += 1
                            m[differ] = _member(row, x[differ])
                            cv, cm = int(x[31]), int(m[31])
                        assert (out[qi, idx[inn]] == 2).all()
                        out[qi, idx[inn]] = m[inn]
    assert (out < 2).all()
    return out.astype(bool), searched / max(steps, 1)


def _hold_mark(ws, cand, cand_offset=0, sm=132, vec=None):
    q, w = cand.shape
    plan = kernel.mark_plan(q, w, (1 << 20) + 4 * cand_offset, 1 << 22, sm)
    if vec is not None:
        assert plan.vec == vec, plan
    got, share = _emulate_mark(ws, cand, plan)
    want = np.asarray(ref_ops.ws_member(jnp.asarray(ws), jnp.asarray(cand), use_kernel=True))
    np.testing.assert_array_equal(got, want.astype(bool))
    return share


def _citation_candidates(n=3000, c=64, q=3, seed=7):
    """A real hop's candidates: the workset after one hop of a citation
    graph's seeds and its C * K neighbour slots (prefix masks: each entry's
    live neighbours, then sentinel runs)."""
    from repro_torch.core.workset import build_workset

    ell = csr_to_ell(generators.citation_graph(n, seed=seed), device="cpu")
    seeds = torch.from_numpy(np.random.default_rng(seed).choice(n, (q, 3)).astype(np.int32))
    ws = build_workset(ell.nbr, ell.nbr_mask, seeds, max_hops=1, cap=c, use_kernel=False)
    cand = ops.hop_candidates(ws.ids, ell.nbr, ell.nbr_mask)
    return ws.ids.numpy(), cand.numpy(), n


def test_mark_plan():
    """The main path's mark (Q = 4, W = 2048 * 1016) on 132 SMs: 132 blocks
    a query, each walking 3-4 of its 508 tiles; small rows get one block;
    ragged or unaligned rows load one candidate at a time."""
    assert kernel.mark_plan(4, 2048 * 1016, 1 << 20, 1 << 22, 132) == kernel.MarkPlan(True, 132)
    assert kernel.mark_plan(1, 10, 1 << 20, 1 << 22, 132) == kernel.MarkPlan(False, 1)
    assert kernel.mark_plan(1000, 4096, 1 << 20, 1 << 22, 132) == kernel.MarkPlan(True, 1)
    assert not kernel.mark_plan(2, 4096, (1 << 20) + 4, 1 << 22, 132).vec
    assert not kernel.mark_plan(2, 4096, 1 << 20, (1 << 22) + 2, 132).vec
    for q, w in ((1, 1), (3, 4095), (4, 2048 * 1016), (7, 123_457)):
        plan = kernel.mark_plan(q, w, 1 << 20, 1 << 22, 132)
        tiles = -(-w // kernel.TILE)
        assert 1 <= plan.blocks_per_q <= tiles
        covered = sorted(t for b in range(plan.blocks_per_q)
                         for t in range(b, tiles, plan.blocks_per_q))
        assert covered == list(range(tiles))


def test_emulated_mark_on_citation_hop_candidates():
    """Prefix-mask candidates: most warp steps see only the sentinel and
    issue no search."""
    ws, cand, n = _citation_candidates()
    assert cand.shape[1] % 4 == 0 and (cand == n).mean() > 0.5
    share = _hold_mark(ws, cand, vec=True)
    assert share < 0.5, share
    assert _hold_mark(ws, cand, sm=1) == share  # one block a query walks every tile


def test_emulated_mark_with_one_lane_of_a_sentinel_run_changed():
    """One candidate inside a long sentinel run replaced, once by an id of
    the workset and once by an id outside it: the warp that holds it must
    search that lane alone and keep the cached mark for the others."""
    ws, cand, n = _citation_candidates(seed=8)
    runs = np.flatnonzero((cand[0, :-64] == n) & (cand[0, 64:] == n))
    at = int(runs[len(runs) // 2]) + 32
    for new in (int(ws[0, 0]), n - 1 if n - 1 not in ws[0] else n + 5):
        c2 = cand.copy()
        c2[0, at] = new
        _hold_mark(ws, c2, vec=True)


@pytest.mark.parametrize("k,c,offset,vec", [(13, 31, 0, False),  # K % 8 != 0, W % 4 != 0
                                             (16, 40, 1, False),  # an unaligned candidate view
                                             (24, 50, 0, True)])
def test_emulated_mark_on_random_masks(k, c, offset, vec):
    """Random non-prefix masks with live sentinel slots: candidates of every
    kind, in both load variants."""
    rng = np.random.default_rng(k + c)
    n = 700
    nbr = rng.integers(0, n + 1, (n, k)).astype(np.int32)
    msk = rng.random((n, k)) < 0.4
    ws = _sorted_workset(rng, 2, c, n, dups=True)
    cand = ops.hop_candidates(torch.from_numpy(ws), torch.from_numpy(nbr),
                              torch.from_numpy(msk)).numpy()
    cand = cand[:, offset:]  # a view `offset` candidates into the row
    _hold_mark(ws, np.ascontiguousarray(cand), cand_offset=offset, sm=2, vec=vec)
