"""Port ``topk_sim`` vs the reference: the port's plain version against the
Pallas kernel run in interpret mode (the way ``test_kernel_parity.py`` runs
it) and against the reference's ``ref.py``; the CUDA kernel's launch plan;
and a NumPy emulation of the kernel's walk (block ranges, the consumers'
reduction order, the running lists with their entry threshold, the tree
merge) held to the reference kernel's blocks and merge.

Ids must match exactly; scores within ``atol=1e-5``: both sides are fp32
dot products of unit vectors summed in a different order.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _topk_emulation import PAD, insert, key, merge_tree
from repro.kernels.topk_sim import kernel as ref_kernel
from repro.kernels.topk_sim import ops as ref_ops
from repro.kernels.topk_sim import ref as ref_ref
from repro_torch.kernels import build, topk_merge
from repro_torch.kernels.topk_sim import kernel, ops

ATOL = 1e-5
_BASE = 1 << 20  # a 16-byte aligned address the plans are asked about


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
    s_t, i_t = np.asarray(s_t), np.asarray(i_t)
    np.testing.assert_allclose(s_t, np.asarray(s_r), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(i_t, np.asarray(i_r))


# --------------------------------------------------------------------------
# A NumPy emulation of csrc/topk_sim.cu (the merge: tests/_topk_emulation.py).
def _lane_order_scores(qv, rows):
    """(Q, R) scores in the consumers' order: lane t (of a row's 8 lanes)
    sums its 16-byte units t, t + 8, ... (four fp32 FMAs a unit, emulated
    with exact products), then the butterfly's sum over the 8 lanes, a
    halving tree that pairs lanes 4, 2 and 1 apart."""
    d4 = kernel._ceil4(qv.shape[1])
    qp = np.zeros((qv.shape[0], d4), np.float32)
    qp[:, :qv.shape[1]] = qv
    ep = np.zeros((rows.shape[0], d4), np.float32)
    ep[:, :rows.shape[1]] = rows
    units = d4 // 4
    part = np.zeros((qv.shape[0], rows.shape[0], 8), np.float32)
    for u0 in range(0, units, 8):
        for t in range(4):
            cols = [4 * u + t for u in range(u0, min(u0 + 8, units))]
            lanes = len(cols)
            part[..., :lanes] = (part[..., :lanes].astype(np.float64)
                                 + ep[None, :, cols].astype(np.float64)
                                 * qp[:, None, cols].astype(np.float64)).astype(np.float32)
    for o in (4, 2, 1):
        part = part[..., :o] + part[..., o:2 * o]
    return part[..., 0]


def _emulate_topk_sim(qv, ev, k, plan, stats=None):
    """The kernel's walk for plan ``plan``: per query group, each block's
    tiles (the grid's even split), the consumers' scores in their order
    (``_lane_order_scores``), each batch of 32 rows offered to each query's
    list (the ballot of rows beating its last entry, then the insertions in
    row order; the kernel's bitonic merge of 4 or more of them at once
    leaves the same list: the best kk of the same entries); then the merge
    kernel: each query's lists, in block order, through the tree merge."""
    stats = {} if stats is None else stats
    q, d = qv.shape
    n = ev.shape[0]
    large = k > topk_merge.CAP
    assert plan.kk == (topk_merge.CAP if large else k) and 1 <= k <= n
    assert plan.qw in (1, 2, 4, 8) and plan.qw * kernel.CONSUMERS >= plan.group
    qsl, rsl = kernel.slices(plan.group, plan.qw)
    rows_t = kernel.tile_rows(d)
    n_tiles = -(-n // rows_t)
    scored = np.zeros((q, n), np.int64)
    out_s = np.full((q, k), np.nan, np.float32)
    out_i = np.full((q, k), -1, np.int64)
    for g in range(plan.groups):
        q0 = g * plan.group
        qn = min(plan.group, q - q0)
        assert qn >= 1
        block_lists = []
        for x in range(plan.grid_x):
            t0, t1 = x * n_tiles // plan.grid_x, (x + 1) * n_tiles // plan.grid_x
            assert t1 > t0
            if large:
                assert (t1 - t0) * rows_t <= topk_merge.CAP
            # a list for each (query, row slice): warp (rs, j // qw) owns it
            lists = [[[PAD] * plan.kk for _ in range(rsl)] for _ in range(qn)]
            for t in range(t0, t1):
                r0 = t * rows_t
                nr = min(rows_t, n - r0)
                sc = _lane_order_scores(qv[q0:q0 + qn], ev[r0:r0 + nr])
                for bi, b0 in enumerate(range(0, nr, kernel.BATCH)):
                    rs = bi % rsl  # the row slice that scores this batch
                    for j in range(qn):
                        assert rs * qsl + j // plan.qw < kernel.CONSUMERS  # the owning warp
                        scored[q0 + j, r0 + b0:r0 + min(nr, b0 + kernel.BATCH)] += 1
                        last = lists[j][rs][-1][0]
                        for r in range(b0, min(nr, b0 + kernel.BATCH)):  # lane r - b0
                            e = (key(sc[j, r], r0 + r), sc[j, r], r0 + r)
                            if e[0] > last:  # in the ballot
                                insert(lists[j][rs], e, stats)
            # the block merges its row slices' lists a query
            block_lists.append([merge_tree(lists[j], plan.kk, rsl * plan.kk)
                                for j in range(qn)])
        for j in range(qn):
            fin = merge_tree([lists[j] for lists in block_lists], k, plan.stride)
            out_s[q0 + j] = [e[1] for e in fin]
            out_i[q0 + j] = [e[2] for e in fin]
    assert (scored == 1).all()  # every row scored once for every query
    return out_s, out_i


def _hold(qv, ev, k, sm=132, stats=None, ptr=_BASE):
    """The emulation against the reference kernel (interpret mode) merged by
    its ``lax.top_k``, and against its plain ``ref.py``."""
    plan = kernel.launch_plan(qv.shape[0], ev.shape[0], ev.shape[1], k, ptr, sm)
    s_e, i_e = _emulate_topk_sim(qv, ev, k, plan, stats)
    c_blk = 256 if k > 256 else 1024
    s_k, i_k = ref_ops.topk_similarity(jnp.asarray(qv), jnp.asarray(ev), k, use_kernel=True,
                                       c_blk=c_blk)
    s_r, i_r = ref_ref.topk_similarity(jnp.asarray(qv), jnp.asarray(ev), k)
    _check(s_e, i_e, s_k, i_k)
    _check(s_e, i_e, s_r, i_r)
    return plan


# --------------------------------------------------------------------------
# N past, at and between multiples of the reference's 1024-column tile and
# the port kernel's 64-row tile
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
    # the kernel's walk keeps the same order, the copies in different blocks
    # (a block a 64-row tile at 39 SMs, or a few of them at 7)
    for sm in (39, 7):
        plan = kernel.launch_plan(2, 2500, 32, 6, _BASE, sm)
        assert plan.grid_x == sm
        s_m, i_m = _emulate_topk_sim(qv, ev, 6, plan)
        _check(s_m, i_m, s_k, i_k)


@pytest.mark.parametrize("n,k", [(1000, 4), (2100, 3), (300, 100)])
def test_tile_lists_match_reference_kernel_blocks(n, k):
    """Each block list of the kernel's walk holds the top k of its range:
    the reference kernel's ``topk_sim_blocks`` lists of the 64-row tiles in
    that range (finite entries), merged; and the walk's merge gives the
    reference's top k."""
    c_blk = kernel.tile_rows(24)
    qv, ev = _data(n + k, 8, n, 24)
    n_pad = -(-n // c_blk) * c_blk
    ep = np.zeros((n_pad, 128), np.float32)
    ep[:n, :24] = ev
    qp = np.zeros((8, 128), np.float32)
    qp[:, :24] = qv
    kt = min(k, c_blk)
    s_b, i_b = (np.asarray(a) for a in ref_kernel.topk_sim_blocks(
        jnp.asarray(qp), jnp.asarray(ep), k=kt, q_blk=8, c_blk=c_blk, n_valid=n, interpret=True))
    plan = kernel.launch_plan(8, n, 24, k, _BASE, 5)
    n_tiles = n_pad // c_blk
    # each block's list: the walk over that range alone, in one block
    for x in range(plan.grid_x):
        t0, t1 = x * n_tiles // plan.grid_x, (x + 1) * n_tiles // plan.grid_x
        r0, r1 = t0 * c_blk, min(n, t1 * c_blk)
        kx = min(k, r1 - r0)
        s_x, i_x = _emulate_topk_sim(qv, ev[r0:r1], kx, kernel.launch_plan(8, r1 - r0, 24, kx,
                                                                           _BASE, 1))
        fs, fi = s_b[:, t0:t1].reshape(8, -1), i_b[:, t0:t1].reshape(8, -1)
        for j in range(8):
            ok = np.isfinite(fs[j])
            order = np.lexsort((fi[j][ok], -fs[j][ok]))[:s_x.shape[1]]
            np.testing.assert_array_equal(i_x[j] + r0, fi[j][ok][order])
            np.testing.assert_allclose(s_x[j], fs[j][ok][order], atol=ATOL, rtol=0)
    s_m, i_m = _emulate_topk_sim(qv, ev, k, plan)
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


# ------------------------------------------------------------ the plan ----
def test_launch_plan_main_path():
    """The brute wave (Q = 4 over the 169,343 x 128 index, k = 3) on an H100
    (132 SMs): bulk copies of 64-row tiles, a block an SM of 20-21 tiles,
    a warp a query and one of a tile's two 32-row batches; the IVF recall
    shape (Q = 64, k = 32): 8 queries a warp, every batch, one group."""
    plan = kernel.launch_plan(4, 169_343, 128, 3, _BASE, 132)
    assert plan == kernel.ScanPlan(kernel.BULK, 1, 4, 1, 3, 132, 132 * 3)
    assert kernel.slices(4, 1) == (4, 2)  # a warp a query and one of a tile's two batches
    assert kernel.tile_rows(128) == 64 and kernel.stage_bytes(128) == 32_768
    smem = 4 * 32_768 + 4 * 128 * 4 + 2 * 4 * 2 * 3 * 8 + 16 * 4
    assert kernel.scan_smem_bytes(128, plan.group, plan.qw, plan.kk) == smem
    assert kernel.launch_plan(64, 169_343, 128, 32, _BASE, 132) == kernel.ScanPlan(
        kernel.BULK, 8, 64, 1, 32, 132, 132 * 32)
    assert kernel.slices(64, 8) == (8, 1)  # a warp 8 queries, every batch
    assert kernel.scan_smem_bytes(128, 64, 8, 32) <= kernel.SMEM_PER_BLOCK


def test_layout_constants_match_cuda_source():
    """The plan mirrors the kernel's constants and shared-memory layout, and
    the merge's capacity: the two sides must agree."""
    csrc = Path(kernel.__file__).parents[2] / "csrc"
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", (csrc / "topk_sim.cu").read_text()))
    pairs = (("CONSUMERS", "kConsumers"), ("MAX_TILE_ROWS", "kMaxTileRows"),
             ("TILE_BYTES", "kTileBytes"), ("BATCH", "kBatch"), ("LANE_ROWS", "kLaneRows"),
             ("STAGES", "kStages"), ("MAX_GROUP", "kMaxGroup"), ("GROUP_BYTES", "kGroupBytes"),
             ("STAGE_ALIGN", "kStageAlign"))
    assert {name: int(consts[c]) for name, c in pairs} == {
        name: getattr(kernel, name) for name, _ in pairs}
    merge = dict(re.findall(r"constexpr int (k\w+) = (\w+);", (csrc / "topk_merge.cuh").read_text()))
    assert int(merge["kCap"]) == topk_merge.CAP
    assert "__launch_bounds__(kThreads, 1)" in (csrc / "topk_sim.cu").read_text()
    assert kernel.BLOCKS_PER_SM == 1 and kernel.THREADS == 288


_PLAN_CASES = [(q, n, d, k) for q, n, d, k in [
    (1, 1, 8, 1), (4, 169_343, 128, 3), (64, 169_343, 128, 32), (9, 3000, 128, 3),
    (20, 5000, 96, 64), (4, 700, 1024, 300), (5, 1000, 3, 7), (1, 1000, 128, 256),
    (3, 1000, 128, 300), (65, 4000, 16, 10), (200, 50_000, 512, 100), (2, 64, 4, 64),
    (7, 257, 130, 257), (1, 169_343, 128, 169_343), (3, 2049, 40, 20), (8, 1300, 8192, 3),
    (1, 65, 12, 65), (12, 999, 256, 255)]]


@pytest.mark.parametrize("q,n,d,k", _PLAN_CASES)
def test_launch_plan_covers_every_row_once(q, n, d, k):
    """Every row lands in exactly one tile of one block and every query in
    one group; a warp's queries and the group's lists fit; ranges span at
    most 256 rows past k = 256; a tile stays within 32 KB and the shared
    memory fits a block; the scratch holds every merge level; bulk copies
    only for d % 4 == 0 and an aligned table."""
    for sm in (1, 3, 132):
        for ptr in (_BASE, _BASE + 4):
            plan = kernel.launch_plan(q, n, d, k, ptr, sm)
            assert plan.variant == (kernel.BULK if d % 4 == 0 and ptr % 16 == 0
                                    else kernel.PLAIN)
            assert plan.kk == min(k, 256) and plan.qw in (1, 2, 4, 8)
            assert plan.qw == min(8, 1 << (-(-plan.group // 4) - 1).bit_length())
            qsl, rsl = kernel.slices(plan.group, plan.qw)
            assert 1 <= qsl * rsl <= kernel.CONSUMERS and rsl >= 1
            assert qsl * plan.qw * -(-d // 4) * 16 <= kernel.GROUP_BYTES
            assert plan.group * rsl * plan.kk * 8 <= kernel.GROUP_BYTES
            assert kernel.scan_smem_bytes(d, plan.group, plan.qw, plan.kk) <= kernel.SMEM_PER_BLOCK
            assert (plan.groups - 1) * plan.group < q <= plan.groups * plan.group
            rows = kernel.tile_rows(d)
            assert 1 <= rows <= 64 and rows * -(-d // 4) * 16 <= kernel.TILE_BYTES
            n_tiles = -(-n // rows)
            assert 1 <= plan.grid_x <= min(n_tiles, max(sm, -(-n_tiles // (256 // rows))))
            seen = np.zeros(n, np.int64)
            for x in range(plan.grid_x):
                t0, t1 = x * n_tiles // plan.grid_x, (x + 1) * n_tiles // plan.grid_x
                r0, r1 = t0 * rows, min(n, t1 * rows)
                assert r1 > r0
                seen[r0:r1] += 1
                if k > 256:
                    assert r1 - r0 <= 256
            assert (seen == 1).all()
            assert plan.stride == topk_merge.merge_stride(plan.grid_x, plan.kk, k)


@pytest.mark.parametrize("n,length,k", [(1, 3, 3), (2, 3, 3), (132, 3, 3), (662, 256, 300),
                                        (5, 256, 1000), (3, 256, 700), (7, 1, 5)])
def test_merge_stride_holds_every_level(n, length, k):
    s = topk_merge.merge_stride(n, length, k)
    lists, size, most = n, length, n * length
    while lists > 1:
        lists, size = -(-lists // 2), min(2 * size, k)
        most = max(most, lists * size)
    assert s == most >= n * length and size == min(k, n * length)


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="k="):
        kernel.launch_plan(1, 10, 8, 11, _BASE, 132)
    with pytest.raises(ValueError, match="width"):
        kernel.launch_plan(1, 10, 8200, 3, _BASE, 132)
    assert kernel.launch_plan(1, 10, 8192, 3, _BASE, 132).group == 1


def test_build_tag_hashes_the_shared_header(monkeypatch, tmp_path):
    """An edited topk_merge.cuh must not load a library built from the old
    one: the build's tag hashes it."""
    for name in build.SOURCES + build.HEADERS:
        (tmp_path / name).write_bytes((build.CSRC / name).read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build._tag()
    (tmp_path / "topk_merge.cuh").write_bytes(
        (tmp_path / "topk_merge.cuh").read_bytes() + b"\n// edited\n")
    assert build._tag() != before
    assert "topk_merge.cuh" in build.HEADERS
    for src in ("topk_sim.cu", "ivf_scan.cu"):
        assert '#include "topk_merge.cuh"' in (build.CSRC / src).read_text()


# ---------------------------------------------------- the kernel's walk ----
@pytest.mark.parametrize("q,n,d,k,sm", [
    (4, 1300, 128, 3, 132),  # the serving shape, cut: one tile a block
    (4, 1300, 128, 3, 3),  # few SMs: each block walks many tiles
    (1, 1, 8, 1, 132),  # N = 1
    (5, 1000, 24, 7, 132),
    (9, 2049, 40, 20, 4),  # two query slots a warp
    (3, 700, 16, 64, 132),  # ranges widened to 4 k rows
    (2, 600, 16, 256, 132),  # k at the list capacity
    (2, 700, 16, 300, 132),  # k past it: the tree merge
    (1, 300, 8, 300, 2),  # k = N past the capacity
    (66, 600, 8, 5, 7),  # two query groups
    (9, 300, 1030, 3, 2),  # 7-row tiles of two unit groups a lane; query groups of 7
])
def test_emulated_scan_matches_reference(q, n, d, k, sm):
    qv, ev = _data(q * n + k, q, n, d)
    stats = {}
    plan = _hold(qv, ev, k, sm=sm, stats=stats)
    assert stats["inserts"] >= min(k, n) * q  # every list filled at least once


def test_emulated_scan_odd_width_plain_variant():
    """D % 4 != 0 (an emb[:, :3] view made contiguous) and an unaligned
    table take the plain-load variant of the same walk."""
    qv, ev = _data(7, 3, 800, 3)
    plan = _hold(qv, ev, 5, sm=4, ptr=_BASE)
    assert plan.variant == kernel.PLAIN
    assert kernel.launch_plan(3, 800, 8, 5, _BASE + 4, 4).variant == kernel.PLAIN


@pytest.mark.parametrize("sm", [132, 7, 3])
def test_emulated_ties_across_block_boundaries(sm):
    """Copies of one row on both sides of every block boundary and in the
    last block: equal scores come out lowest id first; a query of zeros
    ties every row."""
    n = 1500
    qv, ev = _data(11, 3, n, 16)
    plan = kernel.launch_plan(3, n, 16, 8, _BASE, sm)
    n_tiles = -(-n // 64)
    cuts = [x * n_tiles // plan.grid_x * 64 for x in range(1, plan.grid_x)]
    dup = sorted({0, n - 1, *[c for c in cuts if c < n], *[c - 1 for c in cuts]})[:12]
    ev[dup] = ev[dup[0]]
    qv[0] = ev[dup[0]]
    qv[1] = 0.0
    s, i = _emulate_topk_sim(qv, ev, 8, plan)
    s_r, i_r = ref_ref.topk_similarity(jnp.asarray(qv), jnp.asarray(ev), 8)
    _check(s, i, s_r, i_r)
    assert i[0, :min(8, len(dup))].tolist() == dup[:8]
    assert i[1].tolist() == list(range(8))
