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


# --------------------------------------------------------------------------
# The launch plan and a NumPy emulation of the CUDA hop's walk
# (csrc/bfs_frontier.cu), held to the reference's Pallas kernel in interpret
# mode.  The emulation follows the kernels step for step: the packed
# frontier (a word of query bits a node); for the bulk variant each tile's
# scan into its live-chunk bitmap and the probers' walk of it; for the row
# variants each lane's slots.
_BASE = 1 << 20  # a 16-byte aligned address the tests offset the mask from


def _pack(fr):
    """(Q, N) bool -> (ceil(Q / 32), N) uint32: bit j of word [g, v] is
    query 32 g + j's frontier bit at node v."""
    q, n = fr.shape
    groups = -(-q // 32)
    pad = np.zeros((32 * groups, n), np.uint64)
    pad[:q] = fr
    shifts = np.arange(32, dtype=np.uint64)[None, :, None]
    return (pad.reshape(groups, 32, n) << shifts).sum(1).astype(np.uint32)


def _probe(wg, ids, n):
    """Each id's word of query bits in its group's packed frontier; ids
    outside [0, N), the sentinel among them, read 0."""
    ok = (ids >= 0) & (ids < n)
    return np.where(ok, wg[np.where(ok, ids, 0)], 0).astype(np.uint32)


def _emulate_bulk(words, fm, fn, n, k, q, plan, mask_offset, out, stats):
    """The bulk kernel: the producer's tiles and bulk copies (starts and sizes
    checked against 16 bytes), each scanner warp's slice and its ballots OR-ed
    into the tile's live-chunk bitmap (each bit set once), then each prober
    warp's bitmap words, their list of live chunks, and a lane a chunk: its
    bytes from device memory (8 for the mask's last chunk when N K = 8 mod
    16), the live slots' ids and words of query bits for every query group,
    OR-ed per row (at most two a chunk); stores 1 on hits."""
    rows, tiles = plan.rows, -(-n // plan.rows)
    rows_w = rows // kernel.SCANNERS
    tw = kernel.tile_words(rows, k)
    assert rows % (2 * kernel.SCANNERS) == 0 and 1 <= plan.grid_x <= tiles
    live_chunks = 0
    for x in range(plan.grid_x):
        for tile in range(x, tiles, plan.grid_x):
            r0 = tile * rows
            nr = min(rows, n - r0)
            nbytes, copied = nr * k, (nr * k) & ~15
            assert (mask_offset + r0 * k) % 16 == 0 and copied % 16 == 0
            assert copied <= kernel.stage_bytes(rows, k) and nbytes - copied in (0, 8)
            tm = fm[r0 * k:r0 * k + nbytes]  # the stage, and the 8 bytes read directly
            bm = np.zeros(tw + 1, np.int64)
            set_count = np.zeros(32 * (tw + 1), np.int64)
            for warp in range(kernel.SCANNERS):
                w0 = warp * rows_w
                wr = max(0, min(rows_w, nr - w0))
                ob = w0 * k  # the slice's first byte in the tile: a multiple of 16
                assert ob % 16 == 0
                nch = -(-wr * k // 16)
                for c0 in range(0, nch, 32):
                    bits = 0
                    for lane in range(min(32, nch - c0)):
                        o0 = ob + 16 * (c0 + lane)
                        bits |= int(tm[o0:o0 + 16].any()) << lane
                    if bits:
                        g = ob // 16 + c0
                        set_count[g:g + 32] += (bits >> np.arange(32)) & 1
                        bm[g >> 5] |= (bits << (g & 31)) & 0xFFFFFFFF
                        bm[(g >> 5) + 1] |= bits >> (32 - (g & 31)) if g & 31 else 0
            chunks = -(-nbytes // 16)
            want = np.array([tm[16 * c:16 * c + 16].any() for c in range(chunks)])
            assert np.array_equal(set_count[:chunks], want.astype(np.int64))
            assert not set_count[chunks:].any() and not bm[tw:].any()
            live_chunks += int(want.sum())
            for pw in range(kernel.PROBERS):
                for wb in range(pw * kernel.PROBE_WORDS, tw, kernel.PROBERS * kernel.PROBE_WORDS):
                    lst = [32 * wi + bit for wi in range(wb, min(wb + kernel.PROBE_WORDS, tw))
                           for bit in range(32) if (bm[wi] >> bit) & 1]
                    for ct in lst:
                        o = 16 * ct  # the chunk's first byte in the tile
                        b = np.flatnonzero(tm[o:min(o + 16, nbytes)])
                        row, col = o // k, o - (o // k) * k
                        r = row + (col + b >= k)  # a chunk spans at most two rows
                        assert np.array_equal(r, (o + b) // k)
                        ids = fn[r0 * k + o + b]
                        for y in range(plan.groups):
                            hit = _probe(words[y], ids, n)
                            for j in range(min(kernel.QUERY_GROUP, q - 32 * y)):
                                out[32 * y + j, r0 + r[((hit >> j) & 1).astype(bool)]] = 1
    stats["live_chunks"] = live_chunks


def _emulate_hop(fr, nbr, msk, plan, mask_offset=0, stats=None):
    stats = {} if stats is None else stats
    q, n = fr.shape
    k = nbr.shape[1]
    words = _pack(fr)
    fm = msk.reshape(-1).view(np.uint8)
    fn = nbr.reshape(-1)
    assert plan.groups == -(-q // kernel.QUERY_GROUP)
    if plan.variant == kernel.BULK:
        out = np.full((q, n), 0xAB, np.uint8)  # torch.empty: anything
        # the pack kernel's threads (a group and a node each) zero the reach
        for y in range(plan.groups):
            out[kernel.QUERY_GROUP * y:kernel.QUERY_GROUP * (y + 1)] = 0
        _emulate_bulk(words, fm, fn, n, k, q, plan, mask_offset, out, stats)
        return out.astype(bool)
    # the row variants: a warp a row; lanes cover the slots once, 8 or 1 at a time
    assert plan.grid_x * plan.rows >= n
    width = 8 if plan.variant == kernel.ROWS8 else 1
    starts = [c for lane in range(32) for c in range(lane * width, k, 32 * width)]
    assert sorted(c + j for c in starts for j in range(width)) == list(range(k))
    if width == 8:
        assert all((mask_offset + c) % 8 == 0 for c in starts) and k % 8 == 0
    out = np.zeros((q, n), np.uint8)
    i, c = np.nonzero(msk)
    for y in range(plan.groups):
        q0 = kernel.QUERY_GROUP * y
        qn = min(kernel.QUERY_GROUP, q - q0)
        acc = np.zeros(n, np.uint32)
        np.bitwise_or.at(acc, i, _probe(words[y], nbr[i, c], n))
        out[q0:q0 + qn] = (acc[None] >> np.arange(qn, dtype=np.uint32)[:, None]) & 1
    return out.astype(bool)


def _hold_emulation(fr, nbr, msk, sm=132, mask_offset=0, variant=None):
    """The emulation against the reference's Pallas kernel in interpret
    mode; past K = 1024 slots (minutes to trace there) against its plain
    ``ref.py``, which the other tests hold to the kernel."""
    q, n = fr.shape
    plan = kernel.launch_plan(q, n, nbr.shape[1], _BASE + mask_offset, _BASE, sm)
    if variant is not None:
        assert plan.variant == variant, plan
    stats = {}
    got = _emulate_hop(fr, nbr, msk, plan, mask_offset, stats)
    args = (jnp.asarray(fr), jnp.asarray(nbr), jnp.asarray(msk))
    want = np.asarray(ref_ops.frontier_hop(*args, use_kernel=True) if nbr.shape[1] <= 1024
                      else ref_ref.frontier_hop(*args))
    np.testing.assert_array_equal(got, want.astype(bool))
    return stats


def test_launch_plan_main_path():
    """The main path's hop (Q = 4 over the 169,343-node ELL, K = 1016) on an
    H100 (132 SMs): 32-row tiles of 32,512 bytes, two stages, two blocks
    an SM."""
    plan = kernel.launch_plan(4, 169_343, 1016, _BASE, _BASE, 132)
    assert plan == kernel.HopPlan(kernel.BULK, 32, 264, 1)
    smem = 2 * 32_512 + 4 * 4 * 64 + 4 * 8 * 32 * 8 + 16 * (2 + 4)
    assert kernel.bulk_smem_bytes(plan.rows, 1016) == smem
    assert 2 * (smem + kernel.SMEM_RESERVED) <= kernel.SMEM_PER_SM


def test_layout_constants_match_cuda_source():
    """The plan mirrors the bulk kernel's shared-memory layout, whose C
    constants the entry point computes it from: the two must agree."""
    import re
    from pathlib import Path

    src = (Path(kernel.__file__).parents[2] / "csrc" / "bfs_frontier.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert {name: int(consts[c]) for name, c in (
        ("STAGES", "kStages"), ("SCANNERS", "kScanners"), ("PROBERS", "kProbers"),
        ("BITMAPS", "kBitmaps"), ("PROBE_WORDS", "kProbeWords"), ("STAGE_ALIGN", "kStageAlign"),
        ("QUERY_GROUP", "kQG"), ("THREADS", "kThreads"))} == {
        name: getattr(kernel, name) for name in ("STAGES", "SCANNERS", "PROBERS", "BITMAPS",
                                                 "PROBE_WORDS", "STAGE_ALIGN", "QUERY_GROUP",
                                                 "THREADS")}
    assert "__launch_bounds__(kHopThreads, 2)" in src and kernel.BLOCKS_PER_SM == 2


@pytest.mark.parametrize("q", [1, 4, 32, 33, 64, 100])
@pytest.mark.parametrize("n,k,offset", [(169_343, 1016, 0), (1501, 24, 0), (1000, 40, 0),
                                        (7, 8, 0), (5000, 16, 16), (3000, 8, 8),
                                        (3000, 1016, 1), (2000, 13, 0), (4, 30_000, 0),
                                        (3, 120_000, 0), (10, 0, 0)])
def test_launch_plan_covers_every_row_once(q, n, k, offset):
    """Every row lands in exactly one tile of one block; bulk copies start
    and span multiples of 16 bytes (bar the last tile's 8 direct bytes);
    the stages fit in a block's 227 KB; Q > 32 runs in groups of 32."""
    for sm in (1, 3, 132):
        plan = kernel.launch_plan(q, n, k, _BASE + offset, _BASE, sm)
        assert plan.groups == -(-q // 32) and min(32, q - 32 * (plan.groups - 1)) >= 1
        if plan.variant != kernel.BULK:
            assert plan.grid_x * plan.rows >= n
            assert plan.variant == (kernel.ROWS8 if k % 8 == 0 and offset % 8 == 0
                                    else kernel.ROWS)
            continue
        assert k % 8 == 0 and offset % 16 == 0 and plan.rows % 16 == 0 and kernel.STAGES == 2
        assert kernel.bulk_smem_bytes(plan.rows, k) <= kernel.SMEM_PER_BLOCK == 232_448
        tiles = -(-n // plan.rows)
        assert 1 <= plan.grid_x <= min(tiles, 2 * sm)
        seen = np.zeros(n, np.int64)
        for x in range(plan.grid_x):
            for tile in range(x, tiles, plan.grid_x):
                r0 = tile * plan.rows
                nr = min(plan.rows, n - r0)
                seen[r0:r0 + nr] += 1
                assert (offset + r0 * k) % 16 == 0
                assert (nr * k) % 16 == 0 or (tile == tiles - 1 and (nr * k) % 16 == 8)
        assert (seen == 1).all()
    if (n, k) == (3, 120_000):  # a 120 KB row: no ring fits, the rows variant takes it
        assert kernel.launch_plan(q, n, k, _BASE, _BASE, 132).variant == kernel.ROWS8
    if k % 8 == 0 and k <= 1016 and offset % 16 == 0:  # ids 4 bytes off 16: the rows variant
        assert kernel.launch_plan(q, n, k, _BASE, _BASE + 4, 132).variant == kernel.ROWS8


@pytest.mark.parametrize("sm", [1, 3, 132])
def test_emulated_hop_on_citation_ell(sm):
    """Prefix masks (the citation graph's ELL) with a hub row; sparse,
    empty and full frontiers; few SMs make each block walk many tiles."""
    g = generators.citation_graph(1500, seed=4)
    ell = csr_to_ell(g, device="cpu")
    nbr, msk = ell.nbr.numpy(), ell.nbr_mask.numpy()
    deg = msk.sum(1)
    assert nbr.shape[1] % 8 == 0 and deg.max() >= 10 * deg.mean()  # a hub row
    rng = np.random.default_rng(6)
    fr = np.concatenate([rng.random((3, 1500)) < 0.01, np.zeros((1, 1500), bool),
                         np.ones((1, 1500), bool)])
    _hold_emulation(fr, nbr, msk, sm=sm, variant=kernel.BULK)


@pytest.mark.parametrize("n,k,q,offset,variant", [
    (1501, 24, 3, 0, "BULK"),  # N not a multiple of R; last tile 8 bytes past 16
    (1203, 40, 2, 0, "BULK"),
    (900, 13, 3, 0, "ROWS"),  # K % 8 != 0
    (700, 16, 2, 8, "ROWS8"),  # a mask view 8 bytes off 16-byte alignment
    (700, 16, 2, 3, "ROWS"),  # ... and 3 bytes off
    (600, 16, 33, 0, "BULK"),  # two query groups
    (400, 8, 64, 0, "BULK"),
    (100, 2400, 2, 0, "BULK"),  # 16-row tiles: 2-row warp slices of 300 chunks
])
def test_emulated_hop_on_random_masks(n, k, q, offset, variant):
    """Random non-prefix masks with live sentinel slots (id N under a set
    mask bit) and out-of-frontier ids."""
    rng = np.random.default_rng(n + k + q)
    nbr = rng.integers(0, n + 1, (n, k)).astype(np.int32)
    msk = rng.random((n, k)) < 0.3
    nbr[::5, 0] = n
    msk[::5, 0] = True
    fr = rng.random((q, n)) < 0.05
    fr[-1] = True
    stats = _hold_emulation(fr, nbr, msk, sm=3, mask_offset=offset,
                            variant=getattr(kernel, variant))
    if variant == "BULK":
        assert stats["live_chunks"] > 0, stats
