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


# --------------------------------------------------------------------------
# The launch plan and a NumPy emulation of the CUDA slab kernel's walk
# (csrc/ell_spmm.cu), held bit for bit to the port's plain version and within
# the tolerances above to the reference's Pallas kernel in interpret mode.
# The emulation follows the kernel step for step: a block a (query, column
# slab); the slab's M rows staged into a buffer of (M+1) rows of RB bytes
# whose unstaged bytes hold NaN (a partial last slab), the first RB / 4 words
# of row M zeroed; warps of R = warp_rows(RB) consecutive rows, 32 slots at
# a time: each row's live slots (mask set, id in [0, M)) ranked in slot order
# into its list of byte offsets, padded with row M's offset to the longest
# list of the R rows rounded up to 4; then fp32 adds of each listed row's
# words in list order, 4 at a time; the lane's columns of the slab stored
# where they lie below D, rounded once to feat's dtype.

from repro_torch.kernels.ell_spmm import kernel  # noqa: E402

_F32_NAN = np.frombuffer(np.uint32(0x7FC00001).tobytes(), np.float32)[0]


def _emulate(feat: torch.Tensor, nbr: np.ndarray, msk: np.ndarray) -> torch.Tensor:
    """What the slab kernel writes, for fp32 or bf16 ``feat``."""
    q, m, d = feat.shape
    k = nbr.shape[2]
    plan = kernel.ell_plan(q, m, k, d, feat.dtype)
    assert plan.variant == kernel.SLAB
    cols = plan.cols
    rb = cols * feat.dtype.itemsize
    r = kernel.warp_rows(rb)
    f32 = feat.float().numpy()  # bf16 -> fp32 is exact, as the kernel's widening is
    out = np.full((q, m, d), _F32_NAN, np.float32)
    for blk in range(plan.grid):
        qi, c0 = divmod(blk, -(-d // cols))
        c0 *= cols
        width = min(cols, d - c0)
        slab = np.full((m + 1, cols), _F32_NAN, np.float32)  # a row is RB bytes
        slab[:m, :width] = f32[qi, :, c0:c0 + width]
        slab[m, :rb // 4 * 4 // feat.dtype.itemsize] = 0.0  # RB / 4 zeroed words
        acc = np.zeros((m, cols), np.float32)
        for s0 in range(0, k, 32):
            ids = nbr[qi, :, s0:s0 + 32]
            live = msk[qi, :, s0:s0 + 32] & (ids >= 0) & (ids < m)
            n = live.sum(1)
            groups = -(-m // r)
            npad_g = np.zeros(groups * r, int)
            npad_g[:m] = n
            npad_g = -(-npad_g.reshape(groups, r).max(1) // 4) * 4  # the warp's longest list
            npad = np.repeat(npad_g, r)[:m]
            lists = np.full((m, 32), m)  # row M pads every list
            for i in range(m):
                lists[i, :n[i]] = ids[i][live[i]]  # ranks in slot order
            for j in range(0, int(npad.max(initial=0)), 4):
                for jj in range(j, j + 4):
                    on = npad > jj
                    acc[on] = acc[on] + slab[lists[on, jj]]
        out[qi, :, c0:c0 + width] = acc[:, :width]
    assert not np.isnan(out).any()
    return torch.from_numpy(out).to(feat.dtype)


def _emulation_case(seed, q, m, k, d, hi=None, p=0.7):
    feat, nbr, msk = _data(seed, q, m, k, d, p=p, hi=hi)
    nbr[:, ::7, 0] = m  # the sentinel under a set mask
    nbr[:, ::5, -1] = m + 3  # past the sentinel
    msk[:, ::7, 0] = True
    msk[:, ::11] = False  # all-masked rows
    msk[-1] = False  # an all-masked query
    return feat, nbr, msk


@pytest.mark.parametrize("q,m,k,d", [(3, 100, 12, 48), (2, 50, 4, 200), (5, 17, 1, 33),
                                     (3, 1, 3, 8), (2, 70, 40, 64), (4, 64, 32, 128),
                                     (2, 3000, 8, 16), (1, 3375, 4, 8)])
def test_emulated_slab_kernel_matches_plain_and_reference_kernel(q, m, k, d):
    """fp32: bit for bit against the plain version (the order the card is
    held to), within atol = rtol = 1e-5 of the Pallas kernel in interpret
    mode; covers partial last slabs (D = 33, 48, 200), M = 1, K = 1 and 40,
    and the 16-column slabs of large M (D = 8: a partial one)."""
    feat, nbr, msk = _emulation_case(m + k + d, q, m, k, d)
    got = _emulate(torch.from_numpy(feat), nbr, msk)
    want = ref.ell_aggregate(torch.from_numpy(feat), torch.from_numpy(nbr), torch.from_numpy(msk))
    assert torch.equal(got, want)
    assert not got[-1].any() and not got[:, ::11].any()
    if m * k <= 4096:  # the interpret-mode kernel is slow
        np.testing.assert_allclose(got.numpy(), _reference(feat, nbr, msk), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("q,m,k,d", [(4, 64, 16, 48), (2, 30, 5, 33), (2, 100, 8, 200)])
def test_emulated_slab_kernel_bf16(q, m, k, d):
    """bf16 (64-column slabs of bf16 pairs): bit for bit against the plain
    version, within one bf16 ulp of the Pallas kernel in interpret mode."""
    feat, nbr, msk = _emulation_case(d, q, m, k, d)
    fb = torch.from_numpy(feat).to(torch.bfloat16)
    got = _emulate(fb, nbr, msk)
    assert kernel.ell_plan(q, m, k, d, torch.bfloat16).cols == 64
    assert torch.equal(got, ref.ell_aggregate(fb, torch.from_numpy(nbr), torch.from_numpy(msk)))
    want = _reference(fb.float().numpy(), nbr, msk, dtype=jnp.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-7,
                               atol=2**-7 * np.abs(want).max())


def test_emulated_slab_kernel_zero_row_and_unstaged_columns():
    """Every list padded past its live slots reads row M, which the kernel
    zeroes; the columns of a partial slab past D are never staged (NaN
    here) and never stored."""
    feat, nbr, msk = _emulation_case(2, 2, 40, 9, 40, p=0.3)
    msk[0, 0] = True  # a full row beside sparse ones: its warp pads the others
    nbr[0, 0] = np.arange(9)
    got = _emulate(torch.from_numpy(feat), nbr, msk)
    assert torch.equal(got, ref.ell_aggregate(torch.from_numpy(feat), torch.from_numpy(nbr),
                                              torch.from_numpy(msk)))


@pytest.mark.parametrize("q,m,k,d,dtype,cols,variant", [
    (64, 1024, 32, 128, torch.float32, 32, kernel.SLAB),
    (32, 256, 16, 128, torch.float32, 32, kernel.SLAB),
    (64, 1024, 32, 128, torch.bfloat16, 64, kernel.SLAB),
    (3, 3000, 24, 128, torch.float32, 16, kernel.SLAB),
    (2, 1751, 16, 128, torch.float32, 32, kernel.SLAB),
    (2, 1752, 16, 128, torch.float32, 16, kernel.SLAB),
    (2, 5000, 16, 40, torch.float32, 0, kernel.L2),
    (2, 3375, 16, 128, torch.float32, 16, kernel.SLAB),
    (2, 3376, 16, 128, torch.float32, 0, kernel.L2),
    (2, 8000, 16, 128, torch.float32, 0, kernel.L2),
    (2, 3000, 8, 96, torch.bfloat16, 32, kernel.SLAB),
    (3, 1, 3, 8, torch.float32, 32, kernel.SLAB),
    (5, 17, 1, 33, torch.float32, 32, kernel.SLAB),
    (2, 50, 4, 200, torch.bfloat16, 64, kernel.SLAB)])
def test_ell_plan_covers_every_query_column_once(q, m, k, d, dtype, cols, variant):
    """The widest slab whose (M+1) rows fit, within a block's 232,448 bytes
    (bf16 rows of 64 columns); every (query, column) in exactly one block;
    past any slab, the l2 variant's blocks of 8 rows cover every row."""
    plan = kernel.ell_plan(q, m, k, d, dtype)
    assert (plan.variant, plan.cols) == (variant, cols)
    if variant == kernel.L2:
        assert plan.grid == q * -(-m // kernel.L2_WARPS) and plan.smem_bytes == 0
        assert all(kernel.slab_smem_bytes(m, w) > kernel.SMEM_PER_BLOCK for w in kernel.ROW_BYTES)
        return
    rb = cols * dtype.itemsize
    assert plan.smem_bytes == kernel.slab_smem_bytes(m, rb) <= kernel.SMEM_PER_BLOCK
    assert plan.smem_bytes >= (m + 1) * rb + kernel.THREADS // 32 * kernel.warp_rows(rb) * 128
    slabs = -(-d // cols)
    covered = np.zeros((q, d), int)
    for blk in range(plan.grid):
        qi, s = divmod(blk, slabs)
        covered[qi, s * cols:min(d, (s + 1) * cols)] += 1
    assert (covered == 1).all()
    wider = [w for w in kernel.ROW_BYTES if w > rb]
    assert all(kernel.slab_smem_bytes(m, w) > kernel.SMEM_PER_BLOCK for w in wider)


def test_ell_plan_forced_widths():
    """A forced slab width is taken where it fits and refused elsewhere;
    0 forces the l2 variant at any M."""
    for cols in (32, 16):
        plan = kernel.ell_plan(64, 1024, 32, 128, torch.float32, cols=cols)
        assert plan.cols == cols and plan.grid == 64 * 128 // cols
    with pytest.raises(ValueError, match="no slab"):
        kernel.ell_plan(64, 1024, 32, 128, torch.float32, cols=8)
    for m in (1024, 3000):
        assert kernel.ell_plan(64, m, 32, 128, torch.float32, cols=0) == kernel.EllPlan(
            kernel.L2, 0, 64 * -(-m // kernel.L2_WARPS), 0)
    with pytest.raises(ValueError, match="no slab"):
        kernel.ell_plan(64, 3000, 32, 128, torch.float32, cols=32)
    with pytest.raises(ValueError, match="no slab"):
        kernel.ell_plan(64, 100, 32, 128, torch.float32, cols=12)


def test_layout_constants_match_cuda_source():
    """The plan mirrors the slab kernel's shared-memory layout, whose C
    constants the entry point checks a plan against: the two must agree."""
    import re
    from pathlib import Path

    src = (Path(kernel.__file__).parents[2] / "csrc" / "ell_spmm.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert {name: int(consts[c]) for name, c in (
        ("THREADS", "kThreads"), ("LIST_SLOTS", "kListSlots"), ("L2_WARPS", "kL2Warps"),
        ("SMEM_PER_BLOCK", "kSmemPerBlock"))} == {
        name: getattr(kernel, name) for name in ("THREADS", "LIST_SLOTS", "L2_WARPS",
                                                 "SMEM_PER_BLOCK")}
    assert "enum Variant { kSlab = 0, kL2 = 1 };" in src and (kernel.SLAB, kernel.L2) == (0, 1)
    assert "__launch_bounds__(kThreads, 1)" in src
    assert "constexpr int kLaneBytes = 8;" in src and kernel.LANE_BYTES == 8
    assert "return 32 * kLaneBytes / RB;" in src
    assert "(rb != 64 && rb != 128)" in src and kernel.ROW_BYTES == (128, 64)
    assert [kernel.warp_rows(rb) for rb in kernel.ROW_BYTES] == [2, 4]
    assert "(long long)kWarps * warp_rows(RB) * kListSlots * 4;" in src
