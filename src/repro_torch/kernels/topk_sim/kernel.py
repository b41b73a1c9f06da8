"""Launch wrapper of the hand-written CUDA kernels ``csrc/topk_sim.cu``: the
fp32 similarity top-k, a scan kernel and a merge kernel launched together.

``launch_plan`` chooses the variant (bulk copies or plain loads), the query
group, the list capacity and the grid from the shapes, the table's address
and the card's SM count; the C entry point checks the plan and computes the
shared memory itself (``scan_smem_bytes`` mirrors it).  One op call is the
two launches and one count.  ``last_plan`` is the plan the wrapper last
passed to the C entry point."""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build, topk_merge

launches = build.LaunchCounter()

BULK, PLAIN = 0, 1  # variants (csrc/topk_sim.cu: Variant)
CONSUMERS = 8  # consumer warps a block (csrc: kConsumers)
THREADS = (1 + CONSUMERS) * 32  # and one producer warp
MAX_TILE_ROWS = 64  # rows a stage holds at most
TILE_BYTES = 32_768  # bytes a stage holds at most
BATCH = 32  # rows a consumer warp scores at a time
LANE_ROWS = 8  # rows of a batch a lane holds partials of
STAGES = 4
MAX_GROUP = 64  # queries a block scores
GROUP_BYTES = 32_768  # shared memory for a group's queries, and for its lists
STAGE_ALIGN = 128
BLOCKS_PER_SM = 1  # the kernel's launch bounds
SMEM_PER_BLOCK = 232_448  # dynamic shared memory one Hopper block may use


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """The scan: ``grid_x`` x ``groups`` blocks.  Block (x, y) streams the
    tiles [x T / grid_x, (x + 1) T / grid_x) of the T = ceil(N /
    tile_rows(D)) for queries [y * group, (y + 1) * group), each consumer
    warp scoring ``qw`` of them and keeping their running top ``kk``;
    ``stride`` entries of list and merge scratch a query.  The merge: a
    block a query."""

    variant: int
    qw: int
    group: int
    groups: int
    kk: int
    grid_x: int
    stride: int


last_plan: ScanPlan | None = None


def _ceil4(x: int) -> int:
    return -(-x // 4) * 4


def tile_rows(d: int) -> int:
    """Rows a tile holds (csrc: tile_rows): 64, or fewer so that a tile of
    rows (4 ceil4(d) bytes each) stays within 32 KB."""
    return min(MAX_TILE_ROWS, TILE_BYTES // (4 * _ceil4(d)))


def stage_bytes(d: int) -> int:
    return -(-(tile_rows(d) * _ceil4(d) * 4) // STAGE_ALIGN) * STAGE_ALIGN


def slices(group: int, qw: int) -> tuple[int, int]:
    """(query slices, row slices) of a block's consumer warps (csrc:
    qslices, rslices): ceil(group / qw) slices of qw queries, times 8 //
    that many slices of each tile's 8-row batches."""
    qs = -(-group // qw)
    return qs, CONSUMERS // qs


def scan_smem_bytes(d: int, group: int, qw: int, kk: int) -> int:
    """Dynamic shared memory of a scan block (csrc: scan_smem_bytes): the
    stages, the queries (zero past the group, up to whole query slices),
    the warps' lists twice (the block merges its row slices' lists) and the
    barriers."""
    qsl, rsl = slices(group, qw)
    return (STAGES * stage_bytes(d) + qsl * qw * _ceil4(d) * 4 + 2 * group * rsl * kk * 8
            + 16 * STAGES)


def launch_plan(q: int, n: int, d: int, k: int, emb_ptr: int, sm_count: int) -> ScanPlan:
    """The launch for ``q`` queries over an (n, d) table at address
    ``emb_ptr`` on a card of ``sm_count`` SMs, 1 <= k <= n.

    Rows are streamed by bulk copies where d % 4 == 0 and the table is
    16-byte aligned, else by plain loads.  A block holds up to 64 queries
    (fewer where their rows or lists would pass 32 KB); more queries take
    more query groups.  A consumer warp scores qw queries (a quarter of the
    group rounded up to a power of two, at most 8) for its slice of the
    tiles' 32-row batches, so that the two batches of a 64-row tile keep
    all 8 warps busy from a group of 4 queries up.  Up to k = 256 each list keeps the top k of a block's
    range, one block an SM; past 256 a block's range is at most 256 rows,
    all of which its lists keep."""
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must be in [1, N={n}]")
    large = k > topk_merge.CAP
    kk = topk_merge.CAP if large else k
    d4 = _ceil4(d)
    if d4 * 4 > GROUP_BYTES:
        raise ValueError(f"embedding width {d} needs more shared memory than a block has")
    group = min(q, MAX_GROUP)
    while True:
        qw = min(8, 1 << (-(-group // 4) - 1).bit_length())
        qsl, rsl = slices(group, qw)
        if qsl * qw * d4 * 4 <= GROUP_BYTES and group * rsl * kk * 8 <= GROUP_BYTES:
            break
        group -= 1
    n_tiles = -(-n // tile_rows(d))
    if large:
        grid_x = -(-n_tiles // (topk_merge.CAP // tile_rows(d)))
    else:
        grid_x = min(sm_count * BLOCKS_PER_SM, n_tiles)
    stride = topk_merge.merge_stride(grid_x, kk, k)
    variant = BULK if d % 4 == 0 and emb_ptr % 16 == 0 else PLAIN
    return ScanPlan(variant, qw, group, -(-q // group), kk, grid_x, stride)


def _fn():
    fn = build.library().topk_sim_scan
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                       + [ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def topk_sim_kernel(q: torch.Tensor, emb: torch.Tensor, k: int):
    """q (Q, D) f32, emb (N, D) f32 -> (scores (Q, k) f32, ids (Q, k) int32),
    ordered by score descending, ties to the lower id; 1 <= k <= N."""
    build.check_cuda(q, emb)
    if q.dtype != torch.float32 or emb.dtype != torch.float32:
        raise ValueError("topk_sim takes float32 queries and embeddings")
    if q.ndim != 2 or emb.ndim != 2 or q.shape[1] != emb.shape[1]:
        raise ValueError(f"shapes {tuple(q.shape)} x {tuple(emb.shape)}")
    nq, d = q.shape
    n = emb.shape[0]
    if n == 0 or nq == 0 or d == 0:
        raise ValueError(f"empty search: Q={nq}, N={n}, D={d}")
    global last_plan
    dev = q.device
    plan = launch_plan(nq, n, d, k, emb.data_ptr(), build.sm_count(dev))
    if plan.groups > 65535:
        raise ValueError(f"{nq} queries need more than 65535 query groups")
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    pool = torch.empty((nq * plan.stride, 2), dtype=torch.int32, device=dev)
    tree = torch.empty((nq * plan.stride, 2), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):  # the C side plans and launches on the current card
        err = _fn()(q.data_ptr(), emb.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
                    pool.data_ptr(), tree.data_ptr(), nq, n, d, k, plan.variant, plan.qw,
                    plan.group, plan.kk, plan.grid_x, plan.stride,
                    torch.cuda.current_stream(dev).cuda_stream)
    launches.bump(dev)
    last_plan = plan
    build.check_status(err, "topk_sim")
    return out_s, out_i
