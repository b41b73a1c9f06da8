"""Launch wrapper of the hand-written CUDA kernels ``csrc/bfs_frontier.cu``:
one pull-BFS hop for Q frontiers over the ELL adjacency.

``launch_plan`` chooses the hop's variant and its launch from the shapes,
the addresses of the mask and ids and the card's SM count; the C entry
point checks the plan and launches the pack kernel and then the row kernel,
or the pack kernel (which then also zeroes the reach) and the bulk kernel
(one op call, one count).  ``last_plan`` is the plan the wrapper last
passed to the C entry point."""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build

launches = build.LaunchCounter()

THREADS = 256  # threads of a row-variant block
QUERY_GROUP = 32  # queries a packed frontier word holds
BULK, ROWS8, ROWS = 0, 1, 2  # hop variants (csrc/bfs_frontier.cu: Variant)
SCANNERS = 8  # bulk: scanner warps a block (each R / 8 rows of a tile)
PROBERS = 8  # bulk: prober warps a block
BITMAPS = 4  # bulk: tiles' live-chunk bitmaps in flight from the scanners to the probers
PROBE_WORDS = 8  # bulk: bitmap words a prober takes at a time
TILE_BYTES = 32 * 1024  # mask bytes per bulk tile (rows rounded down to a multiple of 16)
MAX_TILE_ROWS = 1024
STAGES = 2  # bulk: ring stages (csrc: kStages)
BLOCKS_PER_SM = 2  # bulk: blocks an SM is planned to hold (the kernel's launch bounds)
STAGE_ALIGN = 128
SMEM_PER_BLOCK = 232_448  # dynamic shared memory one Hopper block may use
SMEM_PER_SM = 233_472  # shared memory of one SM, of which each block
SMEM_RESERVED = 1_024  # reserves this much for the system


@dataclasses.dataclass(frozen=True)
class HopPlan:
    """One hop launch.  ``variant`` BULK: a persistent grid of ``grid_x``
    blocks (a producer, 8 scanner and 8 prober warps each) walks tiles of
    ``rows`` rows through a ring of STAGES bulk-copied stages
    (``bulk_smem_bytes(rows, k)`` of dynamic shared memory), once for all
    ``groups`` groups of up to 32 queries.  ROWS8 / ROWS: ``grid_x`` x
    ``groups`` blocks of 8 warps, a warp a row, 8 or 1 slots a lane
    (``rows`` = 8 rows a block)."""

    variant: int
    rows: int
    grid_x: int
    groups: int


last_plan: HopPlan | None = None


def stage_bytes(rows: int, k: int) -> int:
    """Shared memory of one ring stage: a tile's mask, 128-byte aligned."""
    return -(-(rows * k) // STAGE_ALIGN) * STAGE_ALIGN


def tile_words(rows: int, k: int) -> int:
    """Words of a tile's live-chunk bitmap: a bit for each 16-byte chunk."""
    chunks = -(-(rows * k) // 16)
    return -(-chunks // 32)


def bulk_smem_bytes(rows: int, k: int) -> int:
    """Dynamic shared memory of the bulk variant, which the C entry point
    computes itself (csrc: bulk_smem_bytes): the stages, the ring of tile
    bitmaps, the probers' lists, a full and an empty barrier a stage and a
    bitmap.  The plan uses it to decide whether the ring fits."""
    return (STAGES * stage_bytes(rows, k) + 4 * BITMAPS * tile_words(rows, k)
            + 4 * PROBERS * 32 * PROBE_WORDS + 16 * (STAGES + BITMAPS))


def launch_plan(q: int, n: int, k: int, mask_ptr: int, nbr_ptr: int,
                sm_count: int) -> HopPlan:
    """The hop's launch for ``q`` frontiers over an (n, k) ELL whose mask
    starts at address ``mask_ptr`` and ids at ``nbr_ptr``, on a card of
    ``sm_count`` SMs.

    The bulk variant needs K % 8 == 0, a 16-byte aligned mask (and ids: it
    reads a live quarter-chunk's four ids as one 16-byte load), so that
    every tile (a multiple of 16 rows) and every scanner warp's slice of it
    (an even number of rows) starts on a 16-byte boundary and spans a
    multiple of 16 bytes (the graph's last tile may end 8 bytes past one;
    the kernel reads those directly).  Where its ring does not fit in a
    block's shared memory even at 16 rows, or the shape or alignment forbid
    it, the row variants take the hop."""
    groups = -(-q // QUERY_GROUP)
    if k > 0 and k % 8 == 0 and mask_ptr % 16 == 0 and nbr_ptr % 16 == 0:
        rows = min(MAX_TILE_ROWS, max(16, TILE_BYTES // k // 16 * 16))
        smem = bulk_smem_bytes(rows, k)
        if smem <= SMEM_PER_BLOCK:
            per_sm = max(1, min(BLOCKS_PER_SM, SMEM_PER_SM // (smem + SMEM_RESERVED)))
            grid_x = max(1, min(-(-n // rows), sm_count * per_sm))
            return HopPlan(BULK, rows, grid_x, groups)
    variant = ROWS8 if k % 8 == 0 and mask_ptr % 8 == 0 else ROWS
    rows = THREADS // 32
    return HopPlan(variant, rows, -(-n // rows), groups)


def _fn():
    fn = build.library().bfs_frontier_hop
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def frontier_hop_kernel(frontier: torch.Tensor, nbr: torch.Tensor,
                        nbr_mask: torch.Tensor) -> torch.Tensor:
    """frontier (Q, N) bool; nbr (N, K) int32 with sentinel N; nbr_mask
    (N, K) bool -> reach (Q, N) bool."""
    build.check_cuda(frontier, nbr, nbr_mask)
    if frontier.dtype != torch.bool or nbr_mask.dtype != torch.bool or nbr.dtype != torch.int32:
        raise ValueError("bfs_frontier takes a bool frontier, int32 nbr and a bool mask")
    q, n = frontier.shape
    if nbr.shape != nbr_mask.shape or nbr.shape[0] != n:
        raise ValueError(f"shapes {tuple(frontier.shape)}, {tuple(nbr.shape)}, {tuple(nbr_mask.shape)}")
    k = nbr.shape[1]
    if n * k >= 2**31:
        raise ValueError(f"ELL of {n} x {k} slots exceeds 32-bit indexing")
    out = torch.empty((q, n), dtype=torch.bool, device=frontier.device)
    if q == 0 or n == 0:
        return out
    global last_plan
    plan = launch_plan(q, n, k, nbr_mask.data_ptr(), nbr.data_ptr(),
                       build.sm_count(frontier.device))
    words = torch.empty((plan.groups, n), dtype=torch.int32, device=frontier.device)
    with torch.cuda.device(frontier.device):  # the C side launches on the current card
        err = _fn()(frontier.data_ptr(), nbr.data_ptr(), nbr_mask.data_ptr(), out.data_ptr(),
                    words.data_ptr(), q, n, k, plan.variant, plan.rows, plan.grid_x,
                    torch.cuda.current_stream(frontier.device).cuda_stream)
    launches.bump(frontier.device)
    last_plan = plan
    build.check_status(err, "bfs_frontier")
    return out
