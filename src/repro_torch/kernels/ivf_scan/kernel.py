"""Launch wrapper of the hand-written CUDA kernel ``csrc/ivf_scan.cu``: each
query's masked candidate scores and their top k, scan and merge in one
launch.

``launch_plan`` sizes the grid (a block a range of slots of one query) from
the shapes and the card's SM count; the C entry point checks the plan and
computes the shared memory itself (``ivf_smem_bytes`` mirrors it).
``last_plan`` is the plan the wrapper last passed to the C entry point."""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build, topk_merge

launches = build.LaunchCounter()

WARPS = 8  # warps a block (csrc: kWarps)
RUN = 32  # slots a warp reads at a time (csrc: kRun)
BLOCKS_PER_SM = 2  # blocks the grid is sized to put on each SM
STAGE_BYTES = 64 * 1024  # most shared memory a block stages a merge in (csrc: kStageBytes)
SMEM_PER_BLOCK = 232_448  # dynamic shared memory one Hopper block may use


@dataclasses.dataclass(frozen=True)
class IvfPlan:
    """One launch: ``grid_x`` x Q blocks.  Block (x, q) scans query q's slots
    [x * span, (x + 1) * span), its warps taking runs of 32 in turn and each
    keeping a running top ``kk``; ``stride`` entries of list and merge
    scratch a query."""

    kk: int
    span: int
    grid_x: int
    stride: int


last_plan: IvfPlan | None = None


def ivf_smem_bytes(d: int, kk: int, stride: int) -> int:
    """Dynamic shared memory of a block (csrc: ivf_smem_bytes): the query
    row, then the warps' lists, or the last block's merge stage (two copies
    of a query's lists) where that fits STAGE_BYTES and is larger."""
    stage = 16 * stride if 16 * stride <= STAGE_BYTES else 0
    return -(-(4 * d) // 16) * 16 + max(WARPS * kk * 8, stage)


def launch_plan(q: int, w: int, k: int, sm_count: int) -> IvfPlan:
    """The launch for ``q`` queries of ``w`` candidate slots each on a card
    of ``sm_count`` SMs, 1 <= k <= w: about BLOCKS_PER_SM blocks an SM over
    all queries, each block a multiple of 256 slots (a run for each of its
    warps).  Past k = 256 a block spans at most 8 * 256 slots, so that each
    warp's list keeps all of its (at most 256) slots for the tree merge."""
    if not 1 <= k <= w:
        raise ValueError(f"k={k} must be in [1, W={w}]")
    large = k > topk_merge.CAP
    kk = topk_merge.CAP if large else k
    per_query = max(1, -(-(sm_count * BLOCKS_PER_SM) // q))
    span = -(-(-(-w // per_query)) // (WARPS * RUN)) * (WARPS * RUN)
    if large:
        span = min(span, WARPS * topk_merge.CAP)
    grid_x = -(-w // span)
    return IvfPlan(kk, span, grid_x, topk_merge.merge_stride(grid_x * WARPS, kk, k))


def _fn():
    fn = build.library().ivf_scan
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_longlong]
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def ivf_scan_kernel(q: torch.Tensor, emb: torch.Tensor, cand: torch.Tensor,
                    cmask: torch.Tensor, k: int):
    """q (Q, D) f32, emb (N, D) f32, cand (Q, W) int32, cmask (Q, W) bool ->
    (scores (Q, k) f32, ids (Q, k) int32): the top k by (score desc,
    position asc), masked slots at -inf, ids the raw cand values at the
    winning positions; 1 <= k <= W."""
    build.check_cuda(q, emb, cand, cmask)
    if q.dtype != torch.float32 or emb.dtype != torch.float32:
        raise ValueError("ivf_scan takes float32 queries and embeddings")
    if cand.dtype != torch.int32 or cmask.dtype != torch.bool:
        raise ValueError("ivf_scan takes int32 candidate ids and a bool mask")
    if q.ndim != 2 or emb.ndim != 2 or q.shape[1] != emb.shape[1] \
            or cand.shape != cmask.shape or cand.shape[0] != q.shape[0]:
        raise ValueError(f"shapes q {tuple(q.shape)}, emb {tuple(emb.shape)}, "
                         f"cand {tuple(cand.shape)}, cmask {tuple(cmask.shape)}")
    nq, d = q.shape
    n, w = emb.shape[0], cand.shape[1]
    if min(nq, n, w, d) == 0:
        raise ValueError(f"empty scan: Q={nq}, N={n}, W={w}, D={d}")
    if nq > 65535:
        raise ValueError(f"{nq} queries: at most 65535 a launch")
    global last_plan
    dev = q.device
    plan = launch_plan(nq, w, k, build.sm_count(dev))
    if ivf_smem_bytes(d, plan.kk, plan.stride) > SMEM_PER_BLOCK:
        raise ValueError(f"embedding width {d} needs more shared memory than a block has")
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    pool = torch.empty((nq * plan.stride, 2), dtype=torch.int32, device=dev)
    tree = torch.empty((nq * plan.stride, 2), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = topk_merge.workspace(dev, stream, nq)
    with torch.cuda.device(dev):  # the C side plans and launches on the current card
        err = _fn()(q.data_ptr(), emb.data_ptr(), cand.data_ptr(), cmask.data_ptr(),
                    out_s.data_ptr(), out_i.data_ptr(), pool.data_ptr(), tree.data_ptr(),
                    ws.data_ptr(), nq, n, d, w, k, plan.kk, plan.span, plan.grid_x, plan.stride,
                    stream)
    launches.bump(dev)
    last_plan = plan
    build.check_status(err, "ivf_scan")
    return out_s, out_i
