"""Launch wrapper of the hand-written CUDA kernel ``csrc/frontier_expand.cu``:
membership of each candidate id in its query's sorted workset row.

``mark_plan`` chooses the variant and the persistent grid from the shapes,
the pointers' alignment and the card's SM count; the C entry point checks
the plan."""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build

launches = build.LaunchCounter()

THREADS = 256
VECS = 4  # 16-byte loads per thread per tile
TILE = THREADS * 4 * VECS  # candidates per block tile
BLOCKS_PER_SM = 4  # blocks an SM is planned to hold
_MAX_SMEM = 232_448  # dynamic shared memory one Hopper block may use
_MAX_GRID_Y = 65_535  # one grid row per query


@dataclasses.dataclass(frozen=True)
class MarkPlan:
    """One mark launch: ``blocks_per_q`` blocks per query, each walking the
    query's tiles ``blockIdx.x, blockIdx.x + blocks_per_q, ...``; ``vec``
    loads four candidates at a time (else one)."""

    vec: bool
    blocks_per_q: int


def mark_plan(q: int, w: int, cand_ptr: int, out_ptr: int, sm_count: int) -> MarkPlan:
    """The launch for ``q`` workset rows and ``w`` candidates per row, with
    the candidates at ``cand_ptr`` and the marks at ``out_ptr``, on a card
    of ``sm_count`` SMs."""
    vec = w % 4 == 0 and cand_ptr % 16 == 0 and out_ptr % 4 == 0
    tiles = -(-w // TILE)
    blocks_per_q = max(1, min(tiles, -(-sm_count * BLOCKS_PER_SM // q)))
    return MarkPlan(vec, blocks_per_q)


def _fn():
    fn = build.library().ws_mark
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                       + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def ws_mark_kernel(ws_ids: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """ws_ids (Q, C) int32 ascending per row; cand (Q, W) int32 -> (Q, W)
    bool, True where the candidate occurs in its row."""
    build.check_cuda(ws_ids, cand)
    if ws_ids.dtype != torch.int32 or cand.dtype != torch.int32:
        raise ValueError("frontier_expand takes int32 workset rows and candidates")
    if ws_ids.ndim != 2 or cand.ndim != 2 or ws_ids.shape[0] != cand.shape[0]:
        raise ValueError(f"shapes {tuple(ws_ids.shape)}, {tuple(cand.shape)}")
    q, c = ws_ids.shape
    w = cand.shape[1]
    if c == 0:
        raise ValueError("frontier_expand needs workset rows of at least one id")
    if 4 * c > _MAX_SMEM:
        raise ValueError(f"a workset row of {c} ids needs {4 * c} bytes of shared memory; "
                         f"a Hopper block has {_MAX_SMEM}")
    if q > _MAX_GRID_Y:
        raise ValueError(f"{q} queries exceed the grid's {_MAX_GRID_Y} rows")
    out = torch.empty((q, w), dtype=torch.bool, device=cand.device)
    if q == 0 or w == 0:
        return out
    plan = mark_plan(q, w, cand.data_ptr(), out.data_ptr(), build.sm_count(cand.device))
    with torch.cuda.device(cand.device):  # the C side launches on the current card
        err = _fn()(ws_ids.data_ptr(), cand.data_ptr(), out.data_ptr(), q, c, w, int(plan.vec),
                    plan.blocks_per_q, torch.cuda.current_stream(cand.device).cuda_stream)
    launches.bump(cand.device)
    build.check_status(err, "frontier_expand")
    return out
