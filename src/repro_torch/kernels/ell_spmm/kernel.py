"""Launch wrapper of the hand-written CUDA kernel ``csrc/ell_spmm.cu``:
batched ELL neighbour aggregation over per-query feature tiles.

``ell_plan`` chooses the variant and its launch from the shapes alone: the
slab variant (a block a (query, column slab), the slab's rows staged in
shared memory) where a slab of (M+1) rows fits a block, else the l2 variant
(a warp an output row, gathers through L2).  The C entry point checks the
plan against its own constants and launches it; ``last_plan`` is the plan
the wrapper last passed to it."""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build

launches = build.LaunchCounter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

SLAB, L2 = 0, 1  # variants (csrc: Variant)
THREADS = 1024  # slab: threads a block (csrc: kThreads)
LIST_SLOTS = 32  # slab: byte offsets a row's list holds (csrc: kListSlots)
ROW_BYTES = (128, 64)  # slab row widths, widest first
LANE_BYTES = 8  # slab: bytes of a slab row a lane reads (csrc: kLaneBytes)
L2_WARPS = 8  # l2: output rows a block, a warp each (csrc: kL2Warps)
SMEM_PER_BLOCK = 232_448  # dynamic shared memory one Hopper block may use


@dataclasses.dataclass(frozen=True)
class EllPlan:
    """One launch.  ``variant`` SLAB: ``grid`` = Q x ceil(D / cols) blocks,
    block b taking query b // slabs and columns [cols * (b % slabs), +cols),
    with ``smem_bytes`` of dynamic shared memory.  L2: ``grid`` = Q x
    ceil(M / 8) blocks of 8 output rows (``cols`` 0, no dynamic shared
    memory).  The blocks an SM holds come from the card (``slab_occupancy``)."""

    variant: int
    cols: int
    grid: int
    smem_bytes: int


last_plan: EllPlan | None = None


def warp_rows(row_bytes: int) -> int:
    """Output rows a warp of the slab kernel adds at once (csrc: warp_rows)."""
    return 32 * LANE_BYTES // row_bytes


def slab_smem_bytes(m: int, row_bytes: int) -> int:
    """Dynamic shared memory of a slab block (csrc: slab_smem_bytes): the
    (M+1)-row slab, 16-byte aligned, then each warp's ``warp_rows`` lists of
    LIST_SLOTS 4-byte offsets."""
    return (-(-((m + 1) * row_bytes) // 16) * 16
            + (THREADS // 32) * warp_rows(row_bytes) * LIST_SLOTS * 4)


def ell_plan(q: int, m: int, k: int, d: int, dtype: torch.dtype,
             cols: int | None = None) -> EllPlan:
    """The launch for ``q`` queries of ``m`` rows, ``k`` slots and ``d``
    columns of ``dtype``.  The slab is the widest row of ROW_BYTES whose
    (M+1) rows fit a block (a narrow D takes a partial slab); where not even
    a 64-byte row fits (M past 3,375), the l2 variant takes the call.
    ``cols`` forces a slab width, or with 0 the l2 variant (for timing one
    against another)."""
    if min(q, m, k, d) <= 0:
        raise ValueError(f"empty aggregation: Q={q}, M={m}, K={k}, D={d}")
    esize = dtype.itemsize
    if cols is None:
        fits = [rb for rb in ROW_BYTES if slab_smem_bytes(m, rb) <= SMEM_PER_BLOCK]
        cols = fits[0] // esize if fits else 0
    elif cols and (cols * esize not in ROW_BYTES
                   or slab_smem_bytes(m, cols * esize) > SMEM_PER_BLOCK):
        raise ValueError(f"no slab of {cols} columns of {dtype} at M={m}")
    if cols == 0:
        return EllPlan(L2, 0, q * -(-m // L2_WARPS), 0)
    return EllPlan(SLAB, cols, q * -(-d // cols), slab_smem_bytes(m, cols * esize))


def _fn():
    fn = build.library().ell_aggregate
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def slab_occupancy(plan: EllPlan, dtype: torch.dtype) -> int:
    """Blocks of ``plan``'s slab kernel an SM of the current card holds,
    from the card's occupancy calculator (registers included); for reports."""
    fn = build.library().ell_slab_occupancy
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    blocks = ctypes.c_int()
    build.check_status(fn(_DTYPES[dtype], plan.cols, plan.smem_bytes, ctypes.byref(blocks)),
                       "ell_slab_occupancy")
    return blocks.value


def ell_aggregate_kernel(feat: torch.Tensor, nbr: torch.Tensor, nbr_mask: torch.Tensor,
                         plan: EllPlan | None = None) -> torch.Tensor:
    """feat (Q, M, D) fp32 or bf16; nbr (Q, M, K) int32; nbr_mask (Q, M, K)
    bool -> (Q, M, D) in feat's dtype.  A slot counts when its mask is set
    and its id lies in [0, M); any other id is the zero sentinel.  ``plan``
    defaults to ``ell_plan``'s."""
    build.check_cuda(feat, nbr, nbr_mask)
    if feat.dtype not in _DTYPES or nbr.dtype != torch.int32 or nbr_mask.dtype != torch.bool:
        raise ValueError("ell_spmm takes fp32/bf16 features, int32 ids and a bool mask")
    if feat.ndim != 3 or nbr.ndim != 3 or nbr.shape != nbr_mask.shape \
            or nbr.shape[:2] != feat.shape[:2]:
        raise ValueError(f"shapes {tuple(feat.shape)}, {tuple(nbr.shape)}, {tuple(nbr_mask.shape)}")
    q, m, d = feat.shape
    k = nbr.shape[2]
    if min(q, m, d, k) == 0:
        raise ValueError(f"empty aggregation: Q={q}, M={m}, D={d}, K={k}")
    global last_plan
    if plan is None:
        plan = ell_plan(q, m, k, d, feat.dtype)
    out = torch.empty_like(feat)
    with torch.cuda.device(feat.device):  # the C side raises limits and launches there
        err = _fn()(feat.data_ptr(), nbr.data_ptr(), nbr_mask.data_ptr(), out.data_ptr(), q, m,
                    k, d, _DTYPES[feat.dtype], plan.variant, plan.cols, plan.grid,
                    plan.smem_bytes, torch.cuda.current_stream(feat.device).cuda_stream)
    launches.bump(feat.device)
    last_plan = plan
    build.check_status(err, "ell_spmm")
    return out
