"""Launch wrapper of the hand-written CUDA kernel ``csrc/ivf_scan.cu``:
per-tile top-k of each query's masked candidate scores;
:func:`repro_torch.kernels.ivf_scan.ops.ivf_candidate_scan` merges them."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = build.LaunchCounter()

TILE = 256  # candidate positions per tile (one CUDA block per tile), kTile in the source
_MAX_SMEM = 232_448  # dynamic shared memory one Hopper block may use


def _fn():
    fn = build.library().ivf_scan_tiles
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def ivf_scan_tiles(q: torch.Tensor, emb: torch.Tensor, cand: torch.Tensor,
                   cmask: torch.Tensor, k: int):
    """q (Q, D) f32, emb (N, D) f32, cand (Q, W) int32, cmask (Q, W) bool ->
    (scores f32, positions int32), each (Q, ceil(W / TILE), k): each tile's
    top-k by (score desc, position asc), masked slots at -inf.  A tile with
    fewer than k slots ends in (-inf, its first position) fillers."""
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
    if min(nq, n, w) == 0:
        raise ValueError(f"empty scan: Q={nq}, N={n}, W={w}")
    if not 1 <= k <= min(TILE, w):
        raise ValueError(f"k={k} must be in [1, min(TILE={TILE}, W={w})]")
    if 4 * (d + TILE) > _MAX_SMEM:
        raise ValueError(f"embedding width {d} needs more shared memory than a block has")
    n_tiles = -(-w // TILE)
    s = torch.empty((nq, n_tiles, k), dtype=torch.float32, device=q.device)
    p = torch.empty((nq, n_tiles, k), dtype=torch.int32, device=q.device)
    err = _fn()(q.data_ptr(), emb.data_ptr(), cand.data_ptr(), cmask.data_ptr(), s.data_ptr(),
                p.data_ptr(), nq, n, d, w, k, torch.cuda.current_stream(q.device).cuda_stream)
    launches.count += 1
    build.check_status(err, "ivf_scan")
    return s, p
