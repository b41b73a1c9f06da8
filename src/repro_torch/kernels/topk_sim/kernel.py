"""Launch wrapper of the hand-written CUDA kernel ``csrc/topk_sim.cu``.

Computes per-tile top-k lists (scores and global ids) of fp32 similarity;
:func:`repro_torch.kernels.topk_sim.ops.topk_similarity` merges them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = build.LaunchCounter()

C_BLK = 256  # candidate rows per tile (one CUDA block per tile)
_MAX_SMEM = 232_448  # dynamic shared memory one Hopper block may use
_QB = 8  # queries per block, kQB in the source


def _fn():
    fn = build.library().topk_sim_tiles
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def topk_sim_tiles(q: torch.Tensor, emb: torch.Tensor, k: int, *, c_blk: int = C_BLK):
    """q (Q, D) f32, emb (N, D) f32 -> (scores, ids) each (Q, ceil(N/c_blk), k):
    each tile's top-k, ties to the lower id, rows past N at -inf."""
    build.check_cuda(q, emb)
    if q.dtype != torch.float32 or emb.dtype != torch.float32:
        raise ValueError("topk_sim takes float32 queries and embeddings")
    if q.ndim != 2 or emb.ndim != 2 or q.shape[1] != emb.shape[1]:
        raise ValueError(f"shapes {tuple(q.shape)} x {tuple(emb.shape)}")
    nq, d = q.shape
    n = emb.shape[0]
    if not 1 <= k <= c_blk:
        raise ValueError(f"k={k} must be in [1, c_blk={c_blk}]")
    if 4 * _QB * (d + c_blk) > _MAX_SMEM:
        raise ValueError(f"embedding width {d} needs more shared memory than a block has")
    if n == 0 or nq == 0:
        raise ValueError(f"empty search: Q={nq}, N={n}")
    n_tiles = -(-n // c_blk)
    s = torch.empty((nq, n_tiles, k), dtype=torch.float32, device=q.device)
    i = torch.empty((nq, n_tiles, k), dtype=torch.int32, device=q.device)
    err = _fn()(q.data_ptr(), emb.data_ptr(), s.data_ptr(), i.data_ptr(),
                nq, n, d, k, c_blk, torch.cuda.current_stream(q.device).cuda_stream)
    launches.count += 1
    build.check_status(err, "topk_sim")
    return s, i
