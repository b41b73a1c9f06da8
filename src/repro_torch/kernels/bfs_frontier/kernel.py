"""Launch wrapper of the hand-written CUDA kernel ``csrc/bfs_frontier.cu``:
one pull-BFS hop for Q frontiers over the ELL adjacency."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = build.LaunchCounter()


def _fn():
    fn = build.library().bfs_frontier_hop
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
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
    words = torch.empty((q, -(-n // 32)), dtype=torch.int32, device=frontier.device)
    err = _fn()(frontier.data_ptr(), nbr.data_ptr(), nbr_mask.data_ptr(), out.data_ptr(),
                words.data_ptr(), q, n, k,
                torch.cuda.current_stream(frontier.device).cuda_stream)
    launches.count += 1
    build.check_status(err, "bfs_frontier")
    return out
