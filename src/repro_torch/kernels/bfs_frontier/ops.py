"""Public pull-BFS hop: dispatch on the tensors' device.

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the hand-written kernel at every size, or raises.  ``use_kernel=False``
forces the plain version on any device (for timing it on the card).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.bfs_frontier import kernel, ref


def frontier_hop(
    frontier: torch.Tensor,  # (Q, N) bool
    nbr: torch.Tensor,  # (N, K) int32, sentinel N
    nbr_mask: torch.Tensor,  # (N, K) bool
    *,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    if use_kernel is None:
        use_kernel = frontier.is_cuda
    if not use_kernel:
        return ref.frontier_hop(frontier, nbr, nbr_mask)
    return kernel.frontier_hop_kernel(frontier.contiguous(), nbr, nbr_mask)
