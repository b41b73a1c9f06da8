"""Public top-k similarity search: dispatch on the tensors' device.

A CPU tensor takes the plain version (``ref.py``).  A CUDA tensor launches
the hand-written kernel at every size, which scans and merges in one launch
and writes the final (Q, k); if the kernel cannot be built or launched,
that raises.  ``use_kernel=False`` forces the plain version on any device
(for timing it on the card).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.topk_sim import kernel, ref


def topk_similarity(
    q: torch.Tensor, emb: torch.Tensor, k: int, *,
    use_kernel: Optional[bool] = None,
):
    """q (Q, D) x emb (N, D) -> ((Q, k) scores f32, (Q, k) ids int32)."""
    if q.shape[1] != emb.shape[1]:
        raise ValueError(f"query width {q.shape[1]} != embedding width {emb.shape[1]}")
    k = min(k, emb.shape[0])
    if use_kernel is None:
        use_kernel = q.is_cuda
    if not use_kernel:
        return ref.topk_similarity(q, emb, k)
    return kernel.topk_sim_kernel(q.float().contiguous(), emb.float().contiguous(), k)
