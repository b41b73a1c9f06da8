"""Public top-k similarity search: dispatch on the tensors' device.

A CPU tensor takes the plain version (``ref.py``).  A CUDA tensor launches
the hand-written kernel at every size and merges its per-tile lists here;
if the kernel cannot be built or launched, that raises.  ``use_kernel=False``
forces the plain version on any device (for timing it on the card).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.topk_sim import kernel, ref


def merge_tiles(s_blk: torch.Tensor, i_blk: torch.Tensor, k: int):
    """Merge (Q, n_tiles, kk) per-tile lists into the global top-k.  Tiles
    are in id order and each list is ordered (score desc, id asc), so a
    stable sort of the flattened lists puts the lower id first among equal
    scores — the reference's cross-tile ``lax.top_k`` merge."""
    s_flat = s_blk.reshape(s_blk.shape[0], -1)
    i_flat = i_blk.reshape(i_blk.shape[0], -1)
    top_s, pos = ref.stable_topk(s_flat, k)
    return top_s, torch.gather(i_flat, 1, pos)


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
    kk = min(k, kernel.C_BLK)
    s_blk, i_blk = kernel.topk_sim_tiles(q.float().contiguous(), emb.float().contiguous(), kk)
    return merge_tiles(s_blk, i_blk, k)
