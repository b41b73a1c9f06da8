"""Public IVF candidate scan: dispatch on the tensors' device.

A CPU tensor takes a plain arm (``ref.py``): the dense gather for narrow
candidate sets and the tiled loop from two c_blk tiles up, the reference's
heuristic.  A CUDA tensor launches the hand-written kernel at every width
(both arms compute the same function; the kernel scans and merges in one
launch); if the kernel cannot be built or launched, that raises.
``use_kernel=False`` forces the plain arms on any device.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ivf_scan import kernel, ref


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def ivf_candidate_scan(
    q: torch.Tensor,      # (Q, D)
    emb: torch.Tensor,    # (N, D)
    cand: torch.Tensor,   # (Q, W) int32 ids in [0, N]; N = sentinel
    cmask: torch.Tensor,  # (Q, W) bool
    k: int,
    *,
    c_blk: int = 1024,
    tiled: Optional[bool] = None,
    use_kernel: Optional[bool] = None,
):
    """Score each query against its candidate ids; return top-k (scores, ids),
    always (Q, k): when the candidate list is narrower than k the tail is
    (-inf, sentinel N)."""
    n = emb.shape[0]
    w = cand.shape[1]
    k_eff = min(k, w)
    if use_kernel is None:
        use_kernel = q.is_cuda
    if use_kernel:
        s, i = kernel.ivf_scan_kernel(q.float().contiguous(), emb.float().contiguous(),
                                      cand.to(torch.int32).contiguous(), cmask.contiguous(), k_eff)
    else:
        if tiled is None:
            tiled = w >= 2 * c_blk  # at least two candidate tiles
        if not tiled:
            s, i = ref.ivf_candidate_scan(q, emb, cand, cmask, k_eff)
        else:
            wp = _ceil_to(w, c_blk)
            cand = F.pad(cand, (0, wp - w), value=n)
            cmask = F.pad(cmask, (0, wp - w), value=False)
            s, i = ref.ivf_scan_tiled(q, emb, cand, cmask, k_eff, c_blk=c_blk)
    if k_eff < k:  # keep the (Q, k) contract for narrow candidate sets
        s = F.pad(s, (0, k - k_eff), value=float("-inf"))
        i = F.pad(i, (0, k - k_eff), value=n)
    return s, i
