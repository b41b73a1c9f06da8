"""Public batched ELL aggregation: dispatch on the tensors' device.

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the hand-written kernel at every size, or raises.  ``use_kernel=False``
forces the plain version on any device (for timing it on the card).  The
reference's VMEM-budget switch and block padding are TPU tiling: the kernel
takes any M, K and D, and reads no padded copy.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ell_spmm import kernel, ref


def ell_aggregate(
    feat: torch.Tensor,  # (Q, M, D)
    nbr: torch.Tensor,  # (Q, M, K), sentinel M
    nbr_mask: torch.Tensor,  # (Q, M, K) bool
    *,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    if use_kernel is None:
        use_kernel = feat.is_cuda
    if not use_kernel:
        return ref.ell_aggregate(feat, nbr, nbr_mask)
    return kernel.ell_aggregate_kernel(feat.contiguous(), nbr.to(torch.int32).contiguous(),
                                       nbr_mask.contiguous())
