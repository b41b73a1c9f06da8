"""Launch wrapper of the hand-written CUDA kernel ``csrc/ell_spmm.cu``:
batched ELL neighbour aggregation over per-query feature tiles."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = build.LaunchCounter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _fn():
    fn = build.library().ell_aggregate
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def ell_aggregate_kernel(feat: torch.Tensor, nbr: torch.Tensor,
                         nbr_mask: torch.Tensor) -> torch.Tensor:
    """feat (Q, M, D) fp32 or bf16; nbr (Q, M, K) int32; nbr_mask (Q, M, K)
    bool -> (Q, M, D) in feat's dtype.  A slot counts when its mask is set
    and its id lies in [0, M); any other id is the zero sentinel."""
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
    out = torch.empty_like(feat)
    err = _fn()(feat.data_ptr(), nbr.data_ptr(), nbr_mask.data_ptr(), out.data_ptr(),
                q, m, k, d, _DTYPES[feat.dtype], torch.cuda.current_stream(feat.device).cuda_stream)
    launches.count += 1
    build.check_status(err, "ell_spmm")
    return out
