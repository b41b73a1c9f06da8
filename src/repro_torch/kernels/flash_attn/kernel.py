"""Launch wrappers of the hand-written CUDA kernels ``csrc/flash_attn.cu``:
the FlashAttention-2 forward and the two passes of its backward.

Each wrapper checks what its kernel takes (one Hopper card, contiguous
tensors, fp32 or bf16, dh in {16, 64, 128}, H a multiple of KV), raises
on anything else, allocates the outputs, launches on the current stream and
counts the launch.  The dq pass writes ``delta`` for the dk/dv pass, which
must be launched after it on the same stream.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

fwd_launches = build.LaunchCounter()
dq_launches = build.LaunchCounter()
dkv_launches = build.LaunchCounter()

HEAD_DIMS = (16, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65_535


def _fn(name: str, n_ptr: int):
    fn = getattr(build.library(), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: Optional[int], *rest):
    """Shape, type and window checks shared by the three kernels; returns
    (B, S, H, KV, dh, window as an int, dtype code, scale)."""
    build.check_cuda(q, k, v, *rest)
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attn takes float32 or bfloat16, got {q.dtype}")
    if any(t.dtype != q.dtype for t in (k, v, *rest)):
        raise ValueError("flash_attn needs q, k, v (and o, do) of one dtype")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    if k.shape[:2] != (b, s) or k.shape[3] != dh or kvh == 0 or h % kvh:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)} "
                         "(B, S and dh equal, H a multiple of KV)")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attn takes head dims {HEAD_DIMS}, got {dh}")
    if s == 0 or h > _MAX_GRID_YZ or b > _MAX_GRID_YZ:
        raise ValueError(f"unsupported sizes B={b}, S={s}, H={h}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    for t in rest:
        if t.shape != q.shape:
            raise ValueError(f"o/do {tuple(t.shape)} must match q {tuple(q.shape)}")
    return b, s, h, kvh, dh, window or 0, _DTYPES[q.dtype], float(dh**-0.5)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_rows(name: str, x: torch.Tensor, b: int, h: int, s: int, dev) -> None:
    if x.dtype != torch.float32 or tuple(x.shape) != (b, h, s) or x.device != dev:
        raise ValueError(f"{name} must be float32 (B, H, S) = {(b, h, s)} on {dev}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def flash_fwd_kernel(q, k, v, window: Optional[int] = None):
    """q (B,S,H,dh), k/v (B,S,KV,dh) -> (o like q, lse (B,H,S) fp32)."""
    b, s, h, kvh, dh, win, dt, scale = _check(q, k, v, window)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    err = _fn("flash_fwd", 5)(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                              lse.data_ptr(), b, s, h, kvh, dh, win, dt, scale, _stream(q))
    fwd_launches.count += 1
    build.check_status(err, "flash_fwd")
    return o, lse


def flash_bwd_dq_kernel(q, k, v, o, do, lse, window: Optional[int] = None):
    """Backward pass 1 -> (dq like q, delta (B,H,S) fp32)."""
    b, s, h, kvh, dh, win, dt, scale = _check(q, k, v, window, o, do)
    _check_rows("lse", lse, b, h, s, q.device)
    dq = torch.empty_like(q)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    err = _fn("flash_bwd_dq", 8)(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                                 b, s, h, kvh, dh, win, dt, scale, _stream(q))
    dq_launches.count += 1
    build.check_status(err, "flash_bwd_dq")
    return dq, delta


def flash_bwd_dkv_kernel(q, k, v, do, lse, delta, window: Optional[int] = None):
    """Backward pass 2 -> (dk, dv) like k, summed over each KV head's query
    heads.  ``delta`` comes from :func:`flash_bwd_dq_kernel`."""
    b, s, h, kvh, dh, win, dt, scale = _check(q, k, v, window, do)
    _check_rows("lse", lse, b, h, s, q.device)
    _check_rows("delta", delta, b, h, s, q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = _fn("flash_bwd_dkv", 8)(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                  lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                  b, s, h, kvh, dh, win, dt, scale, _stream(q))
    dkv_launches.count += 1
    build.check_status(err, "flash_bwd_dkv")
    return dk, dv
