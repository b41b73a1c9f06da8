"""Launch wrappers of the hand-written CUDA kernels ``csrc/flash_attn.cu``:
the FlashAttention-2 forward and the two passes of its backward.

Each wrapper checks what its kernel takes (one Hopper card, contiguous
tensors, fp32 or bf16, dh in ``HEAD_DIMS``, H a multiple of KV), raises
on anything else, allocates the outputs, launches on the tensors' card
(made current for the call) and its current stream, and counts the launch.  The dq pass writes ``delta`` for the dk/dv pass, which
must be launched after it on the same stream.

The C side picks each pass's kernel by (type, dh): bf16 at dh 64 and 128
runs all three passes on the tensor cores (and refuses a tensor that does
not start on 16 bytes); fp32 at every dh and bf16 at dh 8 and 16 run the
CUDA-core kernels.  The tensor-core forward serves a head group of query
heads of one KV head per block.  The tensor-core dk/dv pass splits each KV
head's query heads into groups, whose fp32 partials land in a scratch that
this wrapper allocates at the size ``flash_bwd_dkv_plan`` gives, and a
second kernel of the same call sums them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

fwd_launches = build.LaunchCounter()
dq_launches = build.LaunchCounter()
dkv_launches = build.LaunchCounter()

HEAD_DIMS = (8, 16, 64, 128)  # every d_head of the reference's configs
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65_535

_P, _I, _F, _IP = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.POINTER(ctypes.c_int)
_ARGTYPES = {  # pointers, ints, scale, stream
    "flash_fwd": [_P] * 5 + [_I] * 7 + [_F, _P],
    "flash_bwd_dq": [_P] * 8 + [_I] * 7 + [_F, _P],
    "flash_bwd_dkv": [_P] * 9 + [_I] * 8 + [_F, _P],
    "flash_bwd_dkv_plan": [_I] * 7 + [_IP, ctypes.POINTER(ctypes.c_longlong)],
    "flash_tc_occupancy": [_I] * 3 + [_IP] * 3,
}


def _fn(name: str):
    fn = getattr(build.library(), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def dkv_plan(device: int, b: int, s: int, h: int, kvh: int, dh: int, window: int,
             dtype: int) -> tuple[int, int]:
    """(query-head groups, fp32 scratch elements) of the dk/dv pass at this
    shape on CUDA ``device``, as the C side plans them; (0, 0) where the
    pass runs the CUDA-core kernel.  ``window`` 0 is causal only and
    ``dtype`` the C code (0 fp32, 1 bf16)."""
    groups, scratch = ctypes.c_int(), ctypes.c_longlong()
    with torch.cuda.device(device):
        err = _fn("flash_bwd_dkv_plan")(b, s, h, kvh, dh, window, dtype, ctypes.byref(groups),
                                        ctypes.byref(scratch))
    build.check_status(err, "flash_bwd_dkv_plan")
    return groups.value, scratch.value


@functools.lru_cache(maxsize=None)
def tc_occupancy(pass_: int, dh: int, rep: int = 1) -> tuple[int, int, int]:
    """(threads a block, dynamic shared memory in bytes, blocks an SM holds)
    of the tensor-core kernel of pass 0 (dq), 1 (dk/dv) or 2 (the forward,
    whose head group, threads / 128, follows ``rep`` = H / KV) at ``dh``,
    from the card's occupancy calculator; for reports."""
    threads, smem, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = _fn("flash_tc_occupancy")(pass_, dh, rep, ctypes.byref(threads), ctypes.byref(smem),
                                    ctypes.byref(blocks))
    build.check_status(err, "flash_tc_occupancy")
    return threads.value, smem.value, blocks.value


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
    with torch.cuda.device(q.device):
        err = _fn("flash_fwd")(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                               lse.data_ptr(), b, s, h, kvh, dh, win, dt, scale, _stream(q))
    build.check_status(err, "flash_fwd")
    fwd_launches.bump(q.device)
    return o, lse


def flash_bwd_dq_kernel(q, k, v, o, do, lse, window: Optional[int] = None):
    """Backward pass 1 -> (dq like q, delta (B,H,S) fp32)."""
    b, s, h, kvh, dh, win, dt, scale = _check(q, k, v, window, o, do)
    _check_rows("lse", lse, b, h, s, q.device)
    dq = torch.empty_like(q)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _fn("flash_bwd_dq")(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                  do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                                  b, s, h, kvh, dh, win, dt, scale, _stream(q))
    build.check_status(err, "flash_bwd_dq")
    dq_launches.bump(q.device)
    return dq, delta


def flash_bwd_dkv_kernel(q, k, v, do, lse, delta, window: Optional[int] = None):
    """Backward pass 2 -> (dk, dv) like k, summed over each KV head's query
    heads.  ``delta`` comes from :func:`flash_bwd_dq_kernel`.  One call is
    one counted launch, the tensor-core path's partial-sum kernel included."""
    b, s, h, kvh, dh, win, dt, scale = _check(q, k, v, window, do)
    _check_rows("lse", lse, b, h, s, q.device)
    _check_rows("delta", delta, b, h, s, q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    groups, scratch = dkv_plan(q.device.index, b, s, h, kvh, dh, win, dt)
    part = torch.empty(scratch, dtype=torch.float32, device=q.device) if scratch else None
    with torch.cuda.device(q.device):
        err = _fn("flash_bwd_dkv")(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                   lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                   None if part is None else part.data_ptr(), b, s, h, kvh, dh,
                                   win, dt, groups, scale, _stream(q))
    build.check_status(err, "flash_bwd_dkv")
    dkv_launches.bump(q.device)
    return dk, dv
