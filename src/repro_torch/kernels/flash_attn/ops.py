"""Public flash attention ops: dispatch on the tensors' device.

A CPU tensor takes the plain version (``ref.py``, tiled by the chunk sizes).
A CUDA tensor launches the hand-written kernels (their own 64-row tiles; the
chunk sizes only shape the plain version) or raises.  ``use_kernel=False``
forces the plain version on any device (for timing it on the card).  S must
be a multiple of both chunks (capped at S) on either path, as in the
reference.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels.flash_attn import kernel, ref


def _chunks(s: int, q_chunk: int, kv_chunk: int) -> tuple[int, int]:
    cq, ck = min(q_chunk, s), min(kv_chunk, s)
    if s % cq or s % ck:
        raise ValueError(f"sequence {s} is not a multiple of the chunks ({cq}, {ck})")
    return cq, ck


def flash_fwd(q, k, v, *, window: Optional[int] = None, q_chunk: int = 128,
              kv_chunk: int = 128, use_kernel: Optional[bool] = None):
    """q (B,S,H,dh), k/v (B,S,KV,dh) -> (o like q, lse (B,H,S) fp32)."""
    cq, ck = _chunks(q.shape[1], q_chunk, kv_chunk)
    if use_kernel is None:
        use_kernel = q.is_cuda
    if use_kernel:
        return kernel.flash_fwd_kernel(q.contiguous(), k.contiguous(), v.contiguous(), window)
    return ref.flash_fwd(q, k, v, window, cq, ck)


def flash_bwd(q, k, v, o, lse, do, *, window: Optional[int] = None, q_chunk: int = 128,
              kv_chunk: int = 128, use_kernel: Optional[bool] = None):
    """Gradients (dq, dk, dv) of the forward's o for the cotangent ``do``."""
    cq, ck = _chunks(q.shape[1], q_chunk, kv_chunk)
    if use_kernel is None:
        use_kernel = q.is_cuda
    if use_kernel:
        q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
        dq, delta = kernel.flash_bwd_dq_kernel(q, k, v, o, do, lse, window)
        dk, dv = kernel.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, window)
        return dq, dk, dv
    return ref.flash_bwd(q, k, v, o, lse, do, window, cq, ck)

