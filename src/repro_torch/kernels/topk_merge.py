"""Host side of ``csrc/topk_merge.cuh``, the top-k bookkeeping the two
stage-1 scan kernels share: the list capacity, the merge's scratch size
and the zeroed workspace ``ivf_scan``'s tickets live in.
"""
from __future__ import annotations

import torch

CAP = 256  # list capacity, and the span of a tree-merged list (csrc: kCap)

_workspaces: dict = {}


def merge_stride(n: int, length: int, k: int) -> int:
    """Entries a query's n sorted lists of ``length`` occupy at any level of
    the tree merge (csrc: merge_stride): each level halves the lists and
    doubles their length up to k."""
    most = n * length
    while n > 1:
        n = (n + 1) // 2
        length = min(2 * length, k)
        most = max(most, n * length)
    return most


def workspace(device: torch.device, stream: int, words: int) -> torch.Tensor:
    """At least ``words`` zeroed 64-bit words for one CUDA stream of one
    device.  The kernel sets every word it touches back to 0 before it ends,
    so the allocation is made once and serves every later call on that
    stream; calls on other streams get their own."""
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws.numel() < words:
        ws = torch.zeros(max(words, 256), dtype=torch.int64, device=device)
        _workspaces[key] = ws
    return ws
