"""Public workset hop-expansion ops: membership mark dispatch + one hop.

``ws_member`` dispatches on the tensors' device: a CPU tensor takes the plain
version (``ref.py``), a CUDA tensor launches the hand-written kernel at every
size or raises; ``use_kernel=False`` forces the plain version on any device.

``expand_hop`` is the full fixed-shape hop: a ``(Q, C, K)`` neighbour gather
over the workset followed by a sort/unique dedup-merge.  Every heavy step is
a single-key int32 sort over packed keys: ``id * band + dist`` for the
id-major dedup sort, ``dist * (n+1) + id`` for the distance-major truncation
sort, where ``band = max_hops + 2`` (every live distance is <= max_hops;
slot ``band-1`` is the sentinel clamp).  Equal keys are equal values, so no
sort's tie order can matter.  This caps the compact path at
``(max_hops + 2) * (n + 1) < 2**31``.

Two arms produce bit-identical results (the reference's two arms):

* sort arm — workset and candidates concat into one id-major sort; the
  first entry of each id group carries the minimum distance (existing
  entries always win: their distance is <= h < h+1).
* mark arm — the membership mark (``ws_member``) first marks candidates
  already in the workset, so only fresh ids enter the dedup sort.

``use_kernel=None`` takes the mark arm on a CUDA tensor (the kernel) and
the sort arm on a CPU tensor; ``use_kernel=True`` on a CPU tensor runs the
mark arm with the plain ``ws_member``.

Truncation under overflow is deterministic and identical in both arms:
surviving entries are the capacity-C smallest by (distance, id) — since
every existing entry's distance is < the hop's, complete hops are kept
whole and the overflowing hop keeps its lowest fresh ids.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.frontier_expand import kernel, ref

INF = 0x3FFFFFF
_MAX32 = 2**31 - 1


def ws_member(
    ws_ids: torch.Tensor,  # (Q, C) int32 sorted ascending per row
    cand: torch.Tensor,  # (Q, W) int32
    *,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """(Q, W) bool membership of each candidate in its row's sorted workset."""
    if use_kernel is None:
        use_kernel = cand.is_cuda
    if not use_kernel:
        return ref.ws_member(ws_ids, cand)
    return kernel.ws_mark_kernel(ws_ids.contiguous(), cand.contiguous())


def _first_of_group(ids: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """First occurrence of each id along a sorted row."""
    prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], 1)
    return real & (ids != prev)


def _sort(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, dim=1).values


def hop_candidates(ws_ids: torch.Tensor, nbr: torch.Tensor, nbr_mask: torch.Tensor):
    """(Q, C*K) int32 neighbour ids of every workset entry, row by row in
    ELL slot order; the sentinel n where the entry or the slot is not live."""
    q, c = ws_ids.shape
    n, k = nbr.shape
    valid = ws_ids < n
    safe = torch.clamp(ws_ids, max=n - 1).long()
    return torch.where(valid[:, :, None] & nbr_mask[safe], nbr[safe], n).reshape(q, c * k)


def expand_hop(
    ws_ids: torch.Tensor,  # (Q, C) int32 sorted ascending, sentinel n padded
    ws_dist: torch.Tensor,  # (Q, C) int32 hop distance, INF at padding
    nbr: torch.Tensor,  # (N, K) int32 ELL adjacency, sentinel n
    nbr_mask: torch.Tensor,  # (N, K) bool
    hop_dist: int,  # in [1, band-2]: distance of the nodes added now
    *,
    band: int,  # max_hops + 2: exclusive upper bound on packed distances
    use_kernel: Optional[bool] = None,
):
    """One workset expansion hop (see the module docstring).

    ``hop_dist`` must be strictly greater than every live distance in
    ``ws_dist`` (BFS expansion always satisfies this).

    Returns ``(ws_ids', ws_dist', fresh (Q,) int32, dropped (Q,) bool)``:
    ``fresh`` counts distinct new ids proposed (before truncation) and
    ``dropped`` flags rows whose merge exceeded the capacity.
    """
    q, c = ws_ids.shape
    n, k = nbr.shape
    if band * (n + 1) >= 2**31:
        raise ValueError(
            f"compact path needs (max_hops + 2) * (n + 1) < 2**31; got band={band}, n={n}"
        )
    n1 = n + 1
    thr = band * n1  # every real packed key (either packing) is < thr
    hd = int(hop_dist)
    valid = ws_ids < n
    cand = hop_candidates(ws_ids, nbr, nbr_mask)
    live_dist = torch.where(valid, ws_dist, 0)

    mark = ws_ids.is_cuda if use_kernel is None else use_kernel
    if mark:
        # mark members first; only fresh ids enter the sort
        present = ws_member(ws_ids, cand)
        k1 = _sort(torch.where(present | (cand >= n), _MAX32, cand * band + hd))  # id-major
        id1 = torch.where(k1 < thr, k1 // band, n)
        first = _first_of_group(id1, id1 < n)
        k2 = _sort(torch.where(first, hd * n1 + id1, _MAX32))
        if c * k > c:
            over_fresh = k2[:, c] < thr
        else:
            over_fresh = torch.zeros((q,), dtype=torch.bool, device=ws_ids.device)
        old = torch.where(valid, live_dist * n1 + ws_ids, _MAX32)
        k3 = _sort(torch.cat([old, k2[:, :c]], 1))  # (Q, 2C)
        fresh_n = first.sum(1, dtype=torch.int32)
        dropped = over_fresh | (k3[:, c] < thr)
        keep = k3[:, :c]
    else:
        # one id-major sort over workset + candidates; the first entry of
        # each id group is the keeper (min distance)
        old = torch.where(valid, ws_ids * band + live_dist, _MAX32)
        new = torch.where(cand < n, cand * band + hd, _MAX32)
        k1 = _sort(torch.cat([old, new], 1))  # (Q, C + C*K)
        id1 = torch.where(k1 < thr, k1 // band, n)
        d1 = k1 % band
        first = _first_of_group(id1, id1 < n)
        k2 = _sort(torch.where(first, d1 * n1 + id1, _MAX32))
        fresh_n = (first & (d1 == hd)).sum(1, dtype=torch.int32)
        dropped = k2[:, c] < thr
        keep = k2[:, :c]

    # repack (dist, id) -> id-major, restore sentinels, final small sort
    live = keep < thr
    kid = torch.where(live, keep % n1, n)
    kd = torch.where(live, keep // n1, band - 1)
    k4 = _sort(kid * band + kd)  # (Q, C)
    out_ids = (k4 // band).to(torch.int32)
    out_dist = torch.where(out_ids < n, k4 % band, INF).to(torch.int32)
    return out_ids, out_dist, fresh_n, dropped
