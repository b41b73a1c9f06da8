"""Plain PyTorch versions of the IVF candidate scan: each query scored
against its own candidate ids, top-k by (score desc, candidate position asc).

``ivf_candidate_scan`` is the dense arm (one (Q, W, D) gather, the
reference's ``ref.py``); ``ivf_scan_tiled`` is the tiled arm (a loop over
c_blk-wide chunks merged into a running top-k, the reference's
``kernel.py:ivf_scan_tiled``).  The two compute the same function.  Every
score is summed in the card kernel's order (:func:`dot_scores`), so the
kernel is held to these bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.topk_sim.ref import lex_order, stable_topk

_I32_MAX = torch.iinfo(torch.int32).max


def dot_scores(q: torch.Tensor, ce: torch.Tensor) -> torch.Tensor:
    """q (Q, D) . ce (Q, W, D) -> (Q, W) fp32, summed as the kernel sums:
    the rounded products, 32 lane-strided partial sums (column l, l + 32,
    ... in order, from +0), then a halving tree (16, 8, 4, 2, 1)."""
    qn, w, d = ce.shape
    dp = -(-d // 32) * 32
    p = ce.float() * q.float()[:, None, :]
    if dp != d:
        p = F.pad(p, (0, dp - d))
    p = p.view(qn, w, dp // 32, 32)
    acc = torch.zeros((qn, w, 32), dtype=torch.float32, device=ce.device)
    for j in range(dp // 32):
        acc = acc + p[:, :, j]
    for o in (16, 8, 4, 2, 1):
        acc = acc[..., :o] + acc[..., o:2 * o]
    return acc[..., 0]


def _scores(q, emb, cand, cmask):
    """Masked scores of one block of candidate slots; sentinel ids (N) are
    clamped for the gather and never score (their mask is False)."""
    ce = emb[cand.long().clamp(max=emb.shape[0] - 1)]
    return dot_scores(q, ce).masked_fill(~cmask, float("-inf"))


def ivf_candidate_scan(q, emb, cand, cmask, k: int):
    """q (Q, D); emb (N, D); cand (Q, W) int32 ids in [0, N] (N = sentinel);
    cmask (Q, W) bool, False at sentinel slots; k <= W.

    Returns (scores (Q, k), ids (Q, k)) by score desc, ties to the earlier
    candidate position.  Ids are the raw cand values: on a row with fewer
    than k live slots the tail holds the lowest-position masked slots' ids."""
    top_s, pos = stable_topk(_scores(q, emb, cand, cmask), k)
    return top_s, torch.gather(cand, 1, pos)


def ivf_scan_tiled(q, emb, cand, cmask, k: int, *, c_blk: int = 1024):
    """The tiled arm: W % c_blk == 0, k <= W.  Each chunk's top-min(k, c_blk)
    merges into a running (Q, k) ordered by (score desc, position asc),
    which starts at (-inf, int32 max, sentinel) and so loses every tie to a
    real position.  Same result as :func:`ivf_candidate_scan`."""
    qn, w = cand.shape
    assert w % c_blk == 0 and k <= w, (w, c_blk, k)
    n = emb.shape[0]
    kt = min(k, c_blk)
    dev = cand.device
    run_s = torch.full((qn, k), float("-inf"), dtype=torch.float32, device=dev)
    run_p = torch.full((qn, k), _I32_MAX, dtype=torch.int64, device=dev)
    run_i = torch.full((qn, k), n, dtype=cand.dtype, device=dev)
    for base in range(0, w, c_blk):
        c_ids, c_m = cand[:, base:base + c_blk], cmask[:, base:base + c_blk]
        cs, cloc = stable_topk(_scores(q, emb, c_ids, c_m), kt)
        ms = torch.cat([run_s, cs], 1)
        mp = torch.cat([run_p, cloc + base], 1)
        mi = torch.cat([run_i, torch.gather(c_ids, 1, cloc)], 1)
        order = lex_order(ms, mp)[:, :k]
        run_s, run_p, run_i = (torch.gather(x, 1, order) for x in (ms, mp, mi))
    return run_s, run_i
