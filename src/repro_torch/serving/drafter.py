"""Prompt-lookup drafter for self-speculative decode.

No second model: drafts for each slot come from the request's own token
history (prompt + everything emitted so far).  The drafter finds the most
recent *earlier* occurrence of the history's trailing bigram (falling back
to the trailing unigram) and proposes the tokens that followed it: the
prompt-lookup / n-gram scheme, which pays off when generation repeats
(answers that quote retrieved node text, the short greedy cycles a small LM
falls into).

The lookup is fixed-shape tensor code over the (slots, hist_cap) history
arena on the slots' device: no per-slot Python loop, output (slots,
n_draft) however many slots are live.  A wrong draft costs no correctness
(verification rejects it), so dead slots propose whatever their stale
history gives.
"""
from __future__ import annotations

import torch


def draft_tokens(hist: torch.Tensor, hist_len: torch.Tensor, n_draft: int) -> torch.Tensor:
    """Propose ``n_draft`` continuation tokens per slot from its history.

    hist (B, H) int32 token history per slot, left-aligned (the last valid
    entry is the slot's current committed token); hist_len (B,) valid
    counts (0 for dead slots).  Returns (B, n_draft) int32: the
    continuation after the most recent earlier match of the trailing
    bigram (unigram fallback), extrapolated cyclically (past the end of
    history it wraps back to the match point, so a locked period-p loop is
    drafted exactly for any p).  Where nothing matches, the draft repeats
    the last committed token.
    """
    b, h = hist.shape
    dev = hist.device
    idx = torch.arange(h, dtype=torch.int32, device=dev)[None, :]  # (1, H)
    ln = hist_len[:, None].to(torch.int32)  # (B, 1)
    last = torch.gather(hist, 1, torch.clamp(ln - 1, min=0).long())  # (B, 1)
    prev = torch.gather(hist, 1, torch.clamp(ln - 2, min=0).long())
    shifted = torch.cat([torch.full((b, 1), -1, dtype=hist.dtype, device=dev), hist[:, :-1]],
                        dim=1)  # shifted[j] = hist[j-1]
    cont = idx <= ln - 2  # a continuation token exists at idx + 1
    bigram = (hist == last) & (shifted == prev) & cont & (idx >= 1) & (ln >= 2)
    unigram = (hist == last) & cont & (ln >= 1)
    none = torch.full_like(idx, -1)
    j_big = torch.where(bigram, idx, none).amax(dim=1)  # most recent match
    j_uni = torch.where(unigram, idx, none).amax(dim=1)
    j = torch.where(j_big >= 0, j_big, j_uni)  # (B,) -1 = no match
    # continuation positions j+1.., wrapped modulo the distance from the
    # match to the end of history (the loop period once generation cycles)
    period = torch.clamp(ln[:, 0] - 1 - j, min=1)[:, None]  # (B, 1)
    off = torch.arange(n_draft, dtype=torch.int32, device=dev)[None, :]
    pos = j[:, None] + 1 + off % period
    draft = torch.gather(hist, 1, torch.clamp(pos, 0, h - 1).long())
    return torch.where(j[:, None] >= 0, draft, last).to(torch.int32)
