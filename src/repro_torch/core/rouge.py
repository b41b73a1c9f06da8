"""ROUGE-1 / ROUGE-2 / ROUGE-L (Lin, 2004) — paper Table 2's metrics."""
from __future__ import annotations

from collections import Counter


def _ngram_f1(hyp: list, ref: list, n: int) -> float:
    if len(hyp) < n or len(ref) < n:
        return 0.0
    hc = Counter(tuple(hyp[i : i + n]) for i in range(len(hyp) - n + 1))
    rc = Counter(tuple(ref[i : i + n]) for i in range(len(ref) - n + 1))
    overlap = sum((hc & rc).values())
    if overlap == 0:
        return 0.0
    p = overlap / max(sum(hc.values()), 1)
    r = overlap / max(sum(rc.values()), 1)
    return 2 * p * r / (p + r)


def _lcs(a: list, b: list) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge(hyp: str, ref: str) -> dict:
    h, r = hyp.lower().split(), ref.lower().split()
    out = {
        "rouge1": _ngram_f1(h, r, 1),
        "rouge2": _ngram_f1(h, r, 2),
    }
    l = _lcs(h, r)
    if l == 0 or not h or not r:
        out["rougeL"] = 0.0
    else:
        p, rc = l / len(h), l / len(r)
        out["rougeL"] = 2 * p * rc / (p + rc)
    return out


def rouge_corpus(hyps: list, refs: list) -> dict:
    scores = [rouge(h, r) for h, r in zip(hyps, refs)]
    keys = scores[0].keys() if scores else []
    return {k: sum(s[k] for s in scores) / max(len(scores), 1) for k in keys}
