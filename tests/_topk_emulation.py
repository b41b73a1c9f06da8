"""A NumPy emulation of ``csrc/topk_merge.cuh``, the top-k bookkeeping the
two stage-1 scan kernels share (their tests emulate each kernel's walk on
top of it): a running list's insertion and the tree merge of a query's
lists.  An entry is (key, score, index), the key a 64-bit integer that
orders entries as the kernels' better() does."""
import bisect

import numpy as np

PAD_ID = 2**31 - 1


def key(s, i):
    """A 64-bit key ordering (score desc, index asc) as better() does:
    larger = earlier, -0 keyed as +0 (the scores compare equal)."""
    s = np.float32(0.0) if s == 0 else np.float32(s)
    u = int(np.array(s, np.float32).view(np.uint32))
    u = (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)
    return (u << 32) | (0xFFFFFFFF - int(i))


PAD = (key(-np.inf, PAD_ID), np.float32(-np.inf), PAD_ID)


def insert(lst, entry, stats):
    """topk_merge.cuh list_insert: entries kept by descending key; the last
    falls off; an entry past the end is dropped."""
    keys = [-e[0] for e in lst]
    pos = bisect.bisect_left(keys, -entry[0])
    if pos < len(lst):
        lst.insert(pos, entry)
        lst.pop()
        stats["inserts"] = stats.get("inserts", 0) + 1


def merge_tree(lists, k, stride):
    """topk_merge.cuh merge_tree for one query: pairs merged a level at a
    time, each entry placed at its index plus a binary search in the
    partner (the first list first among equal entries), the first min(2
    len, k) kept; every level within ``stride`` entries."""
    length = len(lists[0])
    assert len(lists) * length <= stride
    while len(lists) > 1:
        n2, len2 = -(-len(lists) // 2), min(2 * length, k)
        assert n2 * len2 <= stride
        out = []
        for p in range(n2):
            a = lists[2 * p]
            b = lists[2 * p + 1] if 2 * p + 1 < len(lists) else None
            merged = [None] * len2
            for x, e in enumerate(a):
                pos = x + (sum(f[0] > e[0] for f in b) if b is not None else 0)
                if pos < len2:
                    merged[pos] = e
            for y in range(length):
                e = b[y] if b is not None else PAD
                pos = y + (sum(f[0] >= e[0] for f in a) if b is not None else length)
                if pos < len2:
                    merged[pos] = e
            assert all(e is not None for e in merged)
            out.append(merged)
        lists, length = out, len2
    return lists[0][:k]
