"""A frozen copy of the graph tokenizer's vocabulary and linearizer.

The vocabulary is built from the corpus texts (the most common words, then
1,024 hashed buckets for the rest); a prompt is

    [BOS] <query words> [CTX] <node words> [SEP] <node words> [SEP] ... [GEN]

with each text cut to ``node_budget`` words and the whole to ``max_len``
tokens.  The benchmark's queries use corpus words only, so the hashed
buckets (which follow Python's salted ``hash``) are never reached; a word
outside the vocabulary raises here instead.
"""
from __future__ import annotations

from collections import Counter

PAD, BOS, CTX, SEP, GEN = 0, 1, 2, 3, 4
N_SPECIAL = 6
N_HASH = 1024


def build_vocab(texts, max_words: int = 8192) -> dict:
    c = Counter()
    for t in texts:
        c.update(t.lower().split())
    return {w: i for i, (w, _) in enumerate(c.most_common(max_words))}


def vocab_size(vocab: dict) -> int:
    return N_SPECIAL + len(vocab) + N_HASH


def _encode(vocab: dict, text: str, budget: int) -> list:
    return [N_SPECIAL + vocab[w] for w in text.lower().split()[:budget]]


def linearize(vocab: dict, query_text: str, node_texts: list, max_len: int,
              node_budget: int) -> list:
    """The prompt's token ids (no padding)."""
    ids = [BOS] + _encode(vocab, query_text, node_budget) + [CTX]
    for t in node_texts:
        nt = _encode(vocab, t, node_budget)
        if len(ids) + len(nt) + 2 > max_len:
            break
        ids.extend(nt)
        ids.append(SEP)
    ids.append(GEN)
    return ids[:max_len]
