"""Stage 4 of the RGL pipeline: tokenization (paper §2.1.4).

A word-level tokenizer (vocab built from the corpus, hashed OOV buckets) and
a graph linearizer that renders a retrieved subgraph into a budgeted prompt:

    [BOS] <query tokens> [CTX] <node_0 tokens> [SEP] <node_1 tokens> ... [GEN]

Node order = retrieval priority (closest/densest first), so truncation under
the token budget drops the least relevant context first — the mechanism the
paper's dynamic filtering feeds.  Output is fixed-shape (L,) int32 + mask.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

PAD, BOS, CTX, SEP, GEN, UNK = 0, 1, 2, 3, 4, 5
N_SPECIAL = 6


@dataclasses.dataclass
class Vocab:
    word_to_id: dict
    n_hash: int = 1024

    @property
    def size(self) -> int:
        return N_SPECIAL + len(self.word_to_id) + self.n_hash

    def encode_word(self, w: str) -> int:
        i = self.word_to_id.get(w)
        if i is not None:
            return N_SPECIAL + i
        return N_SPECIAL + len(self.word_to_id) + (hash(w) % self.n_hash)

    @staticmethod
    def build(corpus, max_words: int = 8192, n_hash: int = 1024) -> "Vocab":
        from collections import Counter

        c = Counter()
        for text in corpus:
            c.update(text.lower().split())
        keep = [w for w, _ in c.most_common(max_words)]
        return Vocab({w: i for i, w in enumerate(keep)}, n_hash=n_hash)


class GraphTokenizer:
    def __init__(self, vocab: Vocab, max_len: int = 512, node_budget: int = 48):
        self.vocab = vocab
        self.max_len = max_len
        self.node_budget = node_budget  # max tokens contributed per node

    def encode_text(self, text: str, budget: int) -> list:
        return [self.vocab.encode_word(w) for w in text.lower().split()[:budget]]

    def linearize(
        self,
        query_text: str,
        node_texts: list,  # ordered retrieved-node texts (already filtered)
    ) -> tuple[np.ndarray, np.ndarray]:
        ids = [BOS] + self.encode_text(query_text, self.node_budget) + [CTX]
        for t in node_texts:
            nt = self.encode_text(t, self.node_budget)
            if len(ids) + len(nt) + 2 > self.max_len:
                break
            ids.extend(nt)
            ids.append(SEP)
        ids.append(GEN)
        ids = ids[: self.max_len]
        out = np.full(self.max_len, PAD, dtype=np.int32)
        out[: len(ids)] = ids
        mask = np.zeros(self.max_len, dtype=bool)
        mask[: len(ids)] = True
        return out, mask

    def batch_linearize(self, query_texts, node_texts_per_query):
        ids, masks = zip(
            *(self.linearize(q, ns) for q, ns in zip(query_texts, node_texts_per_query))
        )
        return np.stack(ids), np.stack(masks)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def subgraph_texts(sub, node_text: list) -> list:
    """Materialize per-query ordered node texts from a Subgraph (host side)."""
    out = []
    nodes = _host(sub.nodes)
    mask = _host(sub.mask)
    for qi in range(nodes.shape[0]):
        out.append([node_text[int(v)] for v, m in zip(nodes[qi], mask[qi]) if m])
    return out
