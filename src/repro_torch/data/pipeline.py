"""Data pipeline: synthetic corpora, RAG-augmented token streams, host
sharding (the reference's ``repro.data.pipeline``).

The paper's abstract-generation task maps to: for each query node, retrieve
a subgraph, linearize it (the tokenization stage), and train the LM to
produce the node's own text given the retrieved context.
``rag_token_stream`` builds that stream, each batch one retrieval wave of
the pipeline on its device, so retrieval is *in the training data path* (the
paper's Fig. 2 setting, where retrieval time stacks on learning time).  The
linearization runs on the host, as in the reference, and the batch lands on
``device`` as tensors whose values equal the reference's arrays.

``host_shard_iter`` does deterministic host sharding with elastic
re-assignment (rendezvous hashing from ``distributed.fault``) for the
multi-host posture.  Out-of-vocabulary words hash with Python's salted
``hash()``, so two processes' streams agree only on in-vocabulary words.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.tokenization import subgraph_texts
from repro_torch.distributed.fault import elastic_shard_assignment


def synthetic_corpus(n_docs: int = 1000, seed: int = 0, length: int = 32) -> list:
    from repro_torch.graph.generators import _texts

    rng = np.random.default_rng(seed)
    return _texts(rng, n_docs, length)


@dataclasses.dataclass
class TokenDataset:
    """Fixed-length LM samples from a list of token id sequences (host
    arrays, as the reference keeps them)."""

    ids: np.ndarray  # (n, L) int32
    mask: np.ndarray  # (n, L) bool

    @staticmethod
    def from_texts(texts, vocab, max_len: int = 128) -> "TokenDataset":
        ids = np.zeros((len(texts), max_len), np.int32)
        mask = np.zeros((len(texts), max_len), bool)
        for i, t in enumerate(texts):
            enc = [1] + [vocab.encode_word(w) for w in t.lower().split()][: max_len - 1]
            ids[i, : len(enc)] = enc
            mask[i, : len(enc)] = True
        return TokenDataset(ids=ids, mask=mask)

    def batches(self, batch: int, seed: int = 0, shard: tuple = (0, 1)) -> Iterator:
        """Infinite shuffled batches; (shard_id, n_shards) host sharding."""
        rng = np.random.default_rng(seed)
        sid, ns = shard
        idx = np.arange(len(self.ids))
        idx = idx[idx % ns == sid]
        while True:
            order = rng.permutation(idx)
            for s in range(0, len(order) - batch + 1, batch):
                sel = order[s : s + batch]
                yield {"tokens": self.ids[sel], "loss_mask": self.mask[sel]}


def rag_token_stream(
    pipeline, query_texts: list, query_emb, target_texts: list,
    batch: int = 8, max_len: int = 256, seed: int = 0, device=None,
) -> Iterator:
    """RAG-augmented LM batches: prompt = linearized retrieved subgraph,
    loss only on the target continuation (prompt tokens are context).
    ``query_emb`` is a host array or a tensor; each batch's rows go to the
    pipeline's device for retrieval.  Yields ``tokens`` (int32) and
    ``loss_mask`` (bool) on ``device`` (default: the pipeline's)."""
    rng = np.random.default_rng(seed)
    n = len(query_texts)
    tok = pipeline.tokenizer
    dev = pipeline.device if device is None else torch.device(device)
    while True:
        sel = rng.integers(0, n, size=batch)
        if isinstance(query_emb, torch.Tensor):
            qe = query_emb[torch.from_numpy(sel).to(query_emb.device)]
        else:
            qe = np.asarray(query_emb)[sel]
        sub = pipeline.retrieve(qe).sub
        node_texts = subgraph_texts(sub, pipeline.node_text)
        ids = np.zeros((batch, max_len), np.int32)
        lmask = np.zeros((batch, max_len), bool)
        for i, qi in enumerate(sel):
            p_ids, p_mask = tok.linearize(query_texts[qi], node_texts[i])
            plen = int(p_mask.sum())
            tgt = [tok.vocab.encode_word(w) for w in target_texts[qi].lower().split()]
            room = max_len - plen
            tgt = tgt[:room]
            ids[i, :plen] = p_ids[:plen]
            ids[i, plen : plen + len(tgt)] = tgt
            lmask[i, max(plen - 1, 0) : plen + len(tgt) - 1] = True  # predict target
        yield {"tokens": torch.from_numpy(ids).to(dev), "loss_mask": torch.from_numpy(lmask).to(dev)}


def host_shard_iter(files: list, host: int, hosts: list) -> list:
    """Files this host owns under the current elastic assignment."""
    assign = elastic_shard_assignment(len(files), hosts)
    return [f for i, f in enumerate(files) if assign[i] == host]
