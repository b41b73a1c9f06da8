"""The benchmark's corpus: a frozen copy of the citation-graph generator.

``citation_graph`` is a preferential-attachment citation network with
community-biased features and node texts, at OGBN-Arxiv's node count and
feature width when the configuration asks for them.  It is copied here,
so that a change to the program's generator cannot change what the
benchmark serves; one seed gives the same arrays as the copy it was taken
from.  The result is plain NumPy: CSR arrays, features, and each node's
text as word ids into ``WORDS``.

Generating 169,343 nodes takes about 15 s of host time, so ``load``
keeps the arrays in a fixed directory of the checkout and reads them back
on later runs.
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np

WORDS = (
    "graph retrieval neural network attention model learning deep node edge "
    "embedding transformer language token subgraph query index semantic sparse "
    "dense steiner bfs traversal augmented generation context citation paper "
    "abstract method result dataset feature structure efficient scalable"
).split()

FORMAT = 1  # bump when the cached layout changes


def _topic_text_ids(rng: np.random.Generator, comm: np.ndarray, length: int = 24,
                    k: int = 8) -> np.ndarray:
    n_words = len(WORDS)
    probs = np.full((k, n_words), 1.0)
    for c in range(k):
        topic = rng.choice(n_words, size=n_words // k, replace=False)
        probs[c, topic] = 12.0
    probs /= probs.sum(axis=1, keepdims=True)
    out = np.empty((len(comm), length), np.uint8)
    for i, c in enumerate(comm):
        out[i] = rng.choice(n_words, size=length, p=probs[int(c)])
    return out


def citation_graph(n: int, avg_deg: int = 8, d_feat: int = 128, seed: int = 0) -> dict:
    """CSR arrays (``indptr`` int64, ``indices`` int32, both arc
    directions), ``feat`` (n, d_feat) float32 and ``text_ids`` (n, 24)
    uint8."""
    rng = np.random.default_rng(seed)
    m = max(1, avg_deg // 2)
    src, dst = [], []
    targets = list(range(min(m, n)))
    for v in range(m, n):
        choice = rng.choice(len(targets), size=m, replace=True)
        for c in choice:
            src.append(v)
            dst.append(targets[c])
        targets.extend([v] * m)
        targets.extend([targets[c] for c in choice])
    feat = rng.standard_normal((n, d_feat)).astype(np.float32)
    k = 8
    centers = rng.standard_normal((k, d_feat)).astype(np.float32) * 2.0
    comm = rng.integers(0, k, size=n)
    feat += centers[comm]
    text_ids = _topic_text_ids(rng, comm, k=k)
    s = np.asarray(src, np.int64)
    d = np.asarray(dst, np.int64)
    s, d = np.concatenate([s, d]), np.concatenate([d, s])
    order = np.argsort(s, kind="stable")
    s, d = s[order], d[order]
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(s, minlength=n), out=indptr[1:])
    return {"indptr": indptr, "indices": d.astype(np.int32), "feat": feat, "text_ids": text_ids}


def node_texts(text_ids: np.ndarray) -> list:
    """Each node's text as a string of words."""
    words = np.asarray(WORDS, dtype=object)
    return [" ".join(row) for row in words[text_ids]]


def _key(spec: dict) -> str:
    src = Path(__file__).read_bytes()
    blob = json.dumps(spec, sort_keys=True).encode() + src + str(FORMAT).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def load(spec: dict, cache_dir: Path) -> dict:
    """The corpus named by ``spec`` (``nodes``, ``avg_deg``, ``d_feat``,
    ``seed``), from ``cache_dir`` when a run has made it before."""
    path = Path(cache_dir) / f"corpus_{spec['nodes']}_{_key(spec)}.npz"
    if path.exists():
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    arrays = citation_graph(spec["nodes"], spec["avg_deg"], spec["d_feat"], spec["seed"])
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".part")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return arrays
