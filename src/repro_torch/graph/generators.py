"""Synthetic graph generators mirroring the paper's dataset shapes.

Seeded stand-ins for OGBN-Arxiv (citation), Amazon Baby/Sports (bipartite
multimodal recsys) and the GNN-shape graphs, copied from the reference
(``repro.graph.generators``) so one seed gives byte-identical graphs.
Scales are parameterized so tests use tiny versions and benchmarks mid-size.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph

_WORDS = (
    "graph retrieval neural network attention model learning deep node edge "
    "embedding transformer language token subgraph query index semantic sparse "
    "dense steiner bfs traversal augmented generation context citation paper "
    "abstract method result dataset feature structure efficient scalable"
).split()


def _texts(rng: np.random.Generator, n: int, length: int = 24) -> list:
    ids = rng.integers(0, len(_WORDS), size=(n, length))
    return [" ".join(_WORDS[w] for w in row) for row in ids]


def _topic_texts(
    rng: np.random.Generator, comm: np.ndarray, length: int = 24, k: int = 8,
) -> list:
    """Community-biased texts: each community favors its own word subset, so
    graph/feature neighborhoods share vocabulary (the structure the paper's
    abstract-generation task exploits)."""
    n_words = len(_WORDS)
    probs = np.full((k, n_words), 1.0)
    for c in range(k):
        topic = rng.choice(n_words, size=n_words // k, replace=False)
        probs[c, topic] = 12.0
    probs /= probs.sum(axis=1, keepdims=True)
    out = []
    for c in comm:
        ids = rng.choice(n_words, size=length, p=probs[int(c)])
        out.append(" ".join(_WORDS[w] for w in ids))
    return out


def citation_graph(
    n: int = 2000, avg_deg: int = 8, d_feat: int = 128, seed: int = 0,
    with_text: bool = True,
) -> CSRGraph:
    """Preferential-attachment citation network (OGBN-Arxiv stand-in)."""
    rng = np.random.default_rng(seed)
    m = max(1, avg_deg // 2)
    src, dst = [], []
    targets = list(range(min(m, n)))
    for v in range(m, n):
        # preferential attachment: sample from current endpoint pool
        choice = rng.choice(len(targets), size=m, replace=True)
        for c in choice:
            src.append(v)
            dst.append(targets[c])
        targets.extend([v] * m)
        targets.extend([targets[c] for c in choice])
    feat = rng.standard_normal((n, d_feat)).astype(np.float32)
    # community structure in BOTH features and texts so retrieval is
    # meaningful (semantic index and textual context agree)
    k = 8
    centers = rng.standard_normal((k, d_feat)).astype(np.float32) * 2.0
    comm = rng.integers(0, k, size=n)
    feat += centers[comm]
    text = _topic_texts(rng, comm, k=k) if with_text else None
    return CSRGraph.from_edges(
        np.array(src), np.array(dst), n, symmetrize=True,
        node_feat=feat, node_text=text,
    )


def bipartite_recsys_graph(
    n_users: int = 1000, n_items: int = 400, n_inter: int = 8000,
    d_modal: int = 64, seed: int = 0,
) -> tuple[CSRGraph, np.ndarray, np.ndarray]:
    """User-item interaction graph (Baby/Sports stand-in).

    Returns (graph, item_modal_feat, is_item_mask).  Nodes 0..n_users-1 are
    users; n_users..n_users+n_items-1 are items.  Items carry modality
    features with latent-factor structure (so completion is learnable).
    """
    rng = np.random.default_rng(seed)
    n = n_users + n_items
    d_lat = 16
    u_lat = rng.standard_normal((n_users, d_lat)).astype(np.float32)
    i_lat = rng.standard_normal((n_items, d_lat)).astype(np.float32)
    logits = u_lat @ i_lat.T  # (U, I)
    # sample interactions proportional to affinity
    flat_p = np.exp(logits / 2.0).ravel()
    flat_p /= flat_p.sum()
    picks = rng.choice(n_users * n_items, size=min(n_inter, n_users * n_items),
                       replace=False, p=flat_p)
    u, i = np.divmod(picks, n_items)
    proj = rng.standard_normal((d_lat, d_modal)).astype(np.float32)
    modal = i_lat @ proj + 0.1 * rng.standard_normal((n_items, d_modal)).astype(np.float32)
    feat = np.zeros((n, d_modal), dtype=np.float32)
    feat[n_users:] = modal
    g = CSRGraph.from_edges(u, i + n_users, n, symmetrize=True, node_feat=feat)
    is_item = np.zeros(n, dtype=bool)
    is_item[n_users:] = True
    return g, modal, is_item


def random_regular_graph(n: int, deg: int, d_feat: int = 64, seed: int = 0) -> CSRGraph:
    """Near-regular random graph (full_graph / ogb_products stand-in shapes)."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n, size=(n, deg))
    src = np.repeat(np.arange(n), deg)
    feat = rng.standard_normal((n, d_feat)).astype(np.float32)
    return CSRGraph.from_edges(src, dst.ravel(), n, symmetrize=True, node_feat=feat)


def molecule_graphs(
    n_graphs: int = 128, n_nodes: int = 30, n_edges: int = 64,
    d_feat: int = 16, seed: int = 0,
) -> list:
    """Batch of small molecule-like graphs with 3D positions in node_feat[:, :3]."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n_graphs):
        pos = rng.standard_normal((n_nodes, 3)).astype(np.float32)
        # connect nearest neighbors until ~n_edges arcs
        d2 = ((pos[:, None] - pos[None]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        kn = max(1, n_edges // n_nodes)
        nbrs = np.argsort(d2, axis=1)[:, :kn]
        src = np.repeat(np.arange(n_nodes), kn)
        feat = np.concatenate(
            [pos, rng.standard_normal((n_nodes, d_feat - 3)).astype(np.float32)], axis=1
        )
        out.append(
            CSRGraph.from_edges(src, nbrs.ravel(), n_nodes, symmetrize=True, node_feat=feat)
        )
    return out
