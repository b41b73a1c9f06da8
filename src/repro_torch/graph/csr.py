"""Compressed-sparse-row graph container (host side, numpy).

This is the canonical exchange format of the library: generators emit it,
samplers consume it, and :func:`repro_torch.graph.ell.csr_to_ell` converts it into
the device-side padded format.  Mirrors the role of RGL's C++ graph index.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    """Directed graph in CSR form.  ``indices[indptr[u]:indptr[u+1]]`` are the
    out-neighbors of ``u``.  Undirected graphs store both arc directions."""

    indptr: np.ndarray  # (N+1,) int64
    indices: np.ndarray  # (E,) int32
    num_nodes: int
    node_feat: Optional[np.ndarray] = None  # (N, F) float32
    edge_feat: Optional[np.ndarray] = None  # (E, Fe) float32
    node_text: Optional[list] = None  # list[str] textual payloads (RAG corpus)

    def __post_init__(self):
        assert self.indptr.shape == (self.num_nodes + 1,)
        self.indptr = np.asarray(self.indptr, dtype=np.int64)
        self.indices = np.asarray(self.indices, dtype=np.int32)

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)

    def neighbors(self, u: int) -> np.ndarray:
        return self.indices[self.indptr[u] : self.indptr[u + 1]]

    @staticmethod
    def from_edges(
        src: np.ndarray,
        dst: np.ndarray,
        num_nodes: int,
        *,
        symmetrize: bool = False,
        node_feat: Optional[np.ndarray] = None,
        edge_feat: Optional[np.ndarray] = None,
        node_text: Optional[list] = None,
    ) -> "CSRGraph":
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if symmetrize:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
            if edge_feat is not None:
                edge_feat = np.concatenate([edge_feat, edge_feat], axis=0)
        order = np.argsort(src, kind="stable")
        src, dst = src[order], dst[order]
        if edge_feat is not None:
            edge_feat = edge_feat[order]
        counts = np.bincount(src, minlength=num_nodes)
        indptr = np.zeros(num_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return CSRGraph(
            indptr=indptr,
            indices=dst.astype(np.int32),
            num_nodes=num_nodes,
            node_feat=node_feat,
            edge_feat=edge_feat,
            node_text=node_text,
        )

    def edge_list(self) -> tuple[np.ndarray, np.ndarray]:
        """Return (src, dst) int32 arrays — the scatter format for GNNs."""
        src = np.repeat(np.arange(self.num_nodes, dtype=np.int32), self.degrees())
        return src, self.indices.copy()

    def to_adj_dict(self) -> dict:
        """Adjacency-dict view for the pure-Python (NetworkX-class) baseline."""
        return {u: self.neighbors(u).tolist() for u in range(self.num_nodes)}

    def subgraph(self, nodes: np.ndarray) -> "CSRGraph":
        """Induced subgraph over ``nodes`` (host-side; exact, dynamic shape)."""
        nodes = np.asarray(nodes)
        relabel = -np.ones(self.num_nodes, dtype=np.int64)
        relabel[nodes] = np.arange(len(nodes))
        src, dst = [], []
        for new_u, u in enumerate(nodes):
            nbrs = self.neighbors(u)
            keep = relabel[nbrs] >= 0
            dst.extend(relabel[nbrs[keep]].tolist())
            src.extend([new_u] * int(keep.sum()))
        nf = self.node_feat[nodes] if self.node_feat is not None else None
        nt = [self.node_text[i] for i in nodes] if self.node_text is not None else None
        return CSRGraph.from_edges(
            np.asarray(src, dtype=np.int64),
            np.asarray(dst, dtype=np.int64),
            len(nodes),
            node_feat=nf,
            node_text=nt,
        )
