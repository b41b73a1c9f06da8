"""Batch many small graphs into one block-diagonal graph (molecule shape)."""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph


def batch_graphs(graphs: list[CSRGraph]) -> tuple[CSRGraph, np.ndarray]:
    """Disjoint union.  Returns (big_graph, graph_ids) where ``graph_ids[i]``
    maps node i of the union back to its source graph (for graph-level
    readout via segment_sum)."""
    offsets = np.cumsum([0] + [g.num_nodes for g in graphs])
    src_all, dst_all, feats, gids = [], [], [], []
    for k, g in enumerate(graphs):
        s, d = g.edge_list()
        src_all.append(s.astype(np.int64) + offsets[k])
        dst_all.append(d.astype(np.int64) + offsets[k])
        if g.node_feat is not None:
            feats.append(g.node_feat)
        gids.append(np.full(g.num_nodes, k, dtype=np.int32))
    nf = np.concatenate(feats, axis=0) if feats else None
    big = CSRGraph.from_edges(
        np.concatenate(src_all),
        np.concatenate(dst_all),
        int(offsets[-1]),
        node_feat=nf,
    )
    return big, np.concatenate(gids)
