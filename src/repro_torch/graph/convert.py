"""Interop converters (paper §2.1.1: "seamless conversions to and from
popular frameworks such as DGL and PyG"; the reference's
``repro.graph.convert``).

They work on the host ``CSRGraph`` against the libraries' *data layouts*
(the stable exchange contracts), with numpy arrays:

* PyG style:  dict(edge_index=(2, E) int64 array, x=(N, F), num_nodes=N)
* DGL style:  dict(edges=(src, dst) tuple, num_nodes=N, ndata={"feat": (N, F)})

If the real libraries are importable, `to_pyg`/`to_dgl` return actual
`torch_geometric.data.Data` / `dgl.DGLGraph` objects; otherwise the layout
dicts (the path the tests cover).
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph


def to_pyg(g: CSRGraph):
    src, dst = g.edge_list()
    payload = {
        "edge_index": np.stack([src, dst]).astype(np.int64),
        "x": g.node_feat,
        "num_nodes": g.num_nodes,
    }
    try:  # pragma: no cover - library not installed
        from torch_geometric.data import Data
        import torch

        return Data(
            edge_index=torch.as_tensor(payload["edge_index"]),
            x=None if g.node_feat is None else torch.as_tensor(g.node_feat),
            num_nodes=g.num_nodes,
        )
    except ImportError:
        return payload


def from_pyg(data) -> CSRGraph:
    if isinstance(data, dict):
        ei, x, n = data["edge_index"], data.get("x"), data["num_nodes"]
    else:  # pragma: no cover
        ei = data.edge_index.numpy()
        x = None if data.x is None else data.x.numpy()
        n = data.num_nodes
    ei = np.asarray(ei)
    return CSRGraph.from_edges(ei[0], ei[1], int(n), node_feat=x)


def to_dgl(g: CSRGraph):
    src, dst = g.edge_list()
    payload = {
        "edges": (src.astype(np.int64), dst.astype(np.int64)),
        "num_nodes": g.num_nodes,
        "ndata": {} if g.node_feat is None else {"feat": g.node_feat},
    }
    try:  # pragma: no cover - library not installed
        import dgl
        import torch

        gg = dgl.graph(
            (torch.as_tensor(payload["edges"][0]),
             torch.as_tensor(payload["edges"][1])),
            num_nodes=g.num_nodes,
        )
        if g.node_feat is not None:
            gg.ndata["feat"] = torch.as_tensor(g.node_feat)
        return gg
    except ImportError:
        return payload


def from_dgl(data) -> CSRGraph:
    if isinstance(data, dict):
        src, dst = data["edges"]
        n = data["num_nodes"]
        x = data.get("ndata", {}).get("feat")
    else:  # pragma: no cover
        src, dst = (t.numpy() for t in data.edges())
        n = data.num_nodes()
        x = data.ndata.get("feat")
        x = None if x is None else x.numpy()
    return CSRGraph.from_edges(np.asarray(src), np.asarray(dst), int(n),
                               node_feat=x)
