"""GNN zoo of the port: GIN, MeshGraphNet, GraphCast, EquiformerV2 (eSCN)
(the reference's ``repro.models.gnn``).  Aggregations are gathers plus
scatters in plain PyTorch, as the reference's are XLA's: no kernel of the
port is on this path."""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models.gnn.common import segment_sum
from repro_torch.models.gnn.config import GNNConfig
from repro_torch.models.gnn.equiformer import apply_equiformer, init_equiformer
from repro_torch.models.gnn.simple import (
    apply_gin, apply_graphcast, apply_mgn, init_gin, init_graphcast, init_mgn,
)
from repro_torch.tree import params_from_jax, tree_map

_REGISTRY = {
    "gin": (init_gin, apply_gin),
    "meshgraphnet": (init_mgn, apply_mgn),
    "graphcast": (init_graphcast, apply_graphcast),
    "equiformer_v2": (init_equiformer, apply_equiformer),
}


def init_gnn(cfg: GNNConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random fp32 weights of ``cfg``'s architecture with the reference's
    shapes and scales, drawn from ``generator`` (on its own device) and
    stored on ``device``; lists of per-layer dicts, as the reference keeps
    them."""
    dev = resolve_device(device)
    return tree_map(lambda t: t.to(dev), _REGISTRY[cfg.arch][0](generator, cfg))


def apply_gnn(params: dict, cfg: GNNConfig, inputs: dict) -> torch.Tensor:
    return _REGISTRY[cfg.arch][1](params, cfg, inputs)


def gnn_loss(params: dict, cfg: GNNConfig, inputs: dict) -> torch.Tensor:
    """Masked node-level (or graph-level readout) regression MSE.  The
    readout's segment sum drops ``graph_ids`` outside ``[0, n_graphs)``, as
    the reference's does."""
    out = apply_gnn(params, cfg, inputs)
    if cfg.graph_readout and "graph_ids" in inputs:
        out = segment_sum(out, inputs["graph_ids"], inputs["targets"].shape[0])
    tgt = inputs["targets"]
    err = (out - tgt) ** 2
    nm = inputs.get("node_mask")
    if nm is not None and not cfg.graph_readout:
        err = err * nm[:, None]
        return torch.sum(err) / torch.clamp(torch.sum(nm) * tgt.shape[-1], min=1.0)
    return torch.mean(err)


__all__ = ["GNNConfig", "init_gnn", "apply_gnn", "gnn_loss", "params_from_jax"]
