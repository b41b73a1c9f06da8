"""Unified GNN configuration across the four assigned architectures."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    arch: str  # gin | meshgraphnet | graphcast | equiformer_v2
    n_layers: int
    d_hidden: int
    d_in: int
    d_out: int
    aggregator: str = "sum"
    mlp_layers: int = 2
    # graphcast
    mesh_refinement: int = 6
    n_vars: int = 227
    # equiformer_v2
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_wigner_bins: int = 2048
    # graph-level readout (molecule shape)
    graph_readout: bool = False

    @property
    def sphere_k(self) -> int:
        return (self.l_max + 1) ** 2
