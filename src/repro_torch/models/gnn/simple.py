"""GIN, MeshGraphNet and GraphCast over the shared edge-list interface (the
reference's ``repro.models.gnn.simple``).

* GIN (Xu et al., 2019): h' = MLP((1 + eps) h + sum_nbr h), learnable eps.
* MeshGraphNet (Pfaff et al., 2021): per-layer edge MLP + node MLP with
  residuals and LayerNorm'd 2-hidden-layer MLPs.
* GraphCast (Lam et al., 2023): encoder MLP -> interaction-network processor
  layers (the MeshGraphNet family) -> decoder MLP to n_vars.  The assigned
  input shapes supply one generic graph, so the grid<->mesh mapping is the
  identity and the processor (the compute hot spot) runs unchanged.

Recomputation sits at the reference's boundaries: GIN checkpoints each layer,
MeshGraphNet (and GraphCast's processor) each block of 4 layers, so the
backward keeps (h, e) only at block boundaries.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.constraints import shard_hint
from repro_torch.models.gnn.common import (
    apply_mlp, gather_src_dst, init_mlp, scatter_mean, scatter_sum,
)
from repro_torch.models.gnn.config import GNNConfig


def _agg(cfg: GNNConfig):
    return scatter_mean if cfg.aggregator == "mean" else scatter_sum


# ---------------------------------------------------------------- GIN ------
def init_gin(generator: torch.Generator, cfg: GNNConfig) -> dict:
    d = cfg.d_hidden
    layers = []
    for i in range(cfg.n_layers):
        d_in = cfg.d_in if i == 0 else d
        layers.append({"mlp": init_mlp(generator, [d_in] + [d] * cfg.mlp_layers),
                       "eps": torch.zeros((), device=generator.device)})
    return {"layers": layers, "out": init_mlp(generator, [d, cfg.d_out])}


def apply_gin(params: dict, cfg: GNNConfig, inputs: dict) -> torch.Tensor:
    h = inputs["node_feat"]
    n = h.shape[0]
    src, dst = inputs["edge_src"], inputs["edge_dst"]
    em = inputs.get("edge_mask")

    def one_layer(h, lp):
        hs, _ = gather_src_dst(h, src, dst, n)
        hs = shard_hint(hs, "dp", "model")
        agg = _agg(cfg)(hs, dst, n, em)
        h = apply_mlp(lp["mlp"], (1.0 + lp["eps"]) * h + agg, layernorm=True)
        return shard_hint(h, None, "model")

    for lp in params["layers"]:
        h = checkpoint(one_layer, h, lp, use_reentrant=False)
    return apply_mlp(params["out"], h)


# ------------------------------------------------------- MeshGraphNet ------
def init_mgn(generator: torch.Generator, cfg: GNNConfig, d_edge_in: int = 4) -> dict:
    d = cfg.d_hidden
    mlp_dims = [d] * cfg.mlp_layers + [d]
    layers = [{"edge": init_mlp(generator, [3 * d] + mlp_dims),
               "node": init_mlp(generator, [2 * d] + mlp_dims)} for _ in range(cfg.n_layers)]
    return {
        "enc_node": init_mlp(generator, [cfg.d_in] + mlp_dims),
        "enc_edge": init_mlp(generator, [d_edge_in] + mlp_dims),
        "layers": layers,
        "dec": init_mlp(generator, [d, d, cfg.d_out]),
    }


def _edge_geometry(inputs: dict, n: int) -> torch.Tensor:
    """Default edge features: endpoint feature delta summary (4 dims)."""
    if inputs.get("edge_feat") is not None:
        return inputs["edge_feat"]
    h = inputs["node_feat"]
    hs, hd = gather_src_dst(h, inputs["edge_src"], inputs["edge_dst"], n)
    diff = (hs - hd)[:, :3] if h.shape[1] >= 3 else hs.new_zeros((hs.shape[0], 3))
    norm = torch.linalg.vector_norm(diff, dim=-1, keepdim=True)
    return torch.cat([diff, norm], -1)


def apply_mgn(params: dict, cfg: GNNConfig, inputs: dict) -> torch.Tensor:
    n = inputs["node_feat"].shape[0]
    src, dst = inputs["edge_src"], inputs["edge_dst"]
    em = inputs.get("edge_mask")
    h = apply_mlp(params["enc_node"], inputs["node_feat"], layernorm=True)
    e = apply_mlp(params["enc_edge"], _edge_geometry(inputs, n), layernorm=True)
    h = shard_hint(h, None, "model")
    # edge state over (edges, features): keeps the concat and the edge MLP
    # shard-local (feature-replicated e made GSPMD all-gather (E, d) a layer
    # in the reference)
    e = shard_hint(e, "dp", "model")

    def one_layer(h, e, lp):
        hs, hd = gather_src_dst(h, src, dst, n)
        e = e + apply_mlp(lp["edge"], torch.cat([e, hs, hd], -1), layernorm=True)
        e = shard_hint(e, "dp", "model")
        agg = _agg(cfg)(e, dst, n, em)
        h = h + apply_mlp(lp["node"], torch.cat([h, agg], -1), layernorm=True)
        h = shard_hint(h, None, "model")
        return h, e

    def block_fn(h, e, blk):
        for lp in blk:
            h, e = one_layer(h, e, lp)
        return h, e

    layers = params["layers"]
    for i in range(0, len(layers), 4):
        h, e = checkpoint(block_fn, h, e, layers[i:i + 4], use_reentrant=False)
    return apply_mlp(params["dec"], h)


# ----------------------------------------------------------- GraphCast ------
def _proc_cfg(cfg: GNNConfig) -> GNNConfig:
    return GNNConfig(name="proc", arch="meshgraphnet", n_layers=cfg.n_layers,
                     d_hidden=cfg.d_hidden, d_in=cfg.n_vars, d_out=cfg.n_vars,
                     mlp_layers=cfg.mlp_layers, aggregator=cfg.aggregator)


def init_graphcast(generator: torch.Generator, cfg: GNNConfig, d_edge_in: int = 4) -> dict:
    """Encoder–processor–decoder; inputs are the n_vars atmospheric stack."""
    return init_mgn(generator, _proc_cfg(cfg), d_edge_in=d_edge_in)


def apply_graphcast(params: dict, cfg: GNNConfig, inputs: dict) -> torch.Tensor:
    # GraphCast predicts the state *increment*
    return inputs["node_feat"] + apply_mgn(params, _proc_cfg(cfg), inputs)
