"""MeshGraphNet [arXiv:2010.03409; unverified] — 15 layers, d=128, sum agg,
2-hidden-layer LayerNorm'd MLPs for edge and node updates."""
from repro_torch.configs.common import ArchSpec, GNN_SHAPES
from repro_torch.models.gnn.config import GNNConfig

CONFIG = ArchSpec(
    arch_id="meshgraphnet",
    family="gnn",
    model_cfg=GNNConfig(
        name="meshgraphnet", arch="meshgraphnet", n_layers=15, d_hidden=128,
        d_in=128, d_out=128, aggregator="sum", mlp_layers=2,
    ),
    shapes=GNN_SHAPES,
    reduced_cfg=GNNConfig(
        name="meshgraphnet-smoke", arch="meshgraphnet", n_layers=2,
        d_hidden=32, d_in=16, d_out=8, aggregator="sum", mlp_layers=2,
    ),
    source="arXiv:2010.03409; unverified",
)
