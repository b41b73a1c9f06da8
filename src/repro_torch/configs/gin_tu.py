"""GIN [arXiv:1810.00826; paper] — 5 layers, d=64, sum agg, learnable eps."""
from repro_torch.configs.common import ArchSpec, GNN_SHAPES
from repro_torch.models.gnn.config import GNNConfig

CONFIG = ArchSpec(
    arch_id="gin-tu",
    family="gnn",
    model_cfg=GNNConfig(
        name="gin-tu", arch="gin", n_layers=5, d_hidden=64,
        d_in=64, d_out=16, aggregator="sum", mlp_layers=2,
    ),
    shapes=GNN_SHAPES,
    reduced_cfg=GNNConfig(
        name="gin-smoke", arch="gin", n_layers=2, d_hidden=16,
        d_in=16, d_out=4, aggregator="sum",
    ),
    source="arXiv:1810.00826; paper",
)
