"""Wide & Deep [arXiv:1606.07792; paper] — 40 sparse fields, embed 32,
MLP 1024-512-256, concat interaction.  Tables: 40 x 1M rows (row-sharded)."""
from repro_torch.configs.common import ArchSpec, RECSYS_SHAPES
from repro_torch.models.recsys.wide_deep import WideDeepConfig

CONFIG = ArchSpec(
    arch_id="wide-deep",
    family="recsys",
    model_cfg=WideDeepConfig(
        name="wide-deep", n_sparse=40, rows_per_field=1_000_000, embed_dim=32,
        n_dense=13, mlp=(1024, 512, 256), bag_size=4,
    ),
    shapes=RECSYS_SHAPES,
    reduced_cfg=WideDeepConfig(
        name="wide-deep-smoke", n_sparse=6, rows_per_field=128, embed_dim=8,
        n_dense=5, mlp=(32, 16), bag_size=3,
    ),
    source="arXiv:1606.07792; paper",
)
