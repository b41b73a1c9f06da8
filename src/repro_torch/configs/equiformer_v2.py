"""EquiformerV2 [arXiv:2306.12059; unverified] — 12 layers, d=128, l_max=6,
m_max=2, 8 heads, SO(2)-eSCN equivariant graph attention.

As in the reference, per-edge Wigner rotations are served from a quantized
direction LUT (32x64 bins); equivariance error is first-order in bin width.
Non-geometric assigned shapes (citation / products graphs) get synthetic 3D
positions via input_specs.
"""
from repro_torch.configs.common import ArchSpec, GNN_SHAPES
from repro_torch.models.gnn.config import GNNConfig

CONFIG = ArchSpec(
    arch_id="equiformer-v2",
    family="gnn",
    model_cfg=GNNConfig(
        name="equiformer-v2", arch="equiformer_v2", n_layers=12, d_hidden=128,
        d_in=128, d_out=1, l_max=6, m_max=2, n_heads=8, n_wigner_bins=2048,
    ),
    shapes=GNN_SHAPES,
    reduced_cfg=GNNConfig(
        name="equiformer-smoke", arch="equiformer_v2", n_layers=2, d_hidden=16,
        d_in=16, d_out=4, l_max=2, m_max=1, n_heads=4, n_wigner_bins=128,
    ),
    source="arXiv:2306.12059; unverified",
)
