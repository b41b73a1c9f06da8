"""GraphCast [arXiv:2212.12794; unverified] — encoder-processor-decoder mesh
GNN, 16 layers, d_hidden=512, sum aggregation, n_vars=227.

Adaptation note (as in the reference): assigned input shapes supply one generic
graph, so the grid<->mesh bipartite encoder/decoder degenerate to per-node
MLPs and n_vars tracks the shape's d_feat; the 16-layer processor — the
compute hot spot — is exercised unchanged.  mesh_refinement=6 is recorded
for provenance (it fixes the mesh size in the weather deployment).
"""
from repro_torch.configs.common import ArchSpec, GNN_SHAPES
from repro_torch.models.gnn.config import GNNConfig

CONFIG = ArchSpec(
    arch_id="graphcast",
    family="gnn",
    model_cfg=GNNConfig(
        name="graphcast", arch="graphcast", n_layers=16, d_hidden=512,
        d_in=227, d_out=227, n_vars=227, mesh_refinement=6, aggregator="sum",
    ),
    shapes=GNN_SHAPES,
    reduced_cfg=GNNConfig(
        name="graphcast-smoke", arch="graphcast", n_layers=2, d_hidden=32,
        d_in=16, d_out=16, n_vars=16, aggregator="sum",
    ),
    source="arXiv:2212.12794; unverified",
)
