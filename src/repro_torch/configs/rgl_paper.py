"""The paper's own experiment configuration (RGL pipeline defaults).

Dataset scales mirror the paper: OGBN-Arxiv-like citation graph (169,343
nodes / 1.15M edges) for abstract generation and retrieval scaling, and the
Baby/Sports bipartite graphs for modality completion.  One H100 holds the
Arxiv-scale graph, its ELL adjacency and a full-width generator at once, so
a benchmark of the port can run these scales as they stand; a CPU run cuts
them and says so.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class RGLPaperConfig:
    # retrieval pipeline (paper §2)
    strategies: tuple = ("bfs", "dense", "steiner")
    k_seeds: int = 4
    max_hops: int = 3
    max_nodes: int = 64
    filter_budget: int = 32
    # datasets (paper §3)
    arxiv_nodes: int = 169_343
    arxiv_edges: int = 1_157_799
    arxiv_feat: int = 128
    baby_users: int = 19_445
    baby_items: int = 7_050
    baby_inter: int = 160_792
    sports_users: int = 35_598
    sports_items: int = 18_357
    sports_inter: int = 296_337
    missing_rate: float = 0.4  # paper Table 1 masking
    query_counts: tuple = (10, 100, 1000, 10_000)  # paper Fig. 4 x-axis


CONFIG = RGLPaperConfig()
