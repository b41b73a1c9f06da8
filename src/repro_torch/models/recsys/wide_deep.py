"""Wide & Deep (Cheng et al., 2016) with a hand-built EmbeddingBag (the
reference's ``repro.models.recsys.wide_deep``).

The bag lookup is a gather over one table of all fields' rows plus a sum over
bag slots (multi-hot fields), in the reference's arithmetic order (gather,
mask the ``-1`` pads, sum), so no ``nn.EmbeddingBag``.  The gathers are
``index_select``: their backward is an ``index_add`` into the dense table
gradient (atomics on the card), not the sort-based ``index_put_``.

The deep tower concatenates 40 x 32-dim bag embeddings + 13 dense features
through a 1024-512-256 MLP; the wide tower is a linear model over the same
sparse ids (per-row scalar weights) + dense features.  `retrieval_scores`
scores one query against 10^6 candidates (the ``retrieval_cand`` shape, and
exactly RGL's node-retrieval op) with the port's ``topk_sim`` kernel on the
card.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.kernels.topk_sim import ops as topk_ops


@dataclasses.dataclass(frozen=True)
class WideDeepConfig:
    name: str = "wide-deep"
    n_sparse: int = 40  # number of sparse fields
    rows_per_field: int = 1_000_000  # embedding-table rows per field
    embed_dim: int = 32
    n_dense: int = 13
    mlp: tuple = (1024, 512, 256)
    bag_size: int = 4  # multi-hot ids per field (padded with -1)
    dtype: str = "float32"

    @property
    def total_rows(self) -> int:
        return self.n_sparse * self.rows_per_field


def init_wide_deep(cfg: WideDeepConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random weights with the reference's shapes and scales (table ~ N(0,
    0.01^2), MLP ~ N(0, 1/fan_in), the rest zeros), drawn from
    ``generator`` (on its own device) and stored on ``device``."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)

    def nrm(shape, scale):
        x = torch.randn(shape, generator=generator, device=generator.device)
        return (x * scale).to(device=dev, dtype=dtype)

    d_cat = cfg.n_sparse * cfg.embed_dim + cfg.n_dense
    dims = (d_cat,) + tuple(cfg.mlp) + (1,)
    mlp = {}
    for i in range(len(dims) - 1):
        mlp[f"w{i}"] = nrm((dims[i], dims[i + 1]), dims[i] ** -0.5)
        mlp[f"b{i}"] = torch.zeros((dims[i + 1],), dtype=dtype, device=dev)
    return {
        "table": nrm((cfg.total_rows, cfg.embed_dim), 0.01),
        "wide": torch.zeros((cfg.total_rows,), dtype=dtype, device=dev),
        "wide_dense": torch.zeros((cfg.n_dense,), dtype=dtype, device=dev),
        "bias": torch.zeros((), dtype=dtype, device=dev),
        "mlp": mlp,
    }


def embedding_bag(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Manual EmbeddingBag(sum).  ids (B, F, bag) int, -1 padded; rows of
    field f live at [f * rows_per_field, (f+1) * rows_per_field) — caller
    pre-offsets ids.  Returns (B, F, embed_dim)."""
    valid = ids >= 0
    safe = torch.where(valid, ids, 0)
    emb = table.index_select(0, safe.reshape(-1)).reshape(*ids.shape, -1)
    emb = torch.where(valid[..., None], emb, 0.0)
    return emb.sum(dim=2)  # sum over bag slots


def wide_deep_logits(params: dict, cfg: WideDeepConfig, dense: torch.Tensor,
                     sparse_ids: torch.Tensor) -> torch.Tensor:
    """dense (B, n_dense); sparse_ids (B, n_sparse, bag) pre-offset, -1 pad."""
    b = dense.shape[0]
    bags = embedding_bag(params["table"], sparse_ids)  # (B, F, E)
    x = torch.cat([bags.reshape(b, -1), dense], -1)
    n = len([k for k in params["mlp"] if k.startswith("w")])
    for i in range(n):
        x = x @ params["mlp"][f"w{i}"] + params["mlp"][f"b{i}"]
        if i < n - 1:
            x = torch.relu(x)
    deep_logit = x[:, 0]
    # wide: per-row scalar weights, manual bag-sum
    valid = sparse_ids >= 0
    safe = torch.where(valid, sparse_ids, 0)
    ww = params["wide"].index_select(0, safe.reshape(-1)).reshape(sparse_ids.shape)
    wide_logit = torch.sum(torch.where(valid, ww, 0.0), dim=(1, 2))
    wide_logit = wide_logit + dense @ params["wide_dense"]
    return deep_logit + wide_logit + params["bias"]


def wide_deep_loss(params: dict, cfg: WideDeepConfig, dense: torch.Tensor,
                   sparse_ids: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on logits, the reference's stable form."""
    lg = wide_deep_logits(params, cfg, dense, sparse_ids)
    loss = torch.clamp(lg, min=0) - lg * labels + torch.log1p(torch.exp(-torch.abs(lg)))
    return torch.mean(loss)


def retrieval_scores(query: torch.Tensor, cand_emb: torch.Tensor, k: int = 100):
    """Score 1 (or Q) query tower output against n_candidates item
    embeddings: ((Q, k) scores, (Q, k) int32 ids), the ``topk_sim`` kernel on
    a CUDA tensor, its plain version on a CPU tensor."""
    q = query if query.ndim == 2 else query[None]
    return topk_ops.topk_similarity(q, cand_emb, k)
