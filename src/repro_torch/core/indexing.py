"""Stage 1 of the RGL pipeline: indexing (exact brute-force index).

:class:`BruteIndex` scores every node embedding; its hot loop is the fused
similarity→top-k kernel (:mod:`repro_torch.kernels.topk_sim`).  The other
index kinds of the reference are not ported yet (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.kernels.topk_sim import ops as topk_ops


def l2_normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x / (torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)) + eps)


@dataclasses.dataclass
class BruteIndex:
    emb: torch.Tensor  # (N, D) float32, rows may be L2-normalized
    normalized: bool = True

    @staticmethod
    def build(emb, normalize: bool = True, *, device="cuda") -> "BruteIndex":
        emb = torch.as_tensor(emb, dtype=torch.float32, device=resolve_device(device))
        if normalize:
            emb = l2_normalize(emb)
        return BruteIndex(emb=emb.contiguous(), normalized=normalize)

    def search(self, queries, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Return (scores, ids) of the top-k most similar nodes, (Q, k)."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.emb.device)
        if self.normalized:
            q = l2_normalize(q)
        return topk_ops.topk_similarity(q, self.emb, k)


_NOT_PORTED = {
    "ivf": "ROADMAP Queue 1 item 9 (IVF index)",
    "sharded": "ROADMAP Queue 1 item 14 (sharded index)",
    "sharded_ivf": "ROADMAP Queue 1 item 14 (sharded index)",
}


def build_index(emb, kind: str = "brute", **kw):
    if kind == "brute":
        return BruteIndex.build(emb, **kw)
    if kind in _NOT_PORTED:
        raise NotImplementedError(f"index kind {kind!r} is not ported yet: {_NOT_PORTED[kind]}")
    raise ValueError(f"unknown index kind: {kind}")
