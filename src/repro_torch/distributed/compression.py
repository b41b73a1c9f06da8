"""Error-feedback gradient compression before the data-parallel reduction
(the reference's ``repro.distributed.compression``; Karimireddy et al. 2019).

* int8 — per-tensor absmax scale, round half to even, clip to ±127.
* topk — keep the entries with |g| at or above the k-th largest |g| of the
  tensor, k = max(1, floor(n * topk_frac)); dense-masked.

Each codec sees ``g + residual`` in fp32; the quantization error is carried
into the next step instead of dropped.  Leaves are whole tensors (the int8
scale and the top-k threshold are per tensor), so each call makes fp32
copies of every leaf: the full-width training run does not compress.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"  # none | int8 | topk
    topk_frac: float = 0.01


def init_residuals(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _int8_codec(g: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.float() * scale


def _topk_codec(g: torch.Tensor, frac: float) -> torch.Tensor:
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat.abs(), k).values[-1]
    return torch.where(g.abs() >= thresh, g, 0.0)


def compress(grads, residuals, cfg: CompressionConfig):
    """Returns (compressed grads in each leaf's dtype, new fp32 residuals)."""
    if cfg.kind == "none":
        return grads, residuals
    if cfg.kind not in ("int8", "topk"):
        raise ValueError(cfg.kind)

    def one(g, r):
        acc = g.float() + r
        c = _int8_codec(acc) if cfg.kind == "int8" else _topk_codec(acc, cfg.topk_frac)
        return c.to(g.dtype), acc - c

    out = tree_map(one, grads, residuals)  # grads' structure with (c, residual) leaves
    comp = tree_map(lambda g, t: t[0], grads, out)
    res = tree_map(lambda g, t: t[1], grads, out)
    return comp, res
