"""AdamW with a warmup + cosine schedule (the reference's
``repro.training.optimizer``), as init/update pairs over a parameter tree.

The update keeps the reference's arithmetic — clip by the global norm, fp32
moments stored in ``state_dtype``, bias correction, decoupled weight decay
on leaves of two or more dimensions (the stacked (L, D) norm weights
included, as in the reference) — but runs **in place under
``torch.no_grad()``, one slice of at most ``PIECE`` elements at a time**
along each leaf's leading axis.  The reference upcasts whole leaves; at
StarCoder2-3B's width the stacked ``w1`` leaf (30, 3072, 12288) would need a
4.5 GB fp32 copy per temporary and about seven of them.  Slicing changes no
number: every step is elementwise except the global norm, which sums the
slices' fp32 squares.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.tree import tree_leaves, tree_map

PIECE = 1 << 25  # elements per slice: 128 MB per fp32 temporary


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0
    state_dtype: str = "float32"  # "bfloat16" to halve m/v memory
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (fp32 tensor): linear warmup, then cosine
    decay to ``min_lr_frac * lr``."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def adamw_init(params, cfg: AdamWConfig) -> dict:
    dt = _STATE_DTYPES[cfg.state_dtype]
    zeros = lambda p: torch.zeros_like(p, dtype=dt)  # noqa: E731
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _pieces(*tensors: torch.Tensor):
    """Matching slices along the leading axis of same-shape tensors, each of
    at most ``PIECE`` elements (one leading row at least)."""
    t0 = tensors[0]
    if t0.ndim == 0 or t0.numel() <= PIECE:
        yield tensors
        return
    rows = max(1, PIECE // (t0.numel() // t0.shape[0]))
    for st in range(0, t0.shape[0], rows):
        yield tuple(t[st:st + rows] for t in tensors)


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's fp32 squares (a 0-d fp32 tensor)."""
    total = None
    for x in tree_leaves(tree):
        for (piece,) in _pieces(x):
            sq = torch.sum(torch.square(piece.float()))
            total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, opt_state: dict, params, cfg: AdamWConfig):
    """One AdamW step.  Updates ``params`` and the moments of ``opt_state``
    in place and returns ``(params, opt_state, {"lr", "grad_norm"})`` (0-d
    fp32 tensors, on the device: nothing here waits for the card)."""
    step = opt_state["step"] + 1
    stepf = step.float()
    lr = _schedule(cfg, stepf)
    gnorm = global_norm(grads)
    scale = None
    if cfg.grad_clip is not None:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1**stepf
    bc2 = 1 - b2**stepf
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"])):
        decay = p.ndim >= 2  # decoupled weight decay on matrices only
        for pp, gg, mm, vv in _pieces(p, g, m, v):
            # the clipped gradient is fp32, as the reference's bf16 * f32 product
            gf = gg.float() if scale is None else gg.float() * scale
            m_new = b1 * mm.float() + (1 - b1) * gf
            v_new = b2 * vv.float() + (1 - b2) * gf * gf
            delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
            if decay:
                delta = delta + cfg.weight_decay * pp.float()
            pp.copy_(pp.float() - lr * delta)
            mm.copy_(m_new)
            vv.copy_(v_new)
    opt_state["step"] = step
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
