"""Model FLOPs of a decoder, counted from its shapes.

A token costs two operations per multiply-add of every matrix it passes
through (the experts it is routed to only, for a mixture of experts), plus
attention: QK^T and PV over the positions it attends to, two operations
per multiply-add each.
"""
from __future__ import annotations


def matmul_flops_per_token(cfg: dict) -> int:
    d, h, kv, dh, L = (cfg[k] for k in ("d_model", "n_heads", "n_kv_heads", "d_head", "n_layers"))
    attn = d * h * dh + 2 * d * kv * dh + h * dh * d
    m = cfg.get("moe")
    if m is None:
        ffn = 3 * d * cfg["d_ff"]
    else:
        ffn = 3 * d * m["d_ff"] * m["top_k"] + d * m["n_experts"]
    return 2 * (L * (attn + ffn) + d * cfg["vocab"])


def attention_flops(cfg: dict, positions: int) -> int:
    """QK^T and PV for one token attending to ``positions`` positions."""
    return 4 * cfg["n_layers"] * cfg["n_heads"] * cfg["d_head"] * positions

