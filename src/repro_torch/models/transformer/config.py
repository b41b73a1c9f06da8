"""Transformer configuration (decoder-only LM family)."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int  # per-expert hidden width
    capacity_factor: float = 1.25
    shard_mode: str = "expert"  # "expert" (EP) or "tp" (TP within expert)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int  # dense FFN width (ignored when moe is set)
    vocab: int
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None  # None = full causal attention
    moe: Optional[MoEConfig] = None
    dtype: str = "bfloat16"  # parameter / activation dtype
    remat: bool = True
    scan_layers: bool = True
    q_chunk: int = 512  # chunked-attention block sizes (flash-style)
    kv_chunk: int = 512
    loss_chunk: int = 512  # seq chunk for streamed cross-entropy
    norm_eps: float = 1e-5
    kv_quant: bool = False  # int8 KV cache (per-row absmax scales)

    @property
    def n_rep(self) -> int:
        assert self.n_heads % self.n_kv_heads == 0
        return self.n_heads // self.n_kv_heads

    def param_count(self) -> tuple[int, int]:
        """(total params N, active params N_active) excluding embeddings'
        contribution is included — standard 6ND accounting uses non-embedding
        + embedding; we report both terms folded in."""
        d, h, kv, dh = self.d_model, self.n_heads, self.n_kv_heads, self.d_head
        attn = d * h * dh + 2 * d * kv * dh + h * dh * d
        if self.moe is not None:
            ff_tot = 3 * d * self.moe.d_ff * self.moe.n_experts + d * self.moe.n_experts
            ff_act = 3 * d * self.moe.d_ff * self.moe.top_k + d * self.moe.n_experts
        else:
            ff_tot = ff_act = 3 * d * self.d_ff
        per_layer_t = attn + ff_tot + 2 * d
        per_layer_a = attn + ff_act + 2 * d
        emb = self.vocab * d * 2  # embed + head
        return (
            self.n_layers * per_layer_t + emb + d,
            self.n_layers * per_layer_a + emb + d,
        )
