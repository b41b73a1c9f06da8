"""Grok-1 314B [hf:xai-org/grok-1; unverified] — MoE 8 experts top-2.

8 experts < 16 model-mesh devices => "tp" MoE sharding in the reference
(d_ff split over "model"); on one card the mode changes no arithmetic."""
from repro_torch.configs.common import ArchSpec, lm_shapes
from repro_torch.models.transformer.config import MoEConfig, TransformerConfig

CONFIG = ArchSpec(
    arch_id="grok-1-314b",
    family="lm",
    model_cfg=TransformerConfig(
        name="grok-1-314b",
        n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
        d_ff=0, vocab=131072,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=32768, shard_mode="tp"),
    ),
    shapes=lm_shapes(sliding_window=None),
    reduced_cfg=TransformerConfig(
        name="grok-1-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=0, vocab=128, dtype="float32",
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=128, shard_mode="tp"),
    ),
    source="hf:xai-org/grok-1; unverified",
)
