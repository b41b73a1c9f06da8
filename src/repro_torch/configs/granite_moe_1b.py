"""Granite-3.0-1B-A400M [hf:ibm-granite; hf] — MoE 32 experts top-8.

32 experts >= 16 model-mesh devices => expert parallelism ("expert" shard
mode); on one card the mode changes no arithmetic."""
from repro_torch.configs.common import ArchSpec, lm_shapes
from repro_torch.models.transformer.config import MoEConfig, TransformerConfig

CONFIG = ArchSpec(
    arch_id="granite-moe-1b-a400m",
    family="lm",
    model_cfg=TransformerConfig(
        name="granite-moe-1b-a400m",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_head=64,
        d_ff=0, vocab=49155,
        moe=MoEConfig(n_experts=32, top_k=8, d_ff=512, shard_mode="expert"),
    ),
    shapes=lm_shapes(sliding_window=None),
    reduced_cfg=TransformerConfig(
        name="granite-moe-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=0, vocab=128, dtype="float32",
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=64, shard_mode="expert"),
    ),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
