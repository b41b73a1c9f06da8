"""StarCoder2-3B [arXiv:2402.19173; hf] — GQA kv=2, RoPE, sliding-window 4096."""
from repro_torch.configs.common import ArchSpec, lm_shapes
from repro_torch.models.transformer.config import TransformerConfig

CONFIG = ArchSpec(
    arch_id="starcoder2-3b",
    family="lm",
    model_cfg=TransformerConfig(
        name="starcoder2-3b",
        n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, d_head=128,
        d_ff=12288, vocab=49152, sliding_window=4096, rope_theta=1e5,
    ),
    shapes=lm_shapes(sliding_window=4096),
    reduced_cfg=TransformerConfig(
        name="starcoder2-3b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=256, vocab=128, sliding_window=16, dtype="float32",
    ),
    source="arXiv:2402.19173; hf",
)
