"""DeepSeek-7B [arXiv:2401.02954; hf] — llama-arch, GQA kv=32 (== MHA)."""
from repro_torch.configs.common import ArchSpec, lm_shapes
from repro_torch.models.transformer.config import TransformerConfig

CONFIG = ArchSpec(
    arch_id="deepseek-7b",
    family="lm",
    model_cfg=TransformerConfig(
        name="deepseek-7b",
        n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, d_head=128,
        d_ff=11008, vocab=102400,
    ),
    shapes=lm_shapes(sliding_window=None),
    reduced_cfg=TransformerConfig(
        name="deepseek-7b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=224, vocab=128, dtype="float32",
    ),
    source="arXiv:2401.02954; hf",
)
