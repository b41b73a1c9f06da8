"""DeepSeek-Coder-33B [arXiv:2401.14196; hf] — llama-arch, GQA kv=8."""
from repro_torch.configs.common import ArchSpec, lm_shapes
from repro_torch.models.transformer.config import TransformerConfig

CONFIG = ArchSpec(
    arch_id="deepseek-coder-33b",
    family="lm",
    model_cfg=TransformerConfig(
        name="deepseek-coder-33b",
        n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
        d_ff=19200, vocab=32256,
    ),
    shapes=lm_shapes(sliding_window=None),
    reduced_cfg=TransformerConfig(
        name="deepseek-coder-33b-smoke",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
        d_ff=192, vocab=128, dtype="float32",
    ),
    source="arXiv:2401.14196; hf",
)
