"""Decoder-only LM transformer (GQA, RoPE, dense SwiGLU or MoE FFN,
optional sliding window) and its generation loop."""
from repro_torch.models.transformer import attention, generate, model, moe
from repro_torch.models.transformer.config import MoEConfig, TransformerConfig

__all__ = ["TransformerConfig", "MoEConfig", "model", "attention", "moe", "generate"]
