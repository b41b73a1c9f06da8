"""Decoder-only LM transformer (GQA, RoPE, SwiGLU, optional sliding window)."""
