"""flash_attn kernel package: kernel.py (CUDA launches), ops.py (public ops), ref.py (plain version)."""
