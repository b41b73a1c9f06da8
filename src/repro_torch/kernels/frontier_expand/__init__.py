"""frontier_expand kernel package: kernel.py (CUDA launch), ops.py (public ops), ref.py (plain version)."""
