"""ell_spmm kernel package: kernel.py (CUDA launch), ops.py (public op), ref.py (plain version)."""
