"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, at the full 700 W power limit)."""

BF16_FLOPS = 989e12  # tensor cores, bf16 and fp16
FP32_FLOPS = 67e12  # CUDA cores, outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def roofline_s(flops: float, n_bytes: float, flops_per_s: float) -> float:
    """The least time the card could take for the work."""
    return max(flops / flops_per_s, n_bytes / HBM_BYTES_PER_S)
