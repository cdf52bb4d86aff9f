"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit)."""
BF16_FLOPS = 989e12
FLOAT32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(n_bytes: float, n_flops: float, flops_peak: float = BF16_FLOPS) -> float:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak, whichever is larger."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / flops_peak)
