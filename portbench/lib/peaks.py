"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # outside the tensor cores
TF32_FLOPS = 495e12  # tensor cores
BF16_FLOPS = 989e12  # tensor cores


def least_seconds(nbytes: float, fma_ops: float = 0.0, mma_ops: float = 0.0) -> float:
    """The least time for work that moves ``nbytes`` and computes
    ``fma_ops`` fp32 operations outside the tensor cores and ``mma_ops`` fp32
    operations on them in 3xTF32 (three TF32 multiply-adds each)."""
    return max(nbytes / HBM_BYTES_PER_S, 3.0 * mma_ops / TF32_FLOPS + fma_ops / FP32_FLOPS)
