"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit; the result line records the card's
own limit beside every number)."""

PEAK_BYTES_S = 3.35e12   # HBM3
PEAK_FP32_S = 67e12      # float32 outside the tensor cores, an FMA as 2


def least_seconds(n_bytes, flops):
    """max(bytes / memory rate, operations / float32 rate)."""
    return max(n_bytes / PEAK_BYTES_S, flops / PEAK_FP32_S)
