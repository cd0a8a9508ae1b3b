"""Published peaks of one NVIDIA H100 SXM and the roofline bound (frozen).

Dense rates from NVIDIA's data sheet at the full 700 W power limit: float32
outside the tensor cores and HBM3 bandwidth. A kernel's least time is the
larger of its float32 operations over the first and its bytes (inputs read
once, outputs written once) over the second.
"""

PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def bound_ms(flops: float, n_bytes: float) -> tuple[float, str]:
    """``(least milliseconds, "operations" or "bytes")``: which peak sets it."""
    by_ops = flops / PEAK_FP32_FLOPS * 1e3
    by_bytes = n_bytes / PEAK_HBM_BYTES * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")
