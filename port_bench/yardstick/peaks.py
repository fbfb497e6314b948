"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): HBM3 bytes per second and float32
operations per second outside the tensor cores, the type the renderer's
raster work is done in."""

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take (seconds): the larger of the
    bytes over the memory rate and the operations over the fp32 rate."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_FP32_PER_S)
