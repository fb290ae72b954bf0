"""The peaks of one NVIDIA H100 (SXM, 80 GB HBM3), from NVIDIA's data
sheet, dense rates, at the full 700 W power limit: a frozen copy of the
rates the chip smoke held every kernel to."""

#: HBM bandwidth, bytes a second
HBM_BYTES_PER_S = 3.35e12
#: 32-bit integer (and float32) operations a second outside the tensor
#: cores
INT32_OPS_PER_S = 67e12


def bound_seconds(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the operation rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)
