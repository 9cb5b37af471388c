"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit)."""

#: HBM3 bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12
#: float32 outside the tensor cores, FLOP/s
F32_FLOPS_PER_S = 67e12


def bound_s(nbytes: float, flops: float = 0.0) -> float:
    """The least time for ``nbytes`` moved and ``flops`` done at the
    peaks: the larger of the byte time and the FLOP time."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
