"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
sheet), the yardstick of every roofline share.

The data sheet's 67 TFLOP/s of float32 outside the tensor cores counts a
fused multiply-add as two operations.  The port's kernels are built with
``-fmad=false`` (their bit-equality with the plain versions forbids
contraction), so each counted add, multiply, compare or min/max is one
instruction, and the peak for them is half the data sheet's: 132 SMs × 128
lanes × 1.98 GHz.
"""

BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 132 * 128 * 1.98e9


def bound_s(ops: float, nbytes: float) -> float:
    """The least seconds the card needs for ``ops`` float32 operations and
    ``nbytes`` bytes of memory traffic: the larger of the two times."""
    return max(ops / F32_OPS_PER_S, nbytes / BYTES_PER_S)
