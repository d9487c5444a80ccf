"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W limit), for model FLOP utilization and roofline
shares. float32 is the rate outside the tensor cores (TF32 off), the
precision every configuration states."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12}


def bound_ms(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM bandwidth and the operations over the float32 peak, in ms."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS["float32"]) * 1e3
