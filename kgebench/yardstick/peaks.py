"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W limit): float32 outside the tensor cores, which is what
the port computes in (TF32 off), and HBM3 bandwidth."""
from __future__ import annotations

from typing import Tuple

FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, ops: float) -> Tuple[float, str]:
    """The least time the card could take for ``nbytes`` moved and ``ops``
    float32 operations, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / FP32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
