"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, 700 W) and the least time of a piece of work at them.

Copied from ``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``PEAK_OPS_PER_S``,
``bound_ms``) with TF32 added, so that a later change to the program
cannot move the yardstick.
"""
from __future__ import annotations

from typing import Dict, Tuple

HBM_BYTES_PER_S = 3.35e12
#: Operations per second by the class the work runs in: ``bf16`` tensor
#: cores, ``tf32`` tensor cores, ``f32`` CUDA cores.
PEAK_OPS_PER_S = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}


def bound_ms(nbytes: float, ops: float, op_class: str) -> Tuple[float, str]:
    """The least time of a call in ms: bytes over the memory rate or
    operations over the class's peak, the larger, and which it is."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / PEAK_OPS_PER_S[op_class]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def least_seconds(flops_by_class: Dict[str, float]) -> float:
    """The least time of work whose operations are split by class."""
    return sum(f / PEAK_OPS_PER_S[c] for c, f in flops_by_class.items())


def grouped_conv(batch: int, cin: int, cout: int, k: int, groups: int,
                 t_in: int, t_out: int, item: int = 2) -> Tuple[float, float]:
    """Operations and bytes of one grouped 1-D conv call (forward, data
    gradient or weight gradient alike): ``2 B T_out C_out K C_in / G``
    multiply-adds, and x, w and y each read or written once."""
    ops = 2.0 * batch * t_out * cout * k * (cin // groups)
    nbytes = item * (batch * cin * t_in + cout * (cin // groups) * k
                     + batch * cout * t_out)
    return ops, nbytes
