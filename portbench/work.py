"""The yardstick: the card's published peaks and the least time of the
work a cell requires, counted from the shapes of its inputs.

The required work is the same whatever implements it: each input byte is
read once, each output byte written once, and a matrix product takes
2 * m * n * k operations.  A share of the roofline is that least time over
the device time the traced window took.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, at the full 700 W):
HBM at 3.35 TB/s; 67 TFLOP/s in fp32 outside the tensor cores; 495 TFLOP/s
in TF32, so a product of fp32 accuracy built from three TF32 products
(3xTF32) runs at most at 495 / 3 = 165 TFLOP/s.  Matrix work is counted
against 165, so a later kernel that takes that route still reads under 100%.
"""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12  # printed beside the rooflines; not a divisor
PEAK_TF32_FLOPS = 495e12
PEAK_MATMUL_FLOPS = PEAK_TF32_FLOPS / 3  # fp32-accurate matrix work (3xTF32)
F32 = 4  # bytes


def least_s(flops: float, nbytes: float) -> float:
    """Least time of one operation: the larger of its matrix work over the
    fp32-accurate matrix peak and its bytes over HBM's."""
    return max(flops / PEAK_MATMUL_FLOPS, nbytes / PEAK_BYTES_PER_S)


def fl_sweep_s(u: int, n: int) -> float:
    """One dense FL gain sweep: the (u, n) fp32 S and the (u,) curmax read,
    the (n,) gains written."""
    return least_s(0.0, F32 * (u * n + u + n))


def flmf_sweep_s(u: int, n: int, d: int) -> float:
    """One matrix-free FL gain sweep: every similarity of u rows against n
    candidates at width d recomputed (2 u n d), the features and curmax
    read, the gains written."""
    return least_s(2.0 * u * n * d, F32 * ((u + n) * d + u + n))
