"""Card peaks and the least time a call could take.

A frozen copy of the port's `kernel_timing.py` (`CARD_PEAKS`,
`card_peaks`, `bound`, `layernorm_bound`, and of `_kmedoids_work` the part
that the shapes fix), so that a later change to the program cannot move
the yardstick.  NVIDIA's published dense peaks: the H100 SXM at 700 W
moves 3.35 TB/s and computes 989 TFLOP/s in bf16 on its tensor cores and
67 TFLOP/s in fp32 outside them.
"""
from __future__ import annotations

from typing import Tuple

# card name -> (memory bytes/s, bf16 tensor-core flop/s, fp32 flop/s)
CARD_PEAKS = {
    "H100 PCIe": (2.0e12, 756e12, 51e12),
    "H100 NVL": (3.9e12, 835e12, 60e12),
    "H200": (4.8e12, 989e12, 67e12),
    "H100": (3.35e12, 989e12, 67e12),          # SXM (80GB HBM3)
}


def card_peaks(name: str) -> Tuple[float, float, float]:
    """(memory bytes/s, bf16 flop/s, fp32 flop/s) of the card `name`; an
    unknown card takes the H100 SXM's."""
    for key, peaks in CARD_PEAKS.items():
        if key in name:
            return peaks
    return CARD_PEAKS["H100"]


def bound(bytes_moved: float, ops: float, op_peak: float,
          mem_rate: float) -> float:
    """Seconds: the larger of bytes over the memory rate and operations
    over their peak."""
    return max(bytes_moved / mem_rate, ops / op_peak)


def layernorm_fwd_bound(rows: int, width: int, elem: int, peaks) -> float:
    """Kernel C on x [rows, width]: x read and y written once, fp32 gamma
    and beta read once; 8 fp32 operations an element."""
    mem_rate, _, fp32_peak = peaks
    n = rows * width
    return bound(2 * n * elem + 2 * width * 4, 8.0 * n, fp32_peak, mem_rate)


def layernorm_bwd_bound(rows: int, width: int, elem: int, peaks) -> float:
    """Kernel D on x, dy [rows, width]: both read and dx written once,
    gamma read and dgamma, dbeta written once; 10 fp32 operations an
    element."""
    mem_rate, _, fp32_peak = peaks
    n = rows * width
    return bound(3 * n * elem + 3 * width * 4, 10.0 * n, fp32_peak,
                 mem_rate)


def kmedoids_fixed_work(segments: int, n: int, k: int) -> Tuple[float, float]:
    """(bytes, fp32 operations) of kernel E on `segments` segments of n
    points into k clusters that the shapes alone fix: of the distances the
    K medoid rows, the norms read once, the assignment, medoids and step
    counts written once; KKZ's 2 operations a point a pick and the last
    assignment's 1 a point a medoid.  The Lloyd steps and the member sums
    depend on the data and are left out, so this is a lower bound."""
    b = segments
    bytes_moved = 4.0 * (b * k * n + b * n + b * n + b * k + b)
    ops = float(b * 2 * k * n + b * n * k)
    return bytes_moved, ops


def kmedoids_bound(segments: int, n: int, k: int, peaks) -> float:
    mem_rate, _, fp32_peak = peaks
    bytes_moved, ops = kmedoids_fixed_work(segments, n, k)
    return bound(bytes_moved, ops, fp32_peak, mem_rate)
