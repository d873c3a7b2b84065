"""The benchmark's arithmetic: the 95th percentile, the union of device
intervals, idle gaps and the roofline bound, on plain numbers."""

from __future__ import annotations

import numpy as np

# Published peaks of the cards the benchmark runs on (NVIDIA's data sheet,
# SXM part, dense): FP32 outside the tensor cores and HBM bandwidth.  A
# roofline share is stated against these, with the card's power limit beside
# it.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(device_name: str) -> dict:
    try:
        return PEAKS[device_name]
    except KeyError:
        raise KeyError(f"no published peaks for {device_name!r}; add them "
                       "to port_bench/stats.py:PEAKS") from None


def bound_ms(ops: float, n_bytes: float, device_name: str) -> float:
    """The least time the card could take: the larger of the operations
    over the FP32 peak and the bytes over the memory rate."""
    p = peaks(device_name)
    return max(ops / p["fp32_flops"], n_bytes / p["hbm_bytes_per_s"]) * 1e3


def p95(values) -> float:
    """The 95th percentile (numpy's linear interpolation) of all values."""
    return float(np.percentile(np.asarray(values, np.float64), 95))


def union_length(intervals) -> float:
    """Total length covered by ``(start, end)`` intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def idle_gaps(intervals, start: float, end: float):
    """The stretches of ``[start, end]`` that no interval covers, as
    ``(gap_start, gap_end)`` in order."""
    gaps, reach = [], start
    for a, b in sorted(intervals):
        if a > reach:
            gaps.append((reach, min(a, end)))
        reach = max(reach, b)
        if reach >= end:
            break
    if reach < end:
        gaps.append((reach, end))
    return [(a, b) for a, b in gaps if b > a]
