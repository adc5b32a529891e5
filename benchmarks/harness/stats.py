"""The arithmetic of the metrics, and the card's published peaks."""

from __future__ import annotations

import statistics

#: NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12


def p95(values) -> float:
    """The 95th percentile of all ``values`` (the exclusive method of
    ``statistics.quantiles(n=20)``; with fewer than two, their maximum)."""
    values = list(values)
    if len(values) < 2:
        return max(values)
    return statistics.quantiles(values, n=20)[18]


def rate(count: float, seconds: float) -> float:
    """Work over the whole window's wall time."""
    return count / seconds


def union_length(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: operations over the dtype's
    peak or bytes over the memory's, the larger."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def gaps(intervals, window: tuple[float, float]):
    """The idle (start, end) gaps of the device inside ``window``."""
    out, cursor = [], window[0]
    for a, b in sorted(intervals):
        if a > cursor:
            out.append((cursor, a))
        cursor = max(cursor, b)
    if window[1] > cursor:
        out.append((cursor, window[1]))
    return out
