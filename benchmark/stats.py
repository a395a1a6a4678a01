"""The arithmetic of the metrics: percentiles, rates, spreads and the busy
time of a device timeline."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of all
    ``values``: the smallest value with at least q % of them at or below
    it."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def rate(count: float, seconds: float) -> float:
    """Work completed over the seconds it took."""
    if seconds <= 0:
        raise ValueError(f"rate over {seconds} s")
    return count / seconds


def spread(values) -> float:
    """The distance between the first and the third quartile as a share of
    the median (``statistics.quantiles`` with n = 4)."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def busy_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` ((start, end) pairs) clipped to
    [lo, hi]."""
    total = 0.0
    end = lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def idle_gaps(intervals, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    gaps = []
    end = lo
    for a, b in sorted(intervals):
        if a > end:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        gaps.append((end, hi))
    return [(a, b) for a, b in gaps if b > a]
