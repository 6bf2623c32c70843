"""The arithmetic of the metrics: rates over a window, tails with their
sample counts, spreads, and the union of device intervals."""
from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Sequence, Tuple


def rate(count: float, seconds: float) -> float:
    """Work completed over the window's length."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return count / seconds


def percentile(values: Sequence[float], q: float) -> Tuple[float, int]:
    """(the q-th percentile by nearest rank, the number of samples beyond
    it): the smallest value with at least q % of the samples at or below
    it."""
    if not values:
        raise ValueError("no samples")
    s = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(s)))
    return s[k - 1], len(s) - k


def spread(values: Sequence[float]) -> float:
    """The distance between the first and the third quartile as a share
    of the median (Python's ``statistics.quantiles``, n = 4)."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of [start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi) that no interval covers, in order."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if a > end:
            out.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]
