"""The benchmark's statistics: rates over a whole window, a tail over every
request, and the spread that the bounds in BENCHMARK.json are set from."""
from __future__ import annotations

import math
import statistics


def rate(units: float, seconds: float) -> float:
    """All the work of a window over all its time."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s has no rate")
    return units / seconds


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100): the smallest value
    that at least q% of the values do not exceed, one of the samples."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no samples")
    if not 0 < q <= 100:
        raise ValueError(f"percentile {q} is outside (0, 100]")
    return xs[max(math.ceil(q / 100 * len(xs)), 1) - 1]


def spread(values) -> float:
    """The distance between the first and the third quartile, as a share of
    the median (statistics.quantiles, its default exclusive method)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(med)
