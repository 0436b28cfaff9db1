"""Arithmetic of the metrics, on plain lists: no device, no program.

`exact_percentile` is a frozen copy of trino_tpu_torch/serving/harness.py's
(nearest rank over the raw samples); the harness keeps its own so a later
change to the program cannot move the yardstick.
"""

from __future__ import annotations

import statistics
from typing import Iterable, List, Sequence, Tuple


def exact_percentile(samples: List[float], q: float) -> float:
    """Nearest-rank percentile over the raw sample list."""
    if not samples:
        return 0.0
    s = sorted(samples)
    idx = max(0, min(len(s) - 1, int(round(q * (len(s) - 1)))))
    return s[idx]


def spread(values: Sequence[float]) -> float:
    """(third quartile - first quartile) / median, the quartiles as
    statistics.quantiles(values, n=4) gives them."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals as sorted disjoint intervals."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def covered(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of [lo, hi) that the intervals cover."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in union(intervals))


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The parts of [lo, hi) that no interval covers."""
    out, at = [], lo
    for a, b in union(intervals):
        if b <= lo or a >= hi:
            continue
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < hi:
        out.append((at, hi))
    return out
