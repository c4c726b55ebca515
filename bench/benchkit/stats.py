"""Arithmetic the readers share: nearest-rank percentiles, time per output
token, and the union of intervals."""
from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (q in [0, 100]): the smallest value with at
    least ``ceil(q/100 * n)`` samples at or below it; None for no samples.
    ``math.inf`` counts as a sample (a request that never answered)."""
    if not values:
        return None
    v = sorted(values)
    k = max(1, min(len(v), math.ceil(q / 100.0 * len(v))))
    return float(v[k - 1])


def tpot(first_t: float, last_t: float, tokens: int) -> Optional[float]:
    """Time per output token after the first: (last − first) / (tokens − 1);
    None for a request of fewer than two tokens."""
    if tokens < 2:
        return None
    return (last_t - first_t) / (tokens - 1)


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted, disjoint intervals covering the same points."""
    out: List[List[float]] = []
    for a, b in sorted((a, b) for a, b in intervals if b > a):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals: Iterable[Tuple[float, float]], lo: float, hi: float):
    """Each interval cut to [lo, hi]; the empty ones dropped."""
    return [(max(a, lo), min(b, hi)) for a, b in intervals if min(b, hi) > max(a, lo)]


def covered(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of the intervals."""
    return sum(b - a for a, b in union(intervals))


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float):
    """The parts of [lo, hi] that no interval covers."""
    out, t = [], lo
    for a, b in union(clip(intervals, lo, hi)):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def clip_named(items, lo: float, hi: float):
    """(name, start, end) items cut to [lo, hi]; the empty ones dropped."""
    return [(n, max(a, lo), min(b, hi)) for n, a, b in items if min(b, hi) > max(a, lo)]
