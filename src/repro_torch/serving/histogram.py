"""Bounded-memory log-bucketed mergeable histograms — port of
``repro/serving/histogram.py`` (host-only, copied).

``ServerMetrics`` previously kept every TTFT/ITL/queue/service sample in
raw Python lists — an unbounded leak on a long-lived server (the module
docstring promised bounded memory; it lied).  :class:`Histogram` fixes
that: samples land in geometrically-spaced buckets (sparse dict, at most
``max_buckets`` entries regardless of sample count), so memory is O(1)
per sample and O(log(max/min)) total, while quantile error is bounded by
one bucket's relative width (``growth - 1``, ~15% by default — tighter
than the natural run-to-run variance of any latency it measures).

Properties the serving stack relies on (tests/test_observability.py):

* **Mergeable**: ``merge`` of per-lane histograms is exactly equivalent
  to single-pass ingestion of the concatenated samples (bucket counts
  are integers; addition commutes) — hypothesis-tested.
* **Exact edges**: ``count``/``sum``/``min``/``max`` are tracked
  exactly, so ``mean`` and ``max`` in summaries are exact, and
  percentile estimates are clamped to the observed ``[min, max]`` —
  a single-sample histogram reports its one value *exactly*, which
  keeps ``ServerMetrics.summary()``'s small-n behaviour (pinned by the
  serving front-end tests) unchanged.
* **Nearest-rank quantiles**: same ceil-based nearest-rank convention
  as the reference's ``serving/metrics.percentile`` — the bucket holding the
  k-th smallest sample (k = ⌈q/100·n⌉) is found by cumulative count
  and represented by its geometric midpoint.

Values ≤ ``min_value`` (including zero — ITL of a same-step token) fall
into a dedicated underflow bucket represented as ``min_value`` before
clamping; values ≥ ``max_value`` clamp into the top bucket.  Negative
values are invalid (latencies only) and raise.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Optional


class Histogram:
    """Log-bucketed histogram: bucket ``i`` covers
    ``[min_value * growth**i, min_value * growth**(i+1))``."""

    __slots__ = ("min_value", "max_value", "growth", "_inv_log_g",
                 "max_buckets", "buckets", "count", "total",
                 "vmin", "vmax")

    def __init__(self, *, min_value: float = 1e-6, max_value: float = 1e7,
                 growth: float = 1.15):
        if not (min_value > 0 and max_value > min_value and growth > 1):
            raise ValueError("need 0 < min_value < max_value, growth > 1")
        self.min_value = float(min_value)
        self.max_value = float(max_value)
        self.growth = float(growth)
        self._inv_log_g = 1.0 / math.log(self.growth)
        # bucket index of max_value, +1 for the underflow bucket (-1)
        self.max_buckets = int(math.ceil(
            math.log(self.max_value / self.min_value) * self._inv_log_g)) + 1
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None

    # ------------------------------------------------------------------
    def _index(self, v: float) -> int:
        if v <= self.min_value:
            return -1                              # underflow bucket
        i = int(math.floor(math.log(v / self.min_value) * self._inv_log_g))
        return min(i, self.max_buckets - 2)        # clamp overflow to top

    def _bounds(self, i: int) -> tuple:
        if i < 0:
            return (0.0, self.min_value)
        lo = self.min_value * self.growth ** i
        return (lo, lo * self.growth)

    # ------------------------------------------------------------------
    def add(self, v: float, n: int = 1) -> None:
        """Record ``n`` occurrences of value ``v`` (seconds, tokens, ...)."""
        v = float(v)
        if v < 0 or v != v:
            raise ValueError(f"histogram values must be finite >= 0: {v}")
        if n <= 0:
            return
        i = self._index(v)
        self.buckets[i] = self.buckets.get(i, 0) + n
        self.count += n
        self.total += v * n
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)

    def extend(self, values: Iterable[float]) -> None:
        for v in values:
            self.add(v)

    def merge(self, other: "Histogram") -> "Histogram":
        """In-place merge; bucket layouts must match exactly."""
        if (other.min_value != self.min_value
                or other.max_value != self.max_value
                or other.growth != self.growth):
            raise ValueError("cannot merge histograms with different "
                             "bucket layouts")
        for i, n in other.buckets.items():
            self.buckets[i] = self.buckets.get(i, 0) + n
        self.count += other.count
        self.total += other.total
        if other.vmin is not None:
            self.vmin = other.vmin if self.vmin is None \
                else min(self.vmin, other.vmin)
            self.vmax = other.vmax if self.vmax is None \
                else max(self.vmax, other.vmax)
        return self

    # ------------------------------------------------------------------
    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else math.nan

    def percentile(self, q: float) -> float:
        """Nearest-rank quantile estimate, clamped to the exact observed
        ``[min, max]`` (single-sample and extreme quantiles are exact)."""
        if not self.count:
            return math.nan
        k = max(1, int(math.ceil(q / 100.0 * self.count)))
        k = min(k, self.count)
        seen = 0
        idx = None
        for i in sorted(self.buckets):
            seen += self.buckets[i]
            if seen >= k:
                idx = i
                break
        lo, hi = self._bounds(idx)
        rep = self.min_value if idx < 0 else math.sqrt(lo * hi)
        return min(max(rep, self.vmin), self.vmax)

    def summary(self) -> dict:
        """Same schema as ``metrics._dist``: ``{"n": 0}`` when empty,
        else n/mean/p50/p99/max (mean and max exact)."""
        if not self.count:
            return {"n": 0}
        return {"n": self.count,
                "mean": self.mean,
                "p50": self.percentile(50),
                "p99": self.percentile(99),
                "max": self.vmax}

    def to_dict(self) -> dict:
        """Full bucket dump (Prometheus-style cumulative export feeds
        off this): upper bounds + counts, sorted."""
        items = sorted(self.buckets.items())
        return {"count": self.count,
                "sum": self.total,
                "min": self.vmin,
                "max": self.vmax,
                "le": [self._bounds(i)[1] for i, _ in items],
                "counts": [n for _, n in items]}

    def __len__(self) -> int:
        return len(self.buckets)

    def __repr__(self) -> str:           # pragma: no cover - debug aid
        return (f"Histogram(n={self.count}, buckets={len(self.buckets)}, "
                f"min={self.vmin}, max={self.vmax})")
