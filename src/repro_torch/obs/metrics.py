"""Fixed-bucket histograms (a copy of the ``Histogram`` and
``exp_buckets`` of ``repro/obs/metrics.py``, which the port may not
import).  The trainer's step-time straggler check uses them; the rest of
that module -- counters, gauges and the registry with its JSON and
Prometheus serializations -- comes with its first caller (ROADMAP A.8).

Histograms never store samples; percentiles are interpolated from fixed
bucket counts, so memory is O(buckets) however long the process runs,
and a reported percentile is within its bucket's width of the true
sample percentile.  Stdlib only.
"""
from __future__ import annotations

from bisect import bisect_left

__all__ = ["Histogram", "exp_buckets", "LATENCY_MS_BUCKETS"]


def exp_buckets(lo: float, hi: float, factor: float = 2.0) -> list:
    """Geometric bucket upper bounds from ``lo`` up past ``hi`` —
    constant *relative* percentile error across the range."""
    if lo <= 0 or factor <= 1:
        raise ValueError(f"need lo > 0 and factor > 1, got {lo}, {factor}")
    edges, e = [], lo
    while True:
        edges.append(e)
        if e >= hi:
            return edges
        e *= factor


# Latencies in milliseconds: 1 µs .. ~2 min at 2x resolution — covers a
# sub-ms decode tick and a multi-second cold prefill in one layout.
LATENCY_MS_BUCKETS = exp_buckets(1e-3, 120e3)


class Histogram:
    """Fixed-bucket histogram with interpolated percentiles.

    ``buckets`` are ascending upper bounds; observations above the last
    bound land in an implicit overflow bucket.  ``percentile(q)``
    linearly interpolates within the winning bucket (lower bound of
    bucket 0 is 0, of the overflow bucket the last edge) — the
    guarantee is ±(bucket width) vs the exact sample percentile, and
    the overflow bucket reports its lower edge (a *floor*, flagged by
    ``saturated``)."""
    __slots__ = ("buckets", "counts", "count", "sum")

    def __init__(self, buckets=None):
        b = list(LATENCY_MS_BUCKETS if buckets is None else buckets)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"buckets must be ascending, got {b}")
        self.buckets = b
        self.counts = [0] * (len(b) + 1)          # + overflow
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.buckets, v)] += 1
        self.count += 1
        self.sum += v

    @property
    def saturated(self) -> int:
        """Observations past the last bucket edge (their percentile
        contribution is floored at that edge)."""
        return self.counts[-1]

    def percentile(self, q: float) -> float:
        """Interpolated q-th percentile (0 <= q <= 100); 0.0 when
        empty."""
        if not 0 <= q <= 100:
            raise ValueError(f"percentile wants 0..100, got {q}")
        if self.count == 0:
            return 0.0
        rank = q / 100.0 * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = 0.0 if i == 0 else self.buckets[i - 1]
                if i == len(self.buckets):        # overflow: floor
                    return self.buckets[-1]
                hi = self.buckets[i]
                return lo + (hi - lo) * max(rank - cum, 0.0) / c
            cum += c
        return self.buckets[-1]

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0
