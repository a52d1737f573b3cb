"""Dependency-free metrics registry: Counter / Gauge / Histogram
(counterpart of ``repro/obs/metrics.py``, copied: the port may not
import it).

One registry instance is one metrics *plane*: every component of a
serving (or training) process registers its counters, gauges and
latency histograms here, and the whole plane serializes two ways --

* ``snapshot()`` -- a JSON-able dict (what ``launch/serve.py
  --metrics-out`` writes);
* ``prometheus_text()`` -- the Prometheus text exposition format, so a
  scraper can ingest the same numbers without a client library.

``Counter.inc`` is one float add and ``Histogram.observe`` one
``bisect`` and two adds; no locks (the engine tick loop is
single-threaded, ``AdmissionQueue`` serializes its own mutation), no
allocation after registration.  Histograms never store samples:
percentiles are interpolated from fixed bucket counts, so memory is
O(buckets) however long the process runs, and a reported percentile is
within its bucket's width of the true sample percentile.  Stdlib only.

Labels follow the Prometheus model: a *family* (name, kind, help,
bucket layout) owns one child metric per label-set, created on first
use -- ``registry.counter("admission_blocked_total",
reason="queue_full")`` returns the same child every call.
"""
from __future__ import annotations

import json
from bisect import bisect_left

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "exp_buckets", "LATENCY_MS_BUCKETS", "TIME_S_BUCKETS"]


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
# Wallclock in seconds (training steps): 10 µs .. ~20 min.
TIME_S_BUCKETS = exp_buckets(1e-5, 1200.0)


class Counter:
    """Monotone counter.  ``inc`` only; read via ``.value``."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counters only go up, got inc({n})")
        self.value += n


class Gauge:
    """Last-write-wins scalar (queue depth, free pages, flags)."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


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


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One metric name: kind, help text, bucket layout, and one child
    per label-set (children share the family's bucket layout)."""
    __slots__ = ("name", "kind", "help", "buckets", "children")

    def __init__(self, name, kind, help_, buckets=None):
        self.name = name
        self.kind = kind
        self.help = help_
        self.buckets = buckets
        self.children: dict[tuple, object] = {}

    def child(self, labels: tuple):
        m = self.children.get(labels)
        if m is None:
            m = (Histogram(self.buckets) if self.kind == "histogram"
                 else _KINDS[self.kind]())
            self.children[labels] = m
        return m


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _flat_name(name: str, labels: tuple) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """The process's metric families.  ``counter``/``gauge``/
    ``histogram`` register-or-fetch (same name + labels → same child
    object, so hot paths can hold the child directly and skip the
    lookup)."""

    def __init__(self):
        self._families: dict[str, _Family] = {}

    def _get(self, name, kind, help_, buckets=None):
        fam = self._families.get(name)
        if fam is None:
            fam = _Family(name, kind, help_, buckets)
            self._families[name] = fam
        elif fam.kind != kind:
            raise ValueError(f"{name} already registered as {fam.kind}")
        return fam

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(name, "counter", help).child(_label_key(labels))

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(name, "gauge", help).child(_label_key(labels))

    def histogram(self, name: str, help: str = "", buckets=None,
                  **labels) -> Histogram:
        return self._get(name, "histogram", help,
                         buckets).child(_label_key(labels))

    # -- serialization ----------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able view: ``counters`` / ``gauges`` map flat names
        (labels folded into the key) to values; ``histograms`` carry
        bucket layout + counts + the headline percentiles so consumers
        never re-implement the interpolation."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for fam in self._families.values():
            for labels, m in sorted(fam.children.items()):
                key = _flat_name(fam.name, labels)
                if fam.kind == "counter":
                    out["counters"][key] = m.value
                elif fam.kind == "gauge":
                    out["gauges"][key] = m.value
                else:
                    out["histograms"][key] = {
                        "count": m.count, "sum": m.sum,
                        "buckets": m.buckets, "counts": m.counts,
                        "p50": m.percentile(50), "p90": m.percentile(90),
                        "p99": m.percentile(99),
                    }
        return out

    def to_json(self, **meta) -> str:
        return json.dumps({**({"meta": meta} if meta else {}),
                           **self.snapshot()}, indent=2, sort_keys=True)

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (histograms as cumulative
        ``_bucket{le=...}`` series plus ``_sum``/``_count``)."""
        lines = []
        for fam in sorted(self._families.values(), key=lambda f: f.name):
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for labels, m in sorted(fam.children.items()):
                if fam.kind in ("counter", "gauge"):
                    lines.append(f"{_flat_name(fam.name, labels)} "
                                 f"{_fmt(m.value)}")
                    continue
                cum = 0
                for edge, c in zip(m.buckets + [float("inf")], m.counts):
                    cum += c
                    le = "+Inf" if edge == float("inf") else _fmt(edge)
                    lines.append(f"{_flat_name(fam.name + '_bucket', labels + (('le', le),))} {cum}")
                lines.append(f"{_flat_name(fam.name + '_sum', labels)} "
                             f"{_fmt(m.sum)}")
                lines.append(f"{_flat_name(fam.name + '_count', labels)} "
                             f"{m.count}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(float(v))
