"""Observability plane (counterpart of ``repro/obs``): metrics registry
and flight recorder.

The serving engine (and the trainer) report through one substrate:

* ``metrics`` -- dependency-free Counter / Gauge / Histogram registry
  with JSON-snapshot and Prometheus-text serialization;
* ``flight`` -- a JSONL flight recorder of typed per-request lifecycle
  events and per-tick engine snapshots, replayable offline;
* ``Observability`` -- the bundle a component takes as one argument:
  registry, recorder, clock and op-sampling cadence.

Stdlib only: importing it imports neither torch nor anything else.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from .flight import (EVENT_FIELDS, NULL, FlightRecorder,
                     NullFlightRecorder, parse_events, read_events,
                     replay_summary)
from .metrics import (LATENCY_MS_BUCKETS, TIME_S_BUCKETS, Counter, Gauge,
                      Histogram, MetricsRegistry, exp_buckets)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "exp_buckets", "LATENCY_MS_BUCKETS", "TIME_S_BUCKETS",
           "FlightRecorder", "NullFlightRecorder", "NULL",
           "EVENT_FIELDS", "parse_events", "read_events",
           "replay_summary", "Observability"]


@dataclass
class Observability:
    """What a component needs to report: one registry, one recorder,
    one clock.  The default is the cheap always-on configuration --
    counters and latency histograms record (a handful of float ops per
    tick), the flight recorder is the no-op ``NULL`` and op sampling is
    off, so a bare ``ServingEngine`` pays nothing measurable for its
    metrics plane.

    ``flight_path`` builds a real recorder on the bundle's clock
    (``Observability(flight_path="flight.jsonl")``).
    ``sample_ops_every=N`` makes the engine time one decode tick in N
    op by op (``runtime/executor.py::OpTimingSampler``): per-op-kind
    time at 1/N cost, on a copy of the engine's state."""
    registry: MetricsRegistry = field(default_factory=MetricsRegistry)
    flight: object = NULL
    clock: object = time.perf_counter
    sample_ops_every: int = 0
    flight_path: object = None

    def __post_init__(self):
        if self.flight_path is not None and self.flight is NULL:
            self.flight = FlightRecorder(self.flight_path,
                                         clock=self.clock)

    @property
    def flight_enabled(self) -> bool:
        return self.flight.enabled

    def close(self) -> None:
        self.flight.close()
