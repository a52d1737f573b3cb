"""Observability plane (counterpart of ``repro/obs``): so far the
fixed-bucket histogram the trainer's step times use; the metrics
registry, the flight recorder and the serving engine's wiring are
ROADMAP A.8."""
from .metrics import LATENCY_MS_BUCKETS, Histogram, exp_buckets

__all__ = ["Histogram", "exp_buckets", "LATENCY_MS_BUCKETS"]
