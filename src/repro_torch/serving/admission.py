"""Request admission: a bounded queue with typed backpressure
(counterpart of ``repro/serving/admission.py``).

Producers call ``AdmissionQueue.submit`` (thread-safe) and get an
``AdmissionTicket`` back at once: accepted and queued, or rejected with
``queue_full`` when the queue is at capacity.  The engine drains the
queue at tick boundaries and records the stalls it sees here:
``no_free_slot`` (every slot live or mid-prefill) and
``pages_exhausted`` (the paged plan's pool cannot hold the prompt's
private pages).  A pool-starved request goes back at the *head* of the
queue (``requeue_front``), so no later arrival overtakes it.

The accounting lives on an ``obs.MetricsRegistry`` --
``admission_rejected_total``, ``admission_requeued_total`` and
``admission_blocked_total{reason=...}`` -- shared with the engine that
owns the queue (one metrics plane per serving process); ``n_rejected``,
``n_requeued`` and ``blocked`` read through to it.
"""
from __future__ import annotations

import collections
import threading
from dataclasses import dataclass

from ..obs import MetricsRegistry

__all__ = ["AdmissionQueue", "AdmissionTicket", "QUEUE_FULL",
           "NO_FREE_SLOT", "PAGES_EXHAUSTED"]

QUEUE_FULL = "queue_full"
NO_FREE_SLOT = "no_free_slot"
PAGES_EXHAUSTED = "pages_exhausted"


@dataclass(frozen=True)
class AdmissionTicket:
    """What ``submit`` hands back: ``accepted`` means the request is in
    the queue (``position`` = 0-based depth at enqueue time); ``reason``
    is ``"queued"`` or the backpressure reason it bounced on."""
    accepted: bool
    reason: str
    position: int | None = None


class AdmissionQueue:
    """Bounded FIFO between request producers and the engine tick loop.

    All mutation is under one lock: ``submit`` may run on any thread,
    ``pop`` / ``requeue_front`` / ``note_blocked`` are engine-side.  A
    full queue rejects rather than blocking the producer."""

    def __init__(self, capacity: int | None = None,
                 registry: MetricsRegistry | None = None):
        if capacity is not None and capacity < 1:
            raise ValueError(f"queue capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._dq: collections.deque = collections.deque()
        self._lock = threading.Lock()
        # The engine passes its registry; a standalone queue gets its own.
        self._registry = (registry if registry is not None
                          else MetricsRegistry())
        self._c_rejected = self._registry.counter(
            "admission_rejected_total",
            help="queue_full bounces at submit")
        self._c_requeued = self._registry.counter(
            "admission_requeued_total",
            help="head requeues (pages_exhausted)")
        self._c_blocked: dict = {}
        self.last_blocked: str | None = None

    def _blocked_counter(self, reason: str):
        c = self._c_blocked.get(reason)
        if c is None:
            c = self._c_blocked[reason] = self._registry.counter(
                "admission_blocked_total",
                help="backpressure stalls by typed reason", reason=reason)
        return c

    @property
    def n_rejected(self) -> int:
        return int(self._c_rejected.value)

    @property
    def n_requeued(self) -> int:
        return int(self._c_requeued.value)

    @property
    def blocked(self) -> collections.Counter:
        """``admission_blocked_total`` by reason (absent reasons read
        0)."""
        return collections.Counter(
            {r: int(c.value) for r, c in self._c_blocked.items()})

    def submit(self, req) -> AdmissionTicket:
        with self._lock:
            if (self.capacity is not None
                    and len(self._dq) >= self.capacity):
                self._c_rejected.inc()
                self._blocked_counter(QUEUE_FULL).inc()
                self.last_blocked = QUEUE_FULL
                return AdmissionTicket(False, QUEUE_FULL)
            self._dq.append(req)
            return AdmissionTicket(True, "queued", len(self._dq) - 1)

    def pop(self):
        """Next request to admit, or None when empty (engine-side)."""
        with self._lock:
            return self._dq.popleft() if self._dq else None

    def requeue_front(self, req, reason: str) -> None:
        """Put a request the engine could not admit back at the *head*
        of the queue, recording the typed ``reason``: it retries before
        anything that arrived after it."""
        with self._lock:
            self._dq.appendleft(req)
            self._c_requeued.inc()
            self._blocked_counter(reason).inc()
            self.last_blocked = reason

    def note_blocked(self, reason: str) -> None:
        """Record a stall that dequeued nothing (``no_free_slot``)."""
        with self._lock:
            self._blocked_counter(reason).inc()
            self.last_blocked = reason

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)

    def __bool__(self) -> bool:
        return len(self) > 0
