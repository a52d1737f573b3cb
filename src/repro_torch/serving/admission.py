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

The accounting is plain integer counters (``n_rejected``,
``n_requeued``, ``blocked`` by reason); the reference keeps them on its
``obs`` metrics registry, which is not ported yet (ROADMAP A.8).
"""
from __future__ import annotations

import collections
import threading
from dataclasses import dataclass

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

    def __init__(self, capacity: int | None = None):
        if capacity is not None and capacity < 1:
            raise ValueError(f"queue capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._dq: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self.n_rejected = 0
        self.n_requeued = 0
        self.blocked: collections.Counter = collections.Counter()
        self.last_blocked: str | None = None

    def submit(self, req) -> AdmissionTicket:
        with self._lock:
            if (self.capacity is not None
                    and len(self._dq) >= self.capacity):
                self.n_rejected += 1
                self.blocked[QUEUE_FULL] += 1
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
            self.n_requeued += 1
            self.blocked[reason] += 1
            self.last_blocked = reason

    def note_blocked(self, reason: str) -> None:
        """Record a stall that dequeued nothing (``no_free_slot``)."""
        with self._lock:
            self.blocked[reason] += 1
            self.last_blocked = reason

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)

    def __bool__(self) -> bool:
        return len(self) > 0
