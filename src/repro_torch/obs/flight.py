"""Flight recorder: typed per-request lifecycle events as JSONL
(counterpart of ``repro/obs/flight.py``, copied: the port may not import
it).

The serving engine's black box.  Every externally meaningful state
transition of a request -- enqueue, admission ticket (including the
typed backpressure rejections), each prefill chunk, first token, every
later token, speculative propose / accept / rollback, COW page forks,
release -- plus one per-tick engine snapshot lands here as one JSON
object per line.  The stream is *replayable*: ``replay_summary``
rebuilds each request's token stream, TTFT and inter-token latencies
from the recorded events alone, so a serving run can be audited from
the artifact, with no re-run.

``EVENT_FIELDS`` names the required fields per event type and
``FlightRecorder.event`` enforces them at emit time, so a malformed
event fails at its producer.  Extra fields are allowed.  Every event
carries ``ev`` (the type tag) and ``t`` (seconds on the recorder's
clock, ``time.perf_counter`` unless another is injected).

Disabled mode is the module-level ``NULL`` recorder: ``event`` does
nothing and ``events`` is an empty tuple, so the engine runs the same
code either way.  Stdlib only; the files and records are
interchangeable with the reference's.
"""
from __future__ import annotations

import json
import time

__all__ = ["EVENT_FIELDS", "FlightRecorder", "NullFlightRecorder", "NULL",
           "read_events", "parse_events", "replay_summary"]

# Required fields per event type (beyond the implicit ev/t).
EVENT_FIELDS: dict[str, tuple] = {
    "enqueue":       ("uid", "prompt_len"),
    "admission":     ("accepted", "reason"),          # + uid when known
    "prefill_start": ("uid", "slot", "length", "write_from"),
    "prefill_chunk": ("uid", "slot", "start", "stop"),
    "first_token":   ("uid", "slot", "token", "ttft_ms"),
    "token":         ("uid", "slot", "token", "itl_ms"),
    "spec":          ("slot", "uid", "proposed", "accepted", "rollback"),
    "cow_fork":      ("slot", "src_page", "dst_page"),
    "release":       ("uid", "slot", "n_tokens", "reason"),
    "tick":          ("tick", "dt_ms", "live", "queue_depth",
                      "free_pages", "starved"),
    "fallback":      ("reason",),
    "op_sample":     ("kind", "name", "measured_time_s"),
}


class FlightRecorder:
    """Buffered JSONL event sink.  The hot path (``event``) does only
    the schema check and a list append — JSON serialization and file
    IO are deferred to ``flush``/``close``, which write every
    not-yet-written event, so a tick pays no serialization; a long-lived
    server should call ``flush`` periodically (tick boundary, every
    few seconds) so a crash loses at most one flush interval."""

    def __init__(self, path=None, clock=time.perf_counter):
        self.events: list[dict] = []
        self.clock = clock
        self.path = str(path) if path is not None else None
        self._fh = open(path, "w") if path is not None else None
        self._written = 0

    @property
    def enabled(self) -> bool:
        return True

    def event(self, ev: str, **fields) -> None:
        required = EVENT_FIELDS.get(ev)
        if required is None:
            raise ValueError(f"unknown flight event type {ev!r} "
                             f"(add it to EVENT_FIELDS)")
        missing = [k for k in required if k not in fields]
        if missing:
            raise ValueError(f"flight event {ev!r} missing required "
                             f"fields {missing}")
        self.events.append({"ev": ev, "t": self.clock(), **fields})

    def flush(self) -> None:
        if self._fh is None:
            return
        pending = self.events[self._written:]
        if pending:
            self._fh.write("".join(json.dumps(rec) + "\n"
                                   for rec in pending))
            self._written = len(self.events)
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self.flush()
            self._fh.close()
            self._fh = None


class NullFlightRecorder:
    """Disabled mode: same interface, zero work, zero events."""
    events: tuple = ()
    path = None
    enabled = False

    def event(self, ev: str, **fields) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


NULL = NullFlightRecorder()


def parse_events(text: str) -> list[dict]:
    """JSONL text -> event dicts, with the schema check re-applied (a
    truncated or hand-edited record fails here, not in a consumer)."""
    events = []
    for i, line in enumerate(text.splitlines()):
        if not line.strip():
            continue
        rec = json.loads(line)
        ev = rec.get("ev")
        if ev not in EVENT_FIELDS:
            raise ValueError(f"line {i}: unknown event type {ev!r}")
        missing = [k for k in EVENT_FIELDS[ev]
                   if k not in rec] + [k for k in ("t",) if k not in rec]
        if missing:
            raise ValueError(f"line {i}: event {ev!r} missing {missing}")
        events.append(rec)
    return events


def read_events(path) -> list[dict]:
    with open(path) as f:
        return parse_events(f.read())


def replay_summary(events) -> dict:
    """Reconstruct the serving run from its flight record.

    Returns ``{"requests": {uid: {...}}, "totals": {...}}`` where each
    request carries its replayed token stream (``tokens`` — must match
    the engine's ``out_tokens`` exactly), TTFT and
    per-token inter-token latencies in ms (recomputed from event
    timestamps, *not* read from the recorded ttft_ms/itl_ms fields —
    the replay is an independent check of the producer), and the
    release reason.  Totals aggregate tokens, rejections, ticks and
    the max starved-tick count seen in any tick snapshot."""
    reqs: dict = {}

    def r(uid):
        return reqs.setdefault(uid, {
            "prompt_len": None, "tokens": [], "token_t": [],
            "enqueue_t": None, "slot": None, "ttft_ms": None,
            "itl_ms": [], "release_reason": None, "chunks": 0,
        })

    totals = {"n_enqueued": 0, "n_rejected": 0, "n_blocked": 0,
              "n_released": 0, "n_tokens": 0, "n_ticks": 0,
              "max_starved": 0, "n_spec_proposed": 0,
              "n_spec_accepted": 0, "n_cow_forks": 0, "fallbacks": []}
    for e in events:
        ev = e["ev"]
        if ev == "enqueue":
            q = r(e["uid"])
            q["prompt_len"] = e["prompt_len"]
            q["enqueue_t"] = e["t"]
            totals["n_enqueued"] += 1
        elif ev == "admission" and not e["accepted"]:
            # queue_full is a terminal submit-time rejection of one
            # request; no_free_slot / pages_exhausted are stalls — the
            # request stays queued (head-requeued) and is retried.
            if e["reason"] == "queue_full":
                totals["n_rejected"] += 1
                if "uid" in e:
                    r(e["uid"])["release_reason"] = e["reason"]
            else:
                totals["n_blocked"] += 1
        elif ev == "prefill_start":
            r(e["uid"])["slot"] = e["slot"]
        elif ev == "prefill_chunk":
            r(e["uid"])["chunks"] += 1
        elif ev in ("first_token", "token"):
            q = r(e["uid"])
            q["slot"] = e["slot"]
            if ev == "first_token" and q["enqueue_t"] is not None:
                q["ttft_ms"] = (e["t"] - q["enqueue_t"]) * 1e3
            if q["token_t"]:
                q["itl_ms"].append((e["t"] - q["token_t"][-1]) * 1e3)
            q["tokens"].append(e["token"])
            q["token_t"].append(e["t"])
            totals["n_tokens"] += 1
        elif ev == "spec":
            totals["n_spec_proposed"] += e["proposed"]
            totals["n_spec_accepted"] += e["accepted"]
        elif ev == "cow_fork":
            totals["n_cow_forks"] += 1
        elif ev == "release":
            q = r(e["uid"])
            q["release_reason"] = e["reason"]
            if len(q["tokens"]) != e["n_tokens"]:
                raise ValueError(
                    f"uid {e['uid']}: release says {e['n_tokens']} tokens "
                    f"but the event stream replayed {len(q['tokens'])}")
            totals["n_released"] += 1
        elif ev == "tick":
            totals["n_ticks"] += 1
            totals["max_starved"] = max(totals["max_starved"],
                                        e["starved"])
        elif ev == "fallback":
            totals["fallbacks"].append(e["reason"])
    for q in reqs.values():
        q.pop("token_t")
    return {"requests": reqs, "totals": totals}
