"""Fault-tolerant training loop (counterpart of
``repro/runtime/trainer.py``).

Behaviours (tests/test_torch_train.py):

* **checkpoint/restart** — async checkpoints every
  ``ckpt_every`` steps; on start the trainer auto-resumes from the
  latest committed step (data iterator state = the step counter, so the
  stream continues exactly where it left off);
* **preemption** — SIGTERM/SIGINT installs a flag; the loop finishes
  the in-flight step, forces a checkpoint, and exits cleanly (the
  process's own handlers are put back when ``run`` returns);
* **straggler / hang detection** — a ring buffer of host-side step
  times; a step slower than ``straggler_factor`` x the trailing median
  raises a logged anomaly (on multi-host deployments this is the signal
  to evict the slow host and re-shard — here it feeds the log + metrics
  so tests can assert on it).  The median comes off an
  ``obs.Histogram`` over the window — the fixed-bucket type of the
  metrics plane — and a cumulative ``step_time_s``
  histogram rides in ``metrics_history`` (p50/p99 per log record);
* **NaN containment** — a non-finite loss is logged as an anomaly and
  counts toward an abort threshold (``FloatingPointError`` at
  ``max_nan_steps``).

Each batch is moved to ``device`` (the card unless the caller names
another, through ``resolve_device``) before the step; the step's
``float(metrics["loss"])`` waits for the device, so ``dt`` is a real
step time.
"""
from __future__ import annotations

import logging
import signal
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..checkpoint.store import AsyncCheckpointer, latest_step, \
    restore_checkpoint
from ..kernels.common import resolve_device
from ..obs import Histogram, exp_buckets

__all__ = ["TrainerConfig", "Trainer"]

log = logging.getLogger("repro_torch.trainer")

# Fine geometric buckets (factor 1.1 => percentile error <= 10%) for
# host-side step times: sub-100us jitted steps up to 20-minute stalls.
_STEP_TIME_BUCKETS = exp_buckets(1e-5, 1200.0, factor=1.1)


@dataclass
class TrainerConfig:
    ckpt_dir: str                    # the caller's (``launch.train``'s CLI)
    total_steps: int = 100
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    straggler_window: int = 32
    max_nan_steps: int = 10


@dataclass
class Trainer:
    step_fn: object                  # (params, opt, batch) -> ...
    data: object                     # .batch_at(step) -> dict of np arrays
    cfg: TrainerConfig
    device: object = None            # where batches go (default: the card)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._preempted = False
        self._times: list[float] = []
        self.anomalies: list[dict] = []
        self.metrics_history: list[dict] = []
        # Cumulative step-time distribution (whole run, never evicted)
        # — the metrics-plane view next to the trailing window above.
        self.step_time_hist = Histogram(_STEP_TIME_BUCKETS)

    # -- signals ---------------------------------------------------------------
    def _install_signals(self) -> dict:
        """Install the preemption handler; returns the handlers it
        replaced, which ``run`` puts back when it returns."""
        def handler(signum, frame):
            log.warning("preemption signal %s: checkpoint + exit", signum)
            self._preempted = True
        previous = {}
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                previous[sig] = signal.signal(sig, handler)
        except ValueError:
            pass   # not on the main thread (tests)
        return previous

    # -- straggler detection -----------------------------------------------------
    def _record_time(self, step: int, dt: float):
        self._times.append(dt)
        if len(self._times) > self.cfg.straggler_window:
            self._times.pop(0)
        self.step_time_hist.observe(dt)
        if len(self._times) >= 8:
            # Trailing-window median through the shared Histogram type
            # (<= straggler_window observes per step — negligible next
            # to the step).  Bucket factor 1.1 bounds the
            # percentile error at ~10%, far inside straggler_factor.
            h = Histogram(_STEP_TIME_BUCKETS)
            for t in self._times[:-1]:
                h.observe(t)
            med = h.percentile(50)
            if dt > self.cfg.straggler_factor * med:
                anomaly = {"step": step, "dt": dt, "median": med,
                           "kind": "straggler"}
                self.anomalies.append(anomaly)
                log.warning("straggler step %d: %.3fs vs median %.3fs",
                            step, dt, med)

    # -- main loop ----------------------------------------------------------------
    def run(self, params, opt_state):
        """Train from the latest committed checkpoint (or the given
        state) to ``total_steps``; returns (params, opt_state, step)."""
        previous = self._install_signals()
        try:
            return self._run(params, opt_state)
        finally:
            for sig, h in previous.items():
                signal.signal(sig, h)

    def _run(self, params, opt_state):
        ckpt = AsyncCheckpointer(self.cfg.ckpt_dir, keep=self.cfg.keep)
        start = 0
        if latest_step(self.cfg.ckpt_dir) is not None:
            (params, opt_state), start = restore_checkpoint(
                self.cfg.ckpt_dir, (params, opt_state))
            log.info("resumed from step %d", start)

        nan_steps = 0
        step = start
        while step < self.cfg.total_steps and not self._preempted:
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.data.batch_at(step).items()}
            t0 = time.perf_counter()
            params, opt_state, metrics = self.step_fn(params, opt_state,
                                                      batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self._record_time(step, dt)
            if not np.isfinite(loss):
                nan_steps += 1
                self.anomalies.append({"step": step, "kind": "nan"})
                log.warning("non-finite loss at step %d (%d/%d)", step,
                            nan_steps, self.cfg.max_nan_steps)
                if nan_steps >= self.cfg.max_nan_steps:
                    raise FloatingPointError(
                        f"{nan_steps} non-finite steps; aborting")
            if step % self.cfg.log_every == 0:
                rec = {"step": step, "loss": loss, "dt_s": dt,
                       "dt_p50_s": self.step_time_hist.percentile(50),
                       "dt_p99_s": self.step_time_hist.percentile(99)}
                rec.update({k: float(v) for k, v in metrics.items()
                            if k != "loss"})
                self.metrics_history.append(rec)
                log.info("step %d loss %.4f (%.3fs)", step, loss, dt)
            step += 1
            if step % self.cfg.ckpt_every == 0:
                ckpt.save(step, (params, opt_state))

        ckpt.wait()
        if self._preempted or step % self.cfg.ckpt_every != 0:
            ckpt.save(step, (params, opt_state))
            ckpt.wait()
        return params, opt_state, step
