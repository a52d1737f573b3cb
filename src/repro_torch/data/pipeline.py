"""Sharded token data pipeline (counterpart of ``repro/data/pipeline.py``;
the sources and the prefetcher are numpy and stdlib, copied so that the
port imports nothing of ``repro``).

Deterministic, restart-safe (the iterator state is one integer — the
global step — checkpointed with the model), host-sharded (each host
materializes only its slice of the global batch), with background
prefetch.  Two sources:

* ``SyntheticLM`` — seeded random tokens with a simple learnable n-gram
  structure (used by the end-to-end examples and tests);
* ``PackedFileDataset`` — memory-mapped uint16/uint32 token files
  (one long stream), packed into fixed-length rows.

The paper's T4 applies here too: hosts are "load units" — the sampler
assigns disjoint, contiguous row ranges per host so byte traffic is
balanced (percent imbalance 0 by construction).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["SyntheticLM", "PackedFileDataset", "Prefetcher", "make_batches"]


@dataclass(frozen=True)
class SyntheticLM:
    """Seeded synthetic LM stream: token t+1 = (a*t + noise) % vocab.

    Loss decreases measurably within a few hundred steps on a ~100M
    model, which is what the end-to-end example needs to demonstrate.
    """

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    structure: float = 0.9   # prob. that the next token is predictable

    def batch_at(self, step: int, host_id: int = 0,
                 n_hosts: int = 1) -> dict:
        per_host = self.global_batch // n_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, host_id]))
        B, S, V = per_host, self.seq_len, self.vocab
        noise = rng.integers(0, V, size=(B, S), dtype=np.int32)
        first = rng.integers(0, V, size=(B, 1), dtype=np.int32)
        toks = np.empty((B, S), np.int32)
        toks[:, 0] = first[:, 0]
        structured = rng.random((B, S)) < self.structure
        for t in range(1, S):
            pred = (toks[:, t - 1] * 31 + 7) % V
            toks[:, t] = np.where(structured[:, t], pred, noise[:, t])
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = toks[:, 0]
        return {"tokens": toks, "labels": labels}


class PackedFileDataset:
    """Memory-mapped token stream packed into (seq_len+1)-sized rows."""

    def __init__(self, path: str, vocab: int, seq_len: int,
                 global_batch: int, dtype=np.uint16):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.rows = (len(self.tokens) - 1) // seq_len

    def batch_at(self, step: int, host_id: int = 0,
                 n_hosts: int = 1) -> dict:
        per_host = self.global_batch // n_hosts
        start_row = (step * self.global_batch + host_id * per_host)
        S = self.seq_len
        toks = np.empty((per_host, S), np.int32)
        labels = np.empty((per_host, S), np.int32)
        for i in range(per_host):
            r = (start_row + i) % self.rows
            seg = np.asarray(self.tokens[r * S: r * S + S + 1], np.int32)
            toks[i] = seg[:-1] % self.vocab
            labels[i] = seg[1:] % self.vocab
        return {"tokens": toks, "labels": labels}


class Prefetcher:
    """Background thread producing batches ahead of the training loop."""

    def __init__(self, source, start_step: int = 0, depth: int = 2,
                 host_id: int = 0, n_hosts: int = 1):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._host = host_id
        self._n_hosts = n_hosts
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step, self._host, self._n_hosts)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)


def make_batches(source, device=None):
    """Generator of (step, batch) with the batch's arrays as tensors on
    ``device`` (numpy arrays when ``device`` is None; single-host path)."""
    step = 0
    while True:
        batch = source.batch_at(step)
        if device is not None:
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in batch.items()}
        yield step, batch
        step += 1
