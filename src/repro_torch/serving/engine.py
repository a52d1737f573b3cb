"""Batched serving engine, CNN Program path (counterpart of
``repro/serving/engine.py``).

A ``CNNConfig`` makes the engine stateless: each tick batches up to ``slots`` queued image requests,
pads a short batch to the compiled batch, executes the compiled
``core/program.py::Program`` once through ``runtime/executor.py``, and
retires every request with its argmax class id — so the compiler's
schedule is what serves the traffic.

The engine runs on the card unless the caller passes ``device="cpu"``
(then every op runs its plain PyTorch version); with no card and no
device named it raises.  The stateful LM paths, the bounded
``AdmissionQueue`` and the ``obs`` metrics plane are not ported yet
(ROADMAP A.6, A.8).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..configs.base import CNNConfig
from ..kernels.common import resolve_device
from ..models.cnn import compile_program
from ..runtime.executor import cached_runner

__all__ = ["Request", "ServingEngine"]


@dataclass
class Request:
    uid: int
    prompt: np.ndarray               # (H, W, C) image
    out_tokens: list = field(default_factory=list)
    done: bool = False


def _to_device(tree: dict, device: torch.device) -> dict:
    return {k: _to_device(v, device) if isinstance(v, dict)
            else v.to(device) for k, v in tree.items()}


class ServingEngine:
    def __init__(self, cfg, params, *, slots: int = 8, impl: str = "auto",
                 device=None):
        if not isinstance(cfg, CNNConfig):
            raise NotImplementedError(
                f"{getattr(cfg, 'name', cfg)}: only CNN configs serve on "
                f"repro_torch so far (LM serving is ROADMAP A.6)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self.slots = slots
        self.impl = impl
        self.queue: list[Request] = []
        self.n_ticks = 0
        self.program = compile_program(cfg, batch=slots)
        self._infer = cached_runner(self.program, impl=impl)

    def submit(self, req: Request) -> None:
        """Enqueue an image request; the next ticks serve it FIFO."""
        self.queue.append(req)

    def step(self) -> list[Request]:
        """One tick on the program path: batch up to ``slots`` queued
        images, execute the compiled Program once, retire them all.
        ``out_tokens`` carries the argmax class id."""
        if not self.queue:
            return []
        batch, self.queue = self.queue[:self.slots], self.queue[self.slots:]
        images = np.stack([np.asarray(r.prompt) for r in batch])
        if len(batch) < self.slots:        # pad to the compiled batch
            pad = np.zeros((self.slots - len(batch),) + images.shape[1:],
                           images.dtype)
            images = np.concatenate([images, pad])
        x = torch.from_numpy(images).to(self.device, self.cfg.tdtype)
        classes = self._infer(self.params, x).argmax(dim=-1).tolist()
        for r, c in zip(batch, classes):
            r.out_tokens.append(int(c))
            r.done = True
        self.n_ticks += 1
        return batch

    def run_until_drained(self, max_ticks: int = 10_000) -> list[Request]:
        done = []
        for _ in range(max_ticks):
            if not self.queue:
                break
            done.extend(self.step())
        return done
