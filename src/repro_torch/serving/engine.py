"""Batched serving engine over compiled Programs (counterpart of
``repro/serving/engine.py``).

A ``CNNConfig`` makes the engine stateless: each tick batches up to
``slots`` queued image requests, pads a short batch to the compiled
batch, executes the compiled ``core/program.py::Program`` once through
``runtime/executor.py``, and retires every request with its argmax
class id.

An ``ArchConfig`` (dense LM) is served statefully: the engine compiles
the (prefill, decode) Program pair
(``models/transformer.py::compile_program_pair``) whose persistent
KV-cache regions are owned by the §5.1 allocator, and keeps one
``runtime/executor.py::ProgramState`` across ticks.  Admission runs the
prefill Program once per request (the cache written at the admitted
slot, the first token read off the prompt's last position); every tick
then runs the decode Program, one token per live slot against the
cache.  Nothing is prefilled twice (``n_prefill_recomputes`` stays 0).
Windowed configs serve on the same path with window-sized regions and
rolling eviction.  Requests enter through a bounded ``AdmissionQueue``.

The engine runs on the card unless the caller passes ``device="cpu"``
(then every op runs its plain PyTorch version); with no card and no
device named it raises.  Chunked prefill, speculative decode and the
paged plan (ROADMAP A.7) and the ``obs`` metrics plane (A.8) are not
ported; asking for them raises.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..configs.base import ArchConfig, CNNConfig
from ..kernels.common import resolve_device
from ..models.cnn import compile_program
from ..models.transformer import compile_program_pair
from ..runtime import executor
from .admission import NO_FREE_SLOT, AdmissionQueue, AdmissionTicket

__all__ = ["Request", "ServingEngine"]


@dataclass
class Request:
    uid: int
    prompt: np.ndarray               # (len,) int tokens, or (H, W, C) image
    max_new_tokens: int = 16
    out_tokens: list = field(default_factory=list)
    done: bool = False


def _to_device(tree: dict, device: torch.device) -> dict:
    return {k: _to_device(v, device) if isinstance(v, dict)
            else v.to(device) for k, v in tree.items()}


def _softmax(x):
    x = x - x.max()
    e = np.exp(x)
    return e / e.sum()


class ServingEngine:
    def __init__(self, cfg, params, *, slots: int = 8, max_len: int = 256,
                 eos_id: int | None = None, impl: str = "auto",
                 greedy: bool = True, device=None,
                 queue_capacity: int | None = None,
                 chunk_size: int | None = None, spec_k: int = 0,
                 paged: bool = False, obs=None):
        for name, asked, item in (("chunk_size", chunk_size is not None,
                                   "A.7"),
                                  ("spec_k", bool(spec_k), "A.7"),
                                  ("paged", paged, "A.7"),
                                  ("obs", obs is not None, "A.8")):
            if asked:
                raise NotImplementedError(
                    f"{name}: not ported to repro_torch yet (ROADMAP "
                    f"{item})")
        if not isinstance(cfg, (ArchConfig, CNNConfig)):
            raise TypeError(f"cannot serve {type(cfg).__name__}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self.slots = slots
        self.impl = impl
        if isinstance(cfg, CNNConfig):
            self.queue: list[Request] = []
            self.n_ticks = 0
            self.program = compile_program(cfg, batch=slots)
            self._infer = executor.cached_runner(self.program, impl=impl)
            return
        self.max_len = max_len
        self.eos = eos_id
        self.greedy = greedy
        self.program = compile_program_pair(cfg, slots=slots,
                                            max_len=max_len)
        self.state = executor.init_program_state(self.program, self.device)
        self.admission = AdmissionQueue(queue_capacity)
        self.live: dict[int, Request] = {}           # slot -> request
        self.n_prefills = 0
        self.n_prefill_recomputes = 0
        self.n_decode_ticks = 0

    @property
    def lm(self) -> bool:
        return isinstance(self.cfg, ArchConfig)

    def submit(self, req: Request) -> AdmissionTicket:
        """Enqueue a request.  LM requests go through the bounded
        admission queue (rejected with ``queue_full`` at capacity);
        images are served FIFO by the next ticks."""
        if self.lm:
            return self.admission.submit(req)
        self.queue.append(req)
        return AdmissionTicket(True, "queued", len(self.queue) - 1)

    def step(self) -> list[Request]:
        """One engine tick; returns the requests it finished."""
        if self.lm:
            return self._lm_program_step()
        return self._program_step()

    def run_until_drained(self, max_ticks: int = 10_000) -> list[Request]:
        done = []
        for _ in range(max_ticks):
            pending = (self.live or self.admission) if self.lm else self.queue
            if not pending:
                break
            done.extend(self.step())
        return done

    # -- CNN: one stateless Program per tick -------------------------------------
    def _program_step(self) -> list[Request]:
        """Batch up to ``slots`` queued images, execute the compiled
        Program once, retire them all; ``out_tokens`` carries the argmax
        class id."""
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

    # -- LM: the stateful (prefill, decode) pair ---------------------------------
    def _free_slots(self) -> list[int]:
        return [s for s in range(self.slots) if s not in self.live]

    def _next_token(self, req: Request, logits_row: np.ndarray) -> int:
        if self.greedy:
            return int(np.argmax(logits_row))
        return int(np.random.default_rng(req.uid + len(req.out_tokens))
                   .choice(self.cfg.vocab, p=_softmax(logits_row)))

    def _emit_tokens(self, slot: int, req: Request, toks,
                     finished: list) -> None:
        """Append generated tokens in order until EOS or the request's
        budget retires it."""
        for nxt in toks:
            req.out_tokens.append(nxt)
            req._last_token = nxt
            if ((self.eos is not None and nxt == self.eos)
                    or len(req.out_tokens) >= req.max_new_tokens):
                req.done = True
                finished.append(req)
                self.live.pop(slot, None)
                break

    def _lm_admit(self, finished: list) -> None:
        """Prefill queued prompts into free slots, once per request.
        Each admission runs the prefill Program over the right-padded
        prompt, writing the block K/V into the persistent regions at the
        slot, and emits the first token from the prompt's last position.
        Prompts longer than ``max_len`` keep their last ``max_len``
        tokens.  A slot freed during the loop (a one-token budget) is
        reused at once."""
        while self.admission:
            free = self._free_slots()
            if not free:
                self.admission.note_blocked(NO_FREE_SLOT)
                break
            req = self.admission.pop()
            if req is None:
                break
            if len(req.prompt) == 0:
                raise ValueError(f"request {req.uid}: empty prompt")
            slot = free[0]
            win = np.asarray(req.prompt, np.int32)[-self.max_len:]
            padded = np.zeros((1, self.max_len), np.int32)
            padded[0, :len(win)] = win
            logits = executor.run_prefill(
                self.program.prefill, self.params,
                torch.from_numpy(padded).to(self.device), self.state, slot,
                len(win), impl=self.impl)
            self._finish_prefill(
                slot, req, logits[0, len(win) - 1].float().cpu().numpy(),
                finished)

    def _finish_prefill(self, slot: int, req: Request,
                        last_logits: np.ndarray, finished: list) -> None:
        """Accounting, liveness and the first generated token.  A second
        prefill of one request would count in ``n_prefill_recomputes``."""
        if getattr(req, "_prefilled", False):
            self.n_prefill_recomputes += 1
        req._prefilled = True
        self.n_prefills += 1
        self.live[slot] = req
        self._emit_tokens(slot, req, [self._next_token(req, last_logits)],
                          finished)

    def _lm_program_step(self) -> list[Request]:
        """Prefill-admit queued requests, then advance every live slot by
        one token through the decode Program; the state's cache buffers
        update in place."""
        finished: list[Request] = []
        self._lm_admit(finished)
        if not self.live:
            return finished
        toks = np.zeros((self.slots,), np.int32)
        occupied = np.zeros((self.slots,), bool)
        for slot, req in self.live.items():
            toks[slot] = req._last_token
            occupied[slot] = True
        # The occupancy mask keeps dead slots inert inside run_decode: no
        # length advance, no cache-row write.
        logits = executor.run_decode(
            self.program.decode, self.params,
            torch.from_numpy(toks).to(self.device), self.state,
            torch.from_numpy(occupied).to(self.device), impl=self.impl)
        rows = logits.float().cpu().numpy()
        for slot, req in list(self.live.items()):
            self._emit_tokens(slot, req, [self._next_token(req, rows[slot])],
                              finished)
        self.n_decode_ticks += 1
        return finished
