"""Batched serving engine over compiled Programs (counterpart of
``repro/serving/engine.py``).

A ``CNNConfig`` makes the engine stateless: each tick batches up to
``slots`` queued image requests, pads a short batch to the compiled
batch, executes the compiled ``core/program.py::Program`` once through
``runtime/executor.py``, and retires every request with its argmax
class id.

An ``ArchConfig`` (an LM of the dense, MoE, hybrid, ssm or audio family)
is served statefully: the engine compiles the (prefill, decode) Program pair
(``models/transformer.py::compile_program_pair``) whose persistent
regions -- KV caches, or a recurrent family's named state -- are owned
by the §5.1 allocator, and keeps one
``runtime/executor.py::ProgramState`` across ticks.  Admission runs the
prefill Program once per request (the cache written at the admitted
slot, the first token read off the prompt's last position); every tick
then runs the decode Program, one token per live slot against the cache.
Nothing is prefilled twice (``n_prefill_recomputes`` stays 0).  Windowed
configs serve on the same path with window-sized regions and rolling
eviction.  A recurrent family's prefill restarts its slot's state from
zero and overwrites it, so a slot reused in the same tick carries
nothing over.  An audio (whisper) request carries its encoder input in
``Request.extra``: admission runs the encoder once
(``models.MEMORY_WRITERS``) and copies its cross K/V rows into the
pair's read-only memory regions at the slot, in place, before the
prefill Program's cross ops read them.  The paged plan and chunked prefill are gated by the
pair's ``caps`` (``chunk_blocker``), never by assuming KV-shaped
regions.  Requests enter through a bounded ``AdmissionQueue``.

``paged=True`` serves off the §5.1 paged plan: page pools and a page
table, with admission, copy-on-write prefix sharing and on-demand pages
decided host-side by an ``executor.PagePool`` between executor calls
(``n_shared_pages`` / ``n_cow_forks`` count them; ``kv_quant="int8"``
stores int8 pages).  A request the pool cannot hold waits at the head
of the queue (``pages_exhausted``).  ``chunk_size`` makes admission only
assign the slot; the prompt then prefills ``chunk_size`` rows per tick
in one batched chunk call shared by every in-flight
admission, bitwise-equal to a whole prefill, while live slots keep
decoding every tick (``n_starved_ticks`` stays 0).

Every Program run goes through the executor's graphed runners
(``graphed_runner``, ``graphed_prefill_runner``,
``graphed_decode_runner``, ``graphed_chunk_runner``), the counterparts
of the reference's jitted runners: on the card a run's first call of
each shape runs eagerly, the second is captured into a CUDA graph, and
later calls replay it.  Host work stays between calls: admission,
``PagePool`` decisions, page-table syncs, COW copies and sampling, each
call's logits read before the next call.  ``capture_seconds`` sums the
time spent capturing.

The engine runs on the card unless the caller passes ``device="cpu"``
(then every op runs its plain PyTorch version, eagerly); with no card
and no device named it raises.  Speculative decode (ROADMAP A.7) and the
``obs`` metrics plane (A.8) are not ported; asking for them raises.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..configs.base import ArchConfig, CNNConfig
from ..core.regions import state_specs
from ..kernels.common import resolve_device
from ..models import MEMORY_WRITERS
from ..models.cnn import compile_program
from ..models.transformer import compile_program_pair
from ..runtime import executor
from .admission import (NO_FREE_SLOT, PAGES_EXHAUSTED, AdmissionQueue,
                        AdmissionTicket)

__all__ = ["Request", "ServingEngine"]


@dataclass
class Request:
    uid: int
    prompt: np.ndarray               # (len,) int tokens, or (H, W, C) image
    max_new_tokens: int = 16
    out_tokens: list = field(default_factory=list)
    done: bool = False
    extra: np.ndarray | None = None  # the family's extra input (audio:
    #                                  (T_enc, D) stub encoder frames)


@dataclass
class _InFlightPrefill:
    """A chunked admission mid-prefill: the slot is reserved (neither
    free nor live) while ``done`` walks the prompt in ``chunk_size``
    steps; ``admitted_tick`` dates the slot assignment, so the
    completes-within-``ceil(length / chunk)``-ticks bound is checkable."""
    req: Request
    tokens: np.ndarray               # (max_len,) right-padded prompt window
    length: int                      # prompt rows to prefill
    done: int                        # rows already in the cache
    write_from: int                  # paged shared-prefix redirect
    admitted_tick: int


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
                 queue_capacity: int | None = None, program=None,
                 paged: bool = False, page_size: int = 16,
                 page_pool: int | None = None, kv_quant: str | None = None,
                 chunk_size: int | None = None, spec_k: int = 0, obs=None):
        for name, asked, item in (("spec_k", bool(spec_k), "A.7"),
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
            # The Program handed in (paper-faithful, another hardware
            # model) is the one served, as in the reference.
            self.queue: list[Request] = []
            self.n_ticks = 0
            self.program = (program if program is not None
                            else compile_program(cfg, batch=slots))
            self._infer = executor.graphed_runner(self.program, impl=impl)
            return
        self.max_len = max_len
        self.eos = eos_id
        self.greedy = greedy
        if program is None:
            program = compile_program_pair(cfg, slots=slots, max_len=max_len,
                                           paged=paged, page_size=page_size,
                                           page_pool=page_pool,
                                           kv_quant=kv_quant)
        else:
            _check_geometry(program, cfg, slots, max_len)
        self.program = program
        self.state = executor.init_program_state(program, self.device)
        # Families whose decode Program reads read-only persistent memory
        # (audio: encoder cross K/V) fill it once per admission.
        self._memory_input, self._memory_writer = MEMORY_WRITERS.get(
            cfg.family, (None, None))
        self._prefill = executor.graphed_prefill_runner(program.prefill,
                                                        impl=impl)
        self._decode = executor.graphed_decode_runner(program.decode,
                                                      impl=impl)
        self.admission = AdmissionQueue(queue_capacity)
        self.live: dict[int, Request] = {}           # slot -> request
        # Host-side page allocator of a paged pair: admission, on-demand
        # decode pages and COW forks are decided here between executor
        # calls; the device sees the synced table and page copies.
        self._pool = (executor.PagePool(program.paged, slots)
                      if program.paged is not None else None)
        self._slot_prompts: dict[int, tuple] = {}   # donor registry
        self._slot_len: dict[int, int] = {}         # host length mirror
        if chunk_size is not None:
            if chunk_size < 1:
                raise ValueError(f"chunk_size must be >= 1, got "
                                 f"{chunk_size}")
            if program.chunk_blocker is not None:
                raise ValueError(f"pair is not chunkable: "
                                 f"{program.chunk_blocker}")
        self.chunk_size = chunk_size
        self._chunk = (executor.graphed_chunk_runner(program.prefill,
                                                     impl=impl)
                       if chunk_size is not None else None)
        self._prefilling: dict[int, _InFlightPrefill] = {}
        self.n_prefills = 0
        self.n_prefill_recomputes = 0
        self.n_decode_ticks = 0
        self.n_prefill_chunks = 0
        self.n_starved_ticks = 0
        self.n_shared_pages = 0
        self.n_cow_forks = 0

    @property
    def lm(self) -> bool:
        return isinstance(self.cfg, ArchConfig)

    @property
    def capture_seconds(self) -> float:
        """Seconds spent capturing CUDA graphs, summed over this
        engine's graphs (0 on the CPU)."""
        if self.lm:
            return self.state.graphs.capture_seconds
        return self._infer.store(self.params).capture_seconds

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
            pending = ((self.live or self.admission or self._prefilling)
                       if self.lm else self.queue)
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
        return [s for s in range(self.slots)
                if s not in self.live and s not in self._prefilling]

    def _next_token(self, req: Request, logits_row: np.ndarray) -> int:
        if self.greedy:
            return int(np.argmax(logits_row))
        return int(np.random.default_rng(req.uid + len(req.out_tokens))
                   .choice(self.cfg.vocab, p=_softmax(logits_row)))

    def _emit_tokens(self, slot: int, req: Request, toks,
                     finished: list) -> None:
        """Append generated tokens in order until EOS or the request's
        budget retires it; a retired paged slot gives its pages back."""
        for nxt in toks:
            req.out_tokens.append(nxt)
            req._last_token = nxt
            if ((self.eos is not None and nxt == self.eos)
                    or len(req.out_tokens) >= req.max_new_tokens):
                req.done = True
                finished.append(req)
                self.live.pop(slot, None)
                if self._pool is not None:
                    # Unref the slot's pages (a donor's shared prefix
                    # stays resident while a sharer holds it) and drop
                    # it from the donor registry.
                    self._pool.release(slot)
                    self._slot_prompts.pop(slot, None)
                    self._slot_len.pop(slot, None)
                break

    def _lm_admit(self, finished: list) -> None:
        """Prefill queued prompts into free slots, once per request.
        Each admission runs the prefill Program over the right-padded
        prompt, writing the block K/V into the persistent regions at the
        slot, and emits the first token from the prompt's last position;
        with ``chunk_size`` it only assigns the slot and registers an
        ``_InFlightPrefill`` that ``_advance_prefills`` walks one chunk
        per tick.  Prompts longer than ``max_len`` keep their last
        ``max_len`` tokens.  A slot freed during the loop (a one-token
        budget) is reused at once.  A request the page pool cannot hold
        goes back to the head of the queue (``pages_exhausted``)."""
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
            write_from = 0
            if self._pool is not None:
                write_from = self._paged_admit(slot, win)
                if write_from is None:
                    self.admission.requeue_front(req, PAGES_EXHAUSTED)
                    break
            if self._memory_writer is not None:
                self._write_encoder_memory(slot, req)
            if self.chunk_size is not None:
                padded = np.zeros((self.max_len,), np.int32)
                padded[:len(win)] = win
                # A wholly page-shared prompt still owes the chunk that
                # computes its last row's logits (the write is
                # redirected, the first token is not).
                self._prefilling[slot] = _InFlightPrefill(
                    req=req, tokens=padded, length=len(win),
                    done=min(write_from, len(win) - 1),
                    write_from=write_from,
                    admitted_tick=self.n_decode_ticks)
                continue
            padded = np.zeros((1, self.max_len), np.int32)
            padded[0, :len(win)] = win
            logits = self._prefill(self.params, torch.from_numpy(padded),
                                   self.state, slot, len(win), write_from)
            self._finish_prefill(
                slot, req, logits[0, len(win) - 1].float().cpu().numpy(),
                finished)

    def _write_encoder_memory(self, slot: int, req: Request) -> None:
        """Run the family's admission-time memory writer (the whisper
        encoder and cross K/V projection) over the request's ``extra``
        input and copy the rows into the pair's read-only persistent
        regions at ``slot``, in place: the captured graphs read those
        buffers at their addresses, so they are written, never rebound.
        Runs before the prefill Program, once per admission."""
        if req.extra is None:
            raise ValueError(
                f"request {req.uid}: {self.cfg.family} serving needs "
                f"Request.extra ({self._memory_input}) to fill the "
                f"persistent encoder memory at admission")
        frames = torch.from_numpy(np.asarray(req.extra, np.float32)).to(
            self.device, self.cfg.tdtype)
        rows = self._memory_writer(self.params, frames, self.cfg,
                                   impl=self.impl)
        persistent = self.program.persistent
        for name, row in rows.items():
            self.state.caches[persistent[name]][slot].copy_(row)

    def _paged_admit(self, slot: int, win: np.ndarray) -> int | None:
        """Map an admitted prompt onto pool pages: refcount-share the
        pages of the live donor with the longest full-page common prompt
        prefix, allocate fresh pages for the rest, and sync the table.
        Returns ``write_from`` (the first prompt row the prefill writes)
        or None when the pool cannot hold the private pages.

        Donors whose ring wrapped past ``max_len`` are skipped (the
        rolling overwrite recycled their early pages), and so are donors
        still mid-chunked-prefill (their prefix pages are mapped but not
        yet written)."""
        pool = self._pool
        prompt = tuple(int(t) for t in win)
        shared: tuple[int, ...] = ()
        for s, donor in self._slot_prompts.items():
            if s in self._prefilling:
                continue
            if self._slot_len.get(s, 0) > pool.plan.cache_len:
                continue
            cand = pool.shared_prefix_pages(s, donor, prompt)
            if len(cand) > len(shared):
                shared = cand
        if not pool.can_admit(len(prompt), len(shared)):
            return None
        write_from = pool.admit(slot, len(prompt), shared)
        self.n_shared_pages += len(shared)
        self._slot_prompts[slot] = prompt
        self._slot_len[slot] = len(prompt)
        executor.sync_page_table(self.state, self.program, pool)
        return write_from

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

    def _advance_prefills(self, finished: list) -> None:
        """Advance every in-flight chunked prefill by one chunk in one
        batched chunk-runner call.  An admission that reaches
        its prompt length emits its first token and goes live, within
        ``ceil(length / chunk_size)`` ticks of its slot assignment."""
        if not self._prefilling:
            return
        items = sorted(self._prefilling.items())
        lengths = np.array([p.length for _, p in items], np.int32)
        starts = np.array([p.done for _, p in items], np.int32)
        stops = np.minimum(starts + self.chunk_size, lengths)
        logits = self._chunk(
            self.params, torch.from_numpy(np.stack([p.tokens for _, p in
                                                    items])),
            self.state, [s for s, _ in items], starts, stops, lengths,
            [p.write_from for _, p in items])
        self.n_prefill_chunks += len(items)
        for i, (slot, p) in enumerate(items):
            p.done = int(stops[i])
            if p.done < p.length:
                continue
            del self._prefilling[slot]
            self._finish_prefill(
                slot, p.req, logits[i, p.length - 1].float().cpu().numpy(),
                finished)

    def _prepare_pages(self) -> None:
        """Make each live slot's write page real and private before the
        tick: allocate on demand past the prompt, COW-fork a shared page
        (a device page copy), then push the decided table."""
        copies = []
        for slot in self.live:
            c = self._pool.prepare_decode(slot, self._slot_len[slot])
            if c is not None:
                copies.append(c)
        executor.sync_page_table(self.state, self.program, self._pool)
        executor.apply_page_copies(self.state, self.program, copies)
        self.n_cow_forks += len(copies)

    def _lm_program_step(self) -> list[Request]:
        """Admit queued requests (whole prefill, or one chunk per tick),
        then advance every live slot by one token through the decode
        Program; the state's buffers update in place.  Decode-first
        fairness: a slot live at the tick's start always advances this
        tick (``n_starved_ticks`` counts violations)."""
        finished: list[Request] = []
        self._lm_admit(finished)
        self._advance_prefills(finished)
        if not self.live:
            return finished
        starved = set(self.live)
        toks = np.zeros((self.slots,), np.int32)
        occupied = np.zeros((self.slots,), bool)
        for slot, req in self.live.items():
            toks[slot] = req._last_token
            occupied[slot] = True
        if self._pool is not None:
            self._prepare_pages()
        # The occupancy mask keeps dead slots inert inside run_decode: no
        # length advance, no cache-row write.
        logits = self._decode(self.params, torch.from_numpy(toks),
                              self.state, torch.from_numpy(occupied))
        if self._pool is not None:
            for slot in self.live:
                self._slot_len[slot] += 1
        rows = logits.float().cpu().numpy()
        advanced = set()
        for slot, req in list(self.live.items()):
            self._emit_tokens(slot, req, [self._next_token(req, rows[slot])],
                              finished)
            advanced.add(slot)
        self.n_decode_ticks += 1
        self.n_starved_ticks += len(starved - advanced)
        return finished


def _check_geometry(pair, cfg, slots: int, max_len: int) -> None:
    """Refuse a precompiled pair whose geometry is not the engine's, at
    construction rather than as a shape error mid-serve.  A paged pair
    keeps its slots in the page table and its extent in the plan; any
    other pair must hold the persistent regions the engine config's own
    family hook mints, name for name and shape for shape -- which also
    catches a pair compiled from another config (a windowed pair handed
    to a dense engine) whose slots and max_len happen to agree."""
    if pair.paged is not None:
        pt = next(s for s in pair.decode.plan.persistent_regions()
                  if s.name == "page_table")
        checks = [(pt.shape, (slots, pair.paged.pages_per_slot)),
                  ((pair.paged.cache_len,), (max_len,))]
    else:
        specs, _ = state_specs(cfg, slots, max_len)
        want = {s.name: s.shape for s in specs}
        got = {s.name: s.shape
               for s in pair.decode.plan.persistent_regions()}
        checks = [(got, want)]
    if pair.max_len is not None:
        checks.append(((pair.slots, pair.max_len), (slots, max_len)))
    for got, want in checks:
        if got != want:
            raise ValueError(f"ProgramPair compiled for slots/max_len "
                             f"{got}, engine configured for {want}")
