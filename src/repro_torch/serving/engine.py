"""Batched serving engine over compiled Programs (counterpart of
``repro/serving/engine.py``).

A ``CNNConfig`` makes the engine stateless: each tick batches up to
``slots`` queued image requests, pads a short batch to the compiled
batch, executes the compiled ``core/program.py::Program`` once through
``runtime/executor.py``, and retires every request with its argmax
class id.

An ``ArchConfig`` of a family with a Program lowering (dense, MoE,
hybrid, ssm, audio) is served statefully: the engine compiles the
(prefill, decode) Program pair
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
(``ModelApi.encode_memory``) and copies its cross K/V rows into the
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

With a tuned cache active (``core/autotune.activate``) the compile
entry points give the engine the tuned Program (or pair); it needs no
argument of its own for that.

Every Program run goes through the executor's graphed runners
(``graphed_runner``, ``graphed_prefill_runner``,
``graphed_decode_runner``, ``graphed_chunk_runner``), the counterparts
of the reference's jitted runners: on the card a run's first call of
each shape runs eagerly, the second is captured into a CUDA graph, and
later calls replay it.  Host work stays between calls: admission,
``PagePool`` decisions, page-table syncs, COW copies and sampling, each
call's logits read before the next call.  ``capture_seconds`` sums the
time spent capturing.

``spec_k`` turns on greedy speculative decode: a draft (prefill,
decode) pair (``models/transformer.py::compile_draft_pair``; the target
itself unless ``draft_cfg`` / ``draft_params`` name another model, with
its own ``ProgramState`` and graphs either way) proposes up to k tokens
a slot in k batched draft ticks; the target verifies every live slot's
burst in one chunk call over the whole ``(B, max_len)`` token buffer
(one graph per width B), accepts the longest agreeing prefix, emits the
correcting token, and rolls back by copying the truncated lengths into
both states' ``lengths`` tensors in place (the captured graphs read
those addresses).  Greedy output equals speculation off
(``n_spec_proposed`` / ``n_spec_accepted`` / ``n_spec_rollbacks`` count
the bursts).

Every engine reports through one ``obs.Observability`` bundle: the
``n_*`` counters live on its ``MetricsRegistry`` (the attributes read
through), each tick's wallclock and TTFT / inter-token latency land in
fixed-bucket histograms (``tick_ms``, ``ttft_ms``, ``itl_ms``), and a
flight recorder, when attached, receives every request's lifecycle
(enqueue, admission ticket, prefill chunks, tokens, spec bursts, COW
forks, release) and one snapshot a tick; ``obs.replay_summary`` rebuilds
the token streams from it.  ``sample_ops_every=N`` times one decode
tick in N op by op (``executor.OpTimingSampler``) on a copy of the
state.  The default bundle records counters and histograms only.

A config with no Program lowering (the vlm, llama-3.2-vision: its gated
cross-attention has no graph) falls back to the reference's legacy
decode loop, warning once at construction (``RuntimeWarning``) with the
lowering's full blocker list, which ``fallback_reason`` keeps (a
``fallback`` flight event and a ``serving_fallback{fallback_reason}``
gauge record it too).  It falls back only when the config itself has
no lowering (``LoweringBlocked``): an option that the lowering refuses
raises, and so does ``paged``, ``kv_quant``, ``chunk_size`` or
``spec_k`` on the legacy loop.  ``use_program=False`` picks that loop for any LM
(the reference's default; the port's is the Program path).  The loop
keeps the family's legacy cache (``ModelApi.init_cache``) for all
slots: admission zeroes the admitted slots and teacher-forces their
prompts together, one token a tick, each step's cache updates kept for
the admitted slots only (``_step_masked``); then each tick runs one
``decode_step`` over every slot, eagerly, through the decode-attention
kernel on the card.  As in the reference, the loop never writes a vlm's
cross memory (``init_cache`` zeroes it; ``Request.extra`` is not read
there), and it takes no chunked prefill or speculation.
``on_program_path`` says which path serves.

The engine runs on the card unless the caller passes ``device="cpu"``
(then every op runs its plain PyTorch version, eagerly); with no card
and no device named it raises.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from ..configs.base import ArchConfig, CNNConfig
from ..core.regions import state_specs
from ..kernels.common import resolve_device
from ..models import get_model
from ..models.cnn import compile_program
from ..models.transformer import (LoweringBlocked, compile_draft_pair,
                                  compile_program_pair)
from ..obs import Observability
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
                 chunk_size: int | None = None, spec_k: int = 0,
                 draft_cfg=None, draft_params=None,
                 obs: Observability | None = None, use_program: bool = True):
        if not isinstance(cfg, (ArchConfig, CNNConfig)):
            raise TypeError(f"cannot serve {type(cfg).__name__}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self.slots = slots
        self.impl = impl
        # One metrics plane and flight recorder per engine; the default
        # bundle is counters and histograms only.
        self.obs = obs if obs is not None else Observability()
        self._init_metrics()
        self.tick_no = 0
        self._op_sampler = None
        self.spec_k = spec_k
        self._spec = False
        self.live: dict[int, Request] = {}           # slot -> request
        self._pool = None
        self._prefilling: dict[int, _InFlightPrefill] = {}
        self._lm_program = False
        # Why an LM config fell back to the legacy decode loop (None: no
        # fallback); ``serve --program`` reads it.
        self.fallback_reason: str | None = None
        if isinstance(cfg, CNNConfig):
            if chunk_size is not None or spec_k:
                raise ValueError(
                    "chunked prefill / speculative decode need the "
                    f"stateful LM Program path, not {cfg.name}")
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
        if program is not None:
            _check_geometry(program, cfg, slots, max_len)
        elif use_program:
            try:
                program = compile_program_pair(
                    cfg, slots=slots, max_len=max_len, paged=paged,
                    page_size=page_size, page_pool=page_pool,
                    kv_quant=kv_quant)
            except LoweringBlocked as e:
                # Once per engine, never per tick; the flight event and
                # the gauge are the warning's structured twins.
                self.fallback_reason = str(e)
                self.obs.flight.event("fallback", reason=str(e))
                self.obs.registry.gauge(
                    "serving_fallback",
                    help="1 when the engine fell back to the legacy "
                         "decode loop, labeled by blocker",
                    fallback_reason=str(e)).set(1)
                warnings.warn(
                    f"no decode-Program lowering for {cfg.name} — {e}; "
                    f"serving through the legacy decode loop",
                    RuntimeWarning, stacklevel=2)
        if program is None:
            self._init_legacy(chunk_size, spec_k, paged, kv_quant)
            return
        self._lm_program = True
        self.program = program
        self.state = executor.init_program_state(program, self.device)
        # Families whose decode Program reads read-only persistent memory
        # (audio: encoder cross K/V) fill it once per admission.
        api = get_model(cfg)
        self._memory_input, self._memory_writer = (api.extra_input,
                                                   api.encode_memory)
        self._prefill = executor.graphed_prefill_runner(program.prefill,
                                                        impl=impl)
        self._decode = executor.graphed_decode_runner(program.decode,
                                                      impl=impl)
        # admission_* metrics land on the engine's registry.
        self.admission = AdmissionQueue(queue_capacity,
                                        registry=self.obs.registry)
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
        # The chunk runner also carries the speculative verify.
        self._chunk = (executor.graphed_chunk_runner(program.prefill,
                                                     impl=impl)
                       if chunk_size is not None or spec_k else None)
        self._init_spec(program, draft_cfg, draft_params)
        if self.obs.sample_ops_every:
            self._op_sampler = executor.OpTimingSampler(
                self.obs.sample_ops_every, registry=self.obs.registry,
                flight=self.obs.flight, impl=impl)

    def _init_legacy(self, chunk_size, spec_k, paged, kv_quant) -> None:
        """The legacy decode loop: the family's legacy cache for every
        slot, a FIFO queue, one eager ``decode_step`` a tick.  An option
        only the Program path has is refused, never dropped."""
        if chunk_size is not None or spec_k or paged or kv_quant is not None:
            raise ValueError(
                "chunked prefill / speculative decode / paged KV need the "
                "stateful LM Program path (use_program=True on a lowerable "
                "dense config); blocked by: "
                f"{self.fallback_reason or self.cfg.name}")
        self.chunk_size = None
        self.program = None
        self.queue = []
        self.api = get_model(self.cfg)
        self.cache = self.api.init_cache(self.cfg, self.slots, self.max_len,
                                         device=self.device)

    @property
    def on_program_path(self) -> bool:
        """True when LM tokens are served through the compiled (prefill,
        decode) Program pair; False on the legacy decode loop (with
        ``fallback_reason`` naming why, after a fallback) and for a
        CNN, as in the reference."""
        return self._lm_program

    def _init_metrics(self) -> None:
        """Register the engine's metric families on the bundle's
        registry; the ``n_*`` attributes read through to these
        counters."""
        m = self.obs.registry
        c, g, h = m.counter, m.gauge, m.histogram
        self._c_prefills = c("serving_prefills_total")
        self._c_prefill_recomputes = c("serving_prefill_recomputes_total")
        self._c_decode_ticks = c("serving_decode_ticks_total")
        # A live slot a tick failed to advance counts in starved_ticks.
        self._c_prefill_chunks = c("serving_prefill_chunks_total")
        self._c_starved = c("serving_starved_ticks_total")
        # Draft tokens proposed and accepted, and bursts accepted short
        # of their length (rollbacks).
        self._c_spec_proposed = c("serving_spec_proposed_total")
        self._c_spec_accepted = c("serving_spec_accepted_total")
        self._c_spec_rollbacks = c("serving_spec_rollbacks_total")
        self._c_shared_pages = c("serving_shared_pages_total")
        self._c_cow_forks = c("serving_cow_forks_total")
        self._c_requests = c("serving_requests_total",
                             help="requests submitted")
        self._c_finished = c("serving_requests_finished_total")
        self._c_tokens = c("serving_tokens_total",
                           help="generated tokens emitted")
        self._g_live = g("serving_live_slots")
        self._g_queue = g("serving_queue_depth")
        self._g_free_pages = g("serving_free_pages")
        self._h_tick = h("tick_ms", help="engine tick wallclock")
        self._h_ttft = h("ttft_ms", help="enqueue to first token")
        self._h_itl = h("itl_ms", help="inter-token latency")

    @property
    def n_prefills(self) -> int:
        return int(self._c_prefills.value)

    @property
    def n_prefill_recomputes(self) -> int:
        return int(self._c_prefill_recomputes.value)

    @property
    def n_decode_ticks(self) -> int:
        return int(self._c_decode_ticks.value)

    @property
    def n_prefill_chunks(self) -> int:
        return int(self._c_prefill_chunks.value)

    @property
    def n_starved_ticks(self) -> int:
        return int(self._c_starved.value)

    @property
    def n_spec_proposed(self) -> int:
        return int(self._c_spec_proposed.value)

    @property
    def n_spec_accepted(self) -> int:
        return int(self._c_spec_accepted.value)

    @property
    def n_spec_rollbacks(self) -> int:
        return int(self._c_spec_rollbacks.value)

    @property
    def n_shared_pages(self) -> int:
        return int(self._c_shared_pages.value)

    @property
    def n_cow_forks(self) -> int:
        return int(self._c_cow_forks.value)

    def _init_spec(self, pair, draft_cfg, draft_params) -> None:
        """Wire the speculative-decode draft: its (prefill, decode) pair
        at the target's geometry, its own ``ProgramState`` (so its own
        graphs, even when the pair is the target's), and its runners."""
        if not self.spec_k:
            return
        if self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self.spec_k}")
        if not self.greedy:
            raise ValueError(
                "speculative decode verifies greedy argmax proposals; "
                "sampling acceptance is out of scope (greedy=True)")
        if pair.paged is not None:
            raise NotImplementedError(
                "speculative decode over paged KV: the verify burst "
                "would need per-row page preparation (COW forks) "
                "inside the tick; serve paged configs without spec_k")
        if pair.caps is not None and not pair.caps.speculatable:
            raise NotImplementedError(
                f"speculative decode needs speculatable family state "
                f"({self.cfg.name} is family={self.cfg.family}): "
                f"rollback truncates lengths, which cannot rewind "
                f"recurrent or capacity-routed state")
        if draft_cfg is None:
            draft_cfg = self.cfg
            if draft_params is None:
                # Self-draft: every proposal verifies.
                draft_params = self.params
        if draft_params is None:
            raise ValueError(
                f"draft_cfg {draft_cfg.name} needs draft_params "
                f"(the draft is a separate model)")
        dpair = compile_draft_pair(self.cfg, draft_cfg, slots=self.slots,
                                   max_len=self.max_len)
        self._draft_params = _to_device(draft_params, self.device)
        self._draft_pair = dpair
        self._draft_state = executor.init_program_state(dpair, self.device)
        self._draft_prefill = executor.graphed_prefill_runner(
            dpair.prefill, impl=self.impl)
        self._draft_decode = executor.graphed_decode_runner(
            dpair.decode, impl=self.impl)
        self._spec = True

    @property
    def capture_seconds(self) -> float:
        """Seconds spent capturing CUDA graphs, summed over this
        engine's graphs, the draft's included (0 on the CPU and on the
        legacy loop, which runs eagerly)."""
        if self.program is None:
            return 0.0
        if not self._lm_program:
            return self._infer.store(self.params).capture_seconds
        secs = self.state.graphs.capture_seconds
        if self._spec:
            secs += self._draft_state.graphs.capture_seconds
        return secs

    def submit(self, req: Request) -> AdmissionTicket:
        """Enqueue a request.  LM requests on the Program path go through
        the bounded admission queue (rejected with ``queue_full`` at
        capacity); images and the legacy loop's requests are served FIFO
        by the next ticks.  Stamps the enqueue
        time (TTFT starts here) and records the lifecycle events."""
        req._enqueue_t = self.obs.clock()
        self._c_requests.inc()
        prompt_len = (len(req.prompt)
                      if getattr(req.prompt, "ndim", 1) == 1 else 0)
        self.obs.flight.event("enqueue", uid=req.uid, prompt_len=prompt_len)
        if self._lm_program:
            ticket = self.admission.submit(req)
        else:
            self.queue.append(req)
            ticket = AdmissionTicket(True, "queued", len(self.queue) - 1)
        self.obs.flight.event("admission", uid=req.uid,
                              accepted=ticket.accepted, reason=ticket.reason,
                              position=ticket.position)
        return ticket

    def step(self) -> list[Request]:
        """One engine tick; returns the requests it finished.  Every
        tick is timed onto ``tick_ms``, sets the live / queue / free-page
        gauges and records one ``tick`` flight event."""
        t0 = self.obs.clock()
        if self._lm_program:
            finished = self._lm_program_step()
        elif self.program is not None:
            finished = self._program_step()
        else:
            finished = self._legacy_step()
        dt_ms = (self.obs.clock() - t0) * 1e3
        self.tick_no += 1
        self._h_tick.observe(dt_ms)
        qd = len(self.admission) if self._lm_program else len(self.queue)
        free_pages = self._pool.free_pages if self._pool is not None else -1
        self._g_live.set(len(self.live))
        self._g_queue.set(qd)
        self._g_free_pages.set(free_pages)
        self.obs.flight.event(
            "tick", tick=self.tick_no, dt_ms=dt_ms, live=len(self.live),
            queue_depth=qd, free_pages=free_pages,
            starved=int(self._c_starved.value))
        return finished

    def dashboard_line(self) -> str:
        """One-line console dashboard, read off the same registry the
        artifacts serialize."""
        ttft, itl = self._h_ttft.percentile, self._h_itl.percentile
        return (f"tick {self.tick_no:>6} | live {len(self.live):>3} "
                f"| queue {int(self._g_queue.value):>3} "
                f"| toks {int(self._c_tokens.value):>7} "
                f"| ttft_p50 {ttft(50.0):8.1f}ms "
                f"| itl_p50 {itl(50.0):7.2f}ms "
                f"| starved {int(self._c_starved.value)}")

    def run_until_drained(self, max_ticks: int = 10_000) -> list[Request]:
        done = []
        for _ in range(max_ticks):
            pending = ((self.live or self.admission or self._prefilling)
                       if self._lm_program else self.live or self.queue)
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

    # -- LM: the legacy decode loop --------------------------------------------
    def _legacy_step(self) -> list[Request]:
        """Admit queued requests, then one ``decode_step`` over every
        slot; each live slot emits its next token."""
        self._admit()
        if not self.live:
            return []
        toks = np.zeros((self.slots,), np.int32)
        for slot, req in self.live.items():
            toks[slot] = req._last_token
        logits, self.cache = self._legacy_decode(toks)
        rows = logits.float().cpu().numpy()
        finished: list[Request] = []
        for slot, req in list(self.live.items()):
            self._emit_tokens(slot, req, [self._next_token(req, rows[slot])],
                              finished)
        return finished

    @torch.no_grad()
    def _legacy_decode(self, toks: np.ndarray):
        """One legacy ``decode_step`` over every slot: (logits, new
        cache); ``self.cache`` is left as it was."""
        return self.api.decode_step(self.params, self.cache,
                                    torch.from_numpy(toks).to(self.device),
                                    self.cfg, impl=self.impl)

    def _admit(self) -> None:
        """Move queued requests into free slots.  All of a tick's
        admissions are batched: one merge zeroes every admitted slot's
        cache, then the prompts are teacher-forced together -- at step t
        every admitted slot still inside its prompt advances, and one
        masked merge keeps exactly those slots' cache updates (the live
        slots' caches stay as they were).  The prompt's last token is
        the first one the next tick decodes."""
        admitted: list[tuple[int, Request]] = []
        for slot in self._free_slots():
            if not self.queue:
                break
            admitted.append((slot, self.queue.pop(0)))
        if not admitted:
            return
        self._reset_slots([slot for slot, _ in admitted])
        steps = max(len(req.prompt) - 1 for _, req in admitted)
        for t in range(steps):
            toks = np.zeros((self.slots,), np.int32)
            mask = np.zeros((self.slots,), bool)
            for slot, req in admitted:
                if t < len(req.prompt) - 1:
                    toks[slot] = int(req.prompt[t])
                    mask[slot] = True
            self._step_masked(toks, mask)
        for slot, req in admitted:
            req._last_token = int(req.prompt[-1])
            self.live[slot] = req

    @staticmethod
    def _batch_axis(leaf) -> int:
        """Legacy caches carry batch at axis 1 ((L, B, ...)); the shared
        ``pos`` vector is (B,)."""
        return 0 if leaf.ndim == 1 else 1

    def _reset_slots(self, slots: list[int]) -> None:
        """Zero the admitted slots' cache, one merge for all of them."""
        fresh = self.api.init_cache(self.cfg, 1, self.max_len,
                                    device=self.device)
        idx = torch.tensor(slots, device=self.device)

        def put(c, f):
            axis = self._batch_axis(c)
            shape = list(c.shape)
            shape[axis] = len(slots)
            return c.index_copy(axis, idx, f.to(c.dtype).expand(shape))
        self.cache = {k: put(c, fresh[k]) for k, c in self.cache.items()}

    def _step_masked(self, toks: np.ndarray, mask: np.ndarray):
        """One batched decode step keeping only the masked slots' cache
        updates (the other slots' caches stay as they were)."""
        old = self.cache
        logits, new = self._legacy_decode(toks)
        m = torch.from_numpy(mask).to(self.device)

        def merge(o, n):
            shape = [1] * o.ndim
            shape[self._batch_axis(o)] = self.slots
            return torch.where(m.reshape(shape), n, o)
        self.cache = {k: merge(old[k], new[k]) for k in old}
        return logits

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
                     finished: list) -> int:
        """Append generated tokens in order until EOS or the request's
        budget retires it (a retired paged slot gives its pages back);
        returns how many were kept -- a speculative burst past the
        budget is cut here, so its stream equals the one-token path's."""
        kept = 0
        flight = self.obs.flight
        for nxt in toks:
            now = self.obs.clock()
            first = not req.out_tokens
            req.out_tokens.append(nxt)
            req._last_token = nxt
            kept += 1
            self._c_tokens.inc()
            if first:
                ttft_ms = ((now - req._enqueue_t) * 1e3
                           if hasattr(req, "_enqueue_t") else 0.0)
                self._h_ttft.observe(ttft_ms)
                flight.event("first_token", uid=req.uid, slot=slot,
                             token=nxt, ttft_ms=ttft_ms)
            else:
                itl_ms = (now - req._last_emit_t) * 1e3
                self._h_itl.observe(itl_ms)
                flight.event("token", uid=req.uid, slot=slot, token=nxt,
                             itl_ms=itl_ms)
            req._last_emit_t = now
            eos = self.eos is not None and nxt == self.eos
            if eos or len(req.out_tokens) >= req.max_new_tokens:
                req.done = True
                finished.append(req)
                self.live.pop(slot, None)
                self._c_finished.inc()
                flight.event("release", uid=req.uid, slot=slot,
                             n_tokens=len(req.out_tokens),
                             reason="eos" if eos else "max_new_tokens")
                if self._pool is not None:
                    # Unref the slot's pages (a donor's shared prefix
                    # stays resident while a sharer holds it) and drop
                    # it from the donor registry.
                    self._pool.release(slot)
                    self._slot_prompts.pop(slot, None)
                    self._slot_len.pop(slot, None)
                break
        return kept

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
        flight = self.obs.flight
        while self.admission:
            free = self._free_slots()
            if not free:
                self.admission.note_blocked(NO_FREE_SLOT)
                flight.event("admission", accepted=False,
                             reason=NO_FREE_SLOT)
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
                    flight.event("admission", accepted=False,
                                 reason=PAGES_EXHAUSTED, uid=req.uid)
                    break
            flight.event("prefill_start", uid=req.uid, slot=slot,
                         length=len(win), write_from=write_from)
            if self._memory_writer is not None:
                self._write_encoder_memory(slot, req)
            padded = np.zeros((self.max_len,), np.int32)
            padded[:len(win)] = win
            if self.chunk_size is not None:
                # A wholly page-shared prompt still owes the chunk that
                # computes its last row's logits (the write is
                # redirected, the first token is not).
                self._prefilling[slot] = _InFlightPrefill(
                    req=req, tokens=padded, length=len(win),
                    done=min(write_from, len(win) - 1),
                    write_from=write_from,
                    admitted_tick=self.n_decode_ticks)
                continue
            logits = self._prefill(self.params,
                                   torch.from_numpy(padded[None]),
                                   self.state, slot, len(win), write_from)
            self._finish_prefill(
                slot, req, padded, len(win),
                logits[0, len(win) - 1].float().cpu().numpy(), finished)

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
        self._c_shared_pages.inc(len(shared))
        self._slot_prompts[slot] = prompt
        self._slot_len[slot] = len(prompt)
        executor.sync_page_table(self.state, self.program, pool)
        return write_from

    def _finish_prefill(self, slot: int, req: Request, padded: np.ndarray,
                        length: int, last_logits: np.ndarray,
                        finished: list) -> None:
        """Accounting, liveness, the draft's prefill of the same prompt
        when speculation is on (its cache must hold the same history
        before it proposes), and the first generated token.  A second
        prefill of one request would count in ``n_prefill_recomputes``."""
        if getattr(req, "_prefilled", False):
            self._c_prefill_recomputes.inc()
        req._prefilled = True
        self._c_prefills.inc()
        self.live[slot] = req
        if self._spec:
            self._draft_prefill(self._draft_params,
                                torch.from_numpy(padded[None]),
                                self._draft_state, slot, length, 0)
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
        self._c_prefill_chunks.inc(len(items))
        for i, (slot, p) in enumerate(items):
            self.obs.flight.event("prefill_chunk", uid=p.req.uid, slot=slot,
                                  start=int(starts[i]), stop=int(stops[i]))
            p.done = int(stops[i])
            if p.done < p.length:
                continue
            del self._prefilling[slot]
            self._finish_prefill(
                slot, p.req, p.tokens, p.length,
                logits[i, p.length - 1].float().cpu().numpy(), finished)

    def _prepare_pages(self) -> None:
        """Make each live slot's write page real and private before the
        tick: allocate on demand past the prompt, COW-fork a shared page
        (a device page copy), then push the decided table."""
        copies = []
        for slot in self.live:
            c = self._pool.prepare_decode(slot, self._slot_len[slot])
            if c is not None:
                copies.append(c)
                self.obs.flight.event("cow_fork", slot=slot,
                                      src_page=int(c[0]),
                                      dst_page=int(c[1]))
        executor.sync_page_table(self.state, self.program, self._pool)
        executor.apply_page_copies(self.state, self.program, copies)
        self._c_cow_forks.inc(len(copies))

    def _lm_program_step(self) -> list[Request]:
        """Admit queued requests (whole prefill, or one chunk per tick),
        then advance every live slot through the decode Program -- one
        token, or a verified speculative burst; the state's buffers
        update in place.  Decode-first fairness: a slot live at the
        tick's start always advances this tick (``n_starved_ticks``
        counts violations)."""
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
        if self._spec:
            advanced = self._spec_tick(toks, finished)
        else:
            self._sample_ops(self.program.decode, self.params, toks,
                             self.state, occupied, "target")
            # The occupancy mask keeps dead slots inert inside
            # run_decode: no length advance, no cache-row write.
            logits = self._decode(self.params, torch.from_numpy(toks),
                                  self.state, torch.from_numpy(occupied))
            if self._pool is not None:
                for slot in self.live:
                    self._slot_len[slot] += 1
            rows = logits.float().cpu().numpy()
            advanced = set()
            for slot, req in list(self.live.items()):
                self._emit_tokens(slot, req,
                                  [self._next_token(req, rows[slot])],
                                  finished)
                advanced.add(slot)
        self._c_decode_ticks.inc()
        self._c_starved.inc(len(starved - advanced))
        return finished

    def _sample_ops(self, program, params, toks, state, mask,
                    role: str) -> None:
        """Count one tick on the op sampler, which on its sampled ticks
        times ``program``'s ops on a copy of ``state``; called just
        before that Program's call, so the walk times what the tick
        runs: the target's decode on a plain tick, the first draft
        round on a speculative one (the reference samples plain ticks
        only)."""
        if self._op_sampler is not None:
            self._op_sampler.tick(
                program, params, torch.from_numpy(toks).to(self.device),
                state=state, mask=torch.from_numpy(mask).to(self.device),
                role=role)

    def _spec_tick(self, toks: np.ndarray, finished: list) -> set:
        """One speculative tick: the draft decode proposes up to
        ``spec_k`` tokens per live slot (k batched draft ticks), then
        the target verifies every burst in one chunk call -- rows ``[n,
        n + k_s]`` of each slot, greedy accept / rollback:

        * slot ``s`` feeds ``[x0, d_1..d_k]``; target row ``n + j``
          gives ``y_{j+1} = argmax``, what sequential decode would give
          after that prefix (the verify writes the rows' K/V itself);
        * accept the longest prefix with ``d_j == y_j`` (``a`` tokens),
          emit ``y_1..y_{a+1}`` (the first mismatch is corrected);
        * roll back by copying the lengths ``n + kept`` into both
          states' ``lengths`` tensors in place; rows past them are not
          attended and the next write overwrites the first stale one.

        A slot whose position reached ``max_len`` (its ring wrapped)
        takes a plain decode step instead: the verify is row-addressed.
        Returns the set of slots that advanced (every live one)."""
        lens = self.state.lengths.cpu().numpy()
        all_live = sorted(self.live)
        live_slots = [s for s in all_live if int(lens[s]) < self.max_len]
        wrapped = [s for s in all_live if int(lens[s]) >= self.max_len]
        advanced = set()
        if wrapped:
            wmask = np.zeros((self.slots,), bool)
            wmask[wrapped] = True
            wrows = self._decode(self.params, torch.from_numpy(toks),
                                 self.state, torch.from_numpy(wmask)
                                 ).float().cpu().numpy()
            for s in wrapped:
                req = self.live[s]
                self._emit_tokens(s, req, [self._next_token(req, wrows[s])],
                                  finished)
                advanced.add(s)
        if not live_slots:
            return advanced
        # The verify writes rows [n, n + k_s]: a slot at the boundary
        # takes k_s = 0, a plain (verified) single-token step.
        k_s = {s: max(0, min(self.spec_k, self.max_len - 1 - int(lens[s])))
               for s in live_slots}
        max_k = max(k_s.values())
        # Draft round i feeds the previous proposal and advances only
        # the slots still inside their burst.
        proposals = {s: [] for s in live_slots}
        cur = toks.copy()
        for i in range(max_k):
            dmask = np.zeros((self.slots,), bool)
            for s in live_slots:
                dmask[s] = i < k_s[s]
            if i == 0:
                self._sample_ops(self._draft_pair.decode,
                                 self._draft_params, cur, self._draft_state,
                                 dmask, "draft")
            drows = self._draft_decode(
                self._draft_params, torch.from_numpy(cur),
                self._draft_state, torch.from_numpy(dmask)
            ).float().cpu().numpy()
            for s in live_slots:
                if i < k_s[s]:
                    d = int(np.argmax(drows[s]))
                    proposals[s].append(d)
                    cur[s] = d
        # The target's verify: one chunk call over the live slots' whole
        # token buffers; length pinned past stop, so no final-chunk tail
        # write fires.
        B = len(live_slots)
        vtoks = np.zeros((B, self.max_len), np.int32)
        starts = np.array([lens[s] for s in live_slots], np.int32)
        stops = starts + np.array([k_s[s] + 1 for s in live_slots], np.int32)
        for i, s in enumerate(live_slots):
            n = int(starts[i])
            vtoks[i, n] = toks[s]
            vtoks[i, n + 1:n + 1 + len(proposals[s])] = proposals[s]
        vlogits = self._chunk(
            self.params, torch.from_numpy(vtoks), self.state, live_slots,
            starts, stops, np.full((B,), self.max_len + 1, np.int32),
            np.zeros((B,), np.int32))
        # Only rows [n, n + k_s] leave the device.
        rows = torch.from_numpy(starts[:, None] + np.arange(max_k + 1))
        rows = rows.clamp(max=self.max_len - 1).to(vlogits.device).long()
        batch = torch.arange(B, device=vlogits.device)[:, None]
        vrows = vlogits[batch, rows].float().cpu().numpy()
        new_lens = self.state.lengths.cpu().numpy().copy()
        for i, s in enumerate(live_slots):
            req = self.live[s]
            y = [int(np.argmax(vrows[i, j])) for j in range(k_s[s] + 1)]
            a = 0
            while a < k_s[s] and proposals[s][a] == y[a]:
                a += 1
            self._c_spec_proposed.inc(k_s[s])
            self._c_spec_accepted.inc(a)
            if a < k_s[s]:
                self._c_spec_rollbacks.inc()
            self.obs.flight.event("spec", slot=s, uid=req.uid,
                                  proposed=k_s[s], accepted=a,
                                  rollback=a < k_s[s])
            new_lens[s] = int(starts[i]) + self._emit_tokens(
                s, req, y[:a + 1], finished)
            advanced.add(s)
        # In place: the captured graphs of both states read these
        # (separate) tensors at their addresses.
        new_lens = torch.from_numpy(new_lens)
        self.state.lengths.copy_(new_lens)
        self._draft_state.lengths.copy_(new_lens)
        return advanced


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
