"""Schedule autotuner — measure, calibrate, search, pin (stage 7).

Counterpart of ``repro/core/autotune.py``.  The analytic schedule
(core/schedule.py) picks tilings, loop order, strip storage and
attention blocks from traffic formulas alone.  This module closes the
paper's Table-1 loop in the other direction: trace the executor
(``runtime/executor.trace_program``), fit the cost model
(``core/cost.fit_cost_model``), enumerate each op's *feasible*
candidate set (the same sets the choosers search --
``enumerate_conv_tilings`` / ``enumerate_matmul_candidates`` /
``enumerate_attention_blocks``), rank by calibrated cost, measure the
top-k by replay (``runtime/replay.replay_record``), and pin the winner
in an on-disk **TunedCache** (the reference's JSON layout, so a cache
either package writes loads in the other).

On the card the trace and every replay read the device clock
(``executor.device_times``), never the host's: an eager op's host time
is its Python dispatch, which would rank the wrapper, not the kernel.
There, candidates whose CUDA launches are the same
(``replay.launch_key``, from each kernel's plan: any block on the
skinny matmul path, any ``block_kv`` of the decode kernel) are measured
once and share that time, so the min-of-repeats noise cannot pin a
"winner" among identical launches; the tie-break (lower modeled traffic,
then the incumbent) decides among them.  On the CPU every candidate is
measured, as in the reference.

The cache is keyed ``(config name, hw fingerprint, batch, op
signature)`` and consulted by ``compile_model`` *before* the analytic
choosers run (the models pass a ``TunedView``), so an unchanged model
compiles straight to the tuned Program with zero re-search and zero
replay measurements.  The fingerprint names the hardware model and the
device that measured (``hw_fingerprint``): a CPU measurement is never
served to a card run, nor a card's to a CPU run.
``TunedCache.generation()`` is a content hash of the entries; the
models' compile memos key on ``active_generation()``, so a re-tune
never serves a stale Program (and, since the graphed runners key on the
Program, never a stale CUDA graph).

Only candidates whose *modeled* traffic is at or below the
incumbent's are admitted: the tuned schedule's modeled cost is then
provably <= the untuned one, and measurement can only improve on it.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
from dataclasses import dataclass, field

import torch

from ..kernels.common import resolve_device
from .cost import CostModel, error_table, fit_cost_model, format_error_table
from .dataflow import conv_strip_traffic, enumerate_matmul_candidates
from .hw import SNOWFLAKE, TPU_V5E, HardwareModel
from .ir import (LayerKind, LayerNode, ModelGraph, _conv_out, kernel_kind,
                 pool_out)
from .tiling import (ConvTiling, conv_tiling_from, enumerate_attention_blocks,
                     enumerate_conv_tilings)

__all__ = ["hw_fingerprint", "op_signature", "kernel_kind", "TunedCache",
           "TunedView", "enumerate_candidates", "entry_to_replay_candidate",
           "tune_program", "tune_cnn", "tune_lm_decode", "TuneReport",
           "OpTuneResult", "activate", "deactivate", "active",
           "active_device", "active_generation", "tuned_context"]

TUNABLE = ("conv2d", "matmul", "flash_attention", "decode_attention")


def hw_fingerprint(hw: HardwareModel, device=None) -> str:
    """Identity of the machine a measurement is valid on: the hardware
    *model* parameters plus the device that runs the kernels (default:
    the card) -- torch's backend for it and, on the card, its name."""
    dev = resolve_device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    payload = {"hw": dataclasses.asdict(hw), "backend": dev.type,
               "device_kind": kind}
    blob = json.dumps(payload, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def op_signature(node: LayerNode) -> str:
    """Stable per-op key: kernel kind + full geometry + dtype width.
    Two nodes with the same signature are interchangeable workloads, so
    one tuned entry serves every occurrence (e.g. all L identical
    transformer blocks collapse to a handful of signatures)."""
    dims = ",".join(f"{k}={node.dims[k]}" for k in sorted(node.dims))
    return f"{kernel_kind(node)}[{dims}]dt{node.dtype_bytes}"


# --- the on-disk cache -------------------------------------------------------------
@dataclass
class TunedCache:
    """Persisted tuned schedules + fitted cost models.

    ``entries`` maps ``config|hw_fp|b<batch>|<op signature>`` to the
    winning decisions (plus measurement bookkeeping); ``cost_models``
    maps hw fingerprints to ``CostModel`` fits.  ``generation()`` is a
    content hash -- compile memos key on it, so mutating the cache
    invalidates memoized Programs.
    """
    path: str | None = None
    entries: dict = field(default_factory=dict)
    cost_models: dict = field(default_factory=dict)

    @staticmethod
    def key(config: str, hw_fp: str, batch: int, sig: str) -> str:
        return f"{config}|{hw_fp}|b{batch}|{sig}"

    def generation(self) -> str:
        if not self.entries and not self.cost_models:
            return "empty"
        blob = json.dumps({"entries": self.entries,
                           "cost_models": self.cost_models}, sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:12]

    def lookup(self, config: str, hw_fp: str, batch: int,
               sig: str) -> dict | None:
        return self.entries.get(self.key(config, hw_fp, batch, sig))

    def store(self, config: str, hw_fp: str, batch: int, sig: str,
              entry: dict) -> None:
        self.entries[self.key(config, hw_fp, batch, sig)] = entry

    def cost_model(self, hw_fp: str) -> CostModel | None:
        raw = self.cost_models.get(hw_fp)
        return CostModel.from_json(json.dumps(raw)) if raw else None

    def set_cost_model(self, hw_fp: str, model: CostModel) -> None:
        self.cost_models[hw_fp] = json.loads(model.to_json())

    def view(self, config: str, hw_fp: str, batch: int) -> "TunedView":
        return TunedView(self, config, hw_fp, batch)

    def save(self, path: str | None = None) -> None:
        path = path or self.path
        if path is None:
            raise ValueError("TunedCache has no path")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"version": 1, "entries": self.entries,
                       "cost_models": self.cost_models},
                      f, indent=2, sort_keys=True)
        self.path = path

    @classmethod
    def load(cls, path: str) -> "TunedCache":
        """Missing file => empty cache bound to the path (first tune
        creates it)."""
        if not os.path.exists(path):
            return cls(path=path)
        with open(path) as f:
            raw = json.load(f)
        return cls(path=path, entries=raw.get("entries", {}),
                   cost_models=raw.get("cost_models", {}))


@dataclass(frozen=True)
class TunedView:
    """What ``compile_model`` sees: node -> tuned decisions (or None).
    Duck-typed on purpose -- core/schedule.py never imports this module,
    so the schedule emitter stays import-cycle-free."""
    cache: TunedCache
    config: str
    hw_fp: str
    batch: int

    def lookup(self, node: LayerNode) -> dict | None:
        return self.cache.lookup(self.config, self.hw_fp, self.batch,
                                 op_signature(node))


# --- the process-wide active cache -------------------------------------------------
_ACTIVE: tuple[TunedCache, torch.device] | None = None


def activate(cache: TunedCache, device=None) -> None:
    """Make ``cache`` the cache every ``compile_program`` consults, for
    Programs that run on ``device`` (default: the card): its entries are
    read under that device's fingerprint."""
    global _ACTIVE
    _ACTIVE = (cache, resolve_device(device))


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> TunedCache | None:
    return _ACTIVE[0] if _ACTIVE is not None else None


def active_device() -> torch.device | None:
    """The device the active cache serves (None when none is active)."""
    return _ACTIVE[1] if _ACTIVE is not None else None


def active_generation() -> str:
    """Content hash of the active cache and the device it serves -- the
    compile memos' key component: re-tuning changes it, which
    invalidates every memoized Program."""
    if _ACTIVE is None:
        return "none"
    return f"{_ACTIVE[0].generation()}@{_ACTIVE[1]}"


def tuned_context(config: str, batch: int, hw: HardwareModel):
    """(TunedView, CostModel | None) of the active cache for Programs of
    ``config`` at ``batch`` under ``hw``, or (None, None) when no cache
    (or an empty one) is active -- what the compile entry points thread
    into ``compile_model``."""
    cache = active()
    if cache is None or cache.generation() == "empty":
        return None, None
    fp = hw_fingerprint(hw, active_device())
    return cache.view(config, fp, batch), cache.cost_model(fp)


# --- candidate enumeration ---------------------------------------------------------
def _conv_candidate_traffic(node: LayerNode, ct: ConvTiling,
                            order: str) -> float:
    """Modeled HBM bytes of one conv candidate -- *identical* accounting
    to ``core/schedule._schedule_conv`` (fused-pool output shrink on the
    zero-copy path included), so the tuner's no-regression filter and
    the compiled schedule's traffic can never disagree."""
    d = node.dims
    ob = node.operand_bytes()
    fp = node.meta.get("fused_pool") if ct.strip_storage == "virtual" else None
    if fp:
        oh = pool_out(_conv_out(d["H"], d["kh"], d["stride"], d["pad"]),
                      fp["window"], fp["stride"], fp.get("pad", 0))
        ow = pool_out(_conv_out(d["W"], d["kw"], d["stride"], d["pad"]),
                      fp["window"], fp["stride"], fp.get("pad", 0))
        ob["out"] = d.get("batch", 1) * oh * ow * d["C_out"] * node.dtype_bytes
    kloop, mloop = conv_strip_traffic(
        ob["maps"], ob["weights"], ob["out"], n_map_tiles=ct.n_map_tiles,
        n_kernel_tiles=ct.n_kernel_tiles, overlap_frac=ct.overlap_frac,
        strip_storage=ct.strip_storage)
    return kloop if order == "kloop" else mloop


def enumerate_candidates(node: LayerNode, hw: HardwareModel, *,
                         paper_faithful: bool = False) -> list[dict]:
    """Every feasible schedule for one tunable node, with its modeled
    traffic -- the tuner's search space.  Decisions are JSON-plain (the
    cache stores them verbatim); ``entry_to_replay_candidate`` turns one
    into the replay harness's substitution dict."""
    d = node.dims
    out: list[dict] = []
    if node.kind is LayerKind.CONV2D:
        for ct in enumerate_conv_tilings(
                d["H"], d["W"], d["C_in"], d["C_out"], d["kh"], d["kw"],
                d["stride"], d["pad"], node.dtype_bytes, hw,
                batch=d.get("batch", 1)):
            if paper_faithful and ct.strip_storage != "materialized":
                continue
            for order in ("kloop", "mloop"):
                out.append({
                    "kind": "conv2d", "out_rows": ct.out_rows,
                    "kernels_per_tile": ct.kernels_per_tile,
                    "strip_storage": ct.strip_storage, "dataflow": order,
                    "modeled_traffic": _conv_candidate_traffic(
                        node, ct, order)})
    elif node.kind is LayerKind.MATMUL:
        for df, t, traffic in enumerate_matmul_candidates(
                d["M"], d["K"], d["N"], node.dtype_bytes, hw,
                allow_output_stationary=not paper_faithful):
            out.append({"kind": "matmul", "dataflow": df.value,
                        "block": [t.bm, t.bk, t.bn],
                        "modeled_traffic": traffic})
    elif node.kind is LayerKind.ATTENTION:
        kind = kernel_kind(node)
        traffic = node.min_bytes()   # blocks move where, not how many
        for bq, bkv in enumerate_attention_blocks(
                d["seq_q"], d["seq_kv"], d["head_dim"], node.dtype_bytes,
                hw, window=node.meta.get("window")):
            out.append({"kind": kind, "block_q": bq, "block_kv": bkv,
                        "modeled_traffic": traffic})
    return out


def entry_to_replay_candidate(node: LayerNode, entry: dict,
                              hw: HardwareModel) -> dict:
    """Tuned-entry decisions -> the substitution dict
    ``runtime/replay.op_from_record`` understands.  Conv entries are
    re-validated through ``conv_tiling_from`` (raises ValueError on an
    infeasible or stale entry)."""
    if entry["kind"] == "conv2d":
        d = node.dims
        ct = conv_tiling_from(
            d["H"], d["W"], d["C_in"], d["C_out"], d["kh"], d["kw"],
            d["stride"], d["pad"], node.dtype_bytes, hw,
            out_rows=entry["out_rows"],
            kernels_per_tile=entry["kernels_per_tile"],
            strip_storage=entry["strip_storage"],
            batch=d.get("batch", 1))
        return {"conv_tiling": ct, "dataflow": entry["dataflow"]}
    if entry["kind"] == "matmul":
        return {"dataflow": entry["dataflow"],
                "block": tuple(entry["block"])}
    if entry["kind"] == "flash_attention":
        return {"block_q": entry["block_q"], "block_kv": entry["block_kv"]}
    return {"block_kv": entry["block_kv"]}        # decode_attention


def _incumbent_decisions(rec) -> dict:
    """The traced op's own schedule, as a candidate-shaped dict."""
    s = rec.schedule
    if rec.kind == "conv2d":
        ct = s["conv_tiling"]
        return {"kind": "conv2d", "out_rows": ct["out_rows"],
                "kernels_per_tile": ct["kernels_per_tile"],
                "strip_storage": s.get("strip_storage")
                or ct.get("strip_storage", "materialized"),
                "dataflow": s["dataflow"]}
    if rec.kind == "matmul":
        return {"kind": "matmul", "dataflow": s["dataflow"],
                "block": list(s["block"])}
    a = s["attn"]
    if rec.kind == "flash_attention":
        return {"kind": "flash_attention", "block_q": a["block_q"],
                "block_kv": a["block_kv"]}
    return {"kind": "decode_attention", "block_kv": a["block_kv"]}


def _same_decisions(a: dict, b: dict) -> bool:
    keys = set(a) | set(b)
    keys -= {"modeled_traffic", "measured_time_s", "incumbent_time_s",
             "sig", "measured"}
    return all(a.get(k) == b.get(k) for k in keys)


def decisions(entry: dict) -> str:
    """One entry's schedule decisions, as a short line."""
    if entry["kind"] == "conv2d":
        return (f"{entry['strip_storage']} out_rows={entry['out_rows']} "
                f"kpt={entry['kernels_per_tile']} {entry['dataflow']}")
    if entry["kind"] == "matmul":
        return f"{entry['dataflow']} block={tuple(entry['block'])}"
    if entry["kind"] == "flash_attention":
        return f"block_q={entry['block_q']} block_kv={entry['block_kv']}"
    return f"block_kv={entry['block_kv']}"


# --- the tuner ---------------------------------------------------------------------
@dataclass
class OpTuneResult:
    name: str
    sig: str
    kind: str
    incumbent: dict
    winner: dict
    measurements: int                  # replay timings performed
    incumbent_time_s: float | None = None
    winner_time_s: float | None = None
    cached: bool = False               # served from the cache, untouched
    candidates: int = 0                # candidates scored
    record: object = field(default=None, repr=False)   # the TraceRecord
    # the winner's replay substitution (``replay.op_from_record``), when
    # it was measured
    candidate: dict | None = field(default=None, repr=False)

    @property
    def changed(self) -> bool:
        return not self.cached and not _same_decisions(self.incumbent,
                                                       self.winner)


@dataclass
class TuneReport:
    config: str
    hw_fp: str
    batch: int
    results: list
    n_measurements: int
    error_rows: list = field(default_factory=list)

    def summary(self) -> str:
        lines = [f"tune {self.config} (hw {self.hw_fp}, batch "
                 f"{self.batch}): {len(self.results)} tunable ops, "
                 f"{self.n_measurements} replay measurements"]
        for r in self.results:
            if r.cached:
                lines.append(f"  {r.name:<16} cached")
                continue
            t = (f"{r.winner_time_s * 1e6:9.2f}us"
                 if r.winner_time_s is not None else "  (modeled)")
            base = (f" vs {r.incumbent_time_s * 1e6:.2f}us incumbent"
                    if r.incumbent_time_s is not None else "")
            lines.append(
                f"  {r.name:<16} {'TUNED ' if r.changed else 'kept  '}{t}"
                f"{base}; {r.measurements} of {r.candidates} candidates "
                f"measured; incumbent {decisions(r.incumbent)}"
                + (f" -> winner {decisions(r.winner)}" if r.changed else ""))
        return "\n".join(lines)


def tune_program(program, graph: ModelGraph, params, x: torch.Tensor, *,
                 config_name: str, batch: int, hw: HardwareModel,
                 cache: TunedCache | None = None, impl: str = "auto",
                 top_k: int = 3, repeats: int = 3, measure: bool = True,
                 state=None, mask=None, seed: int = 0,
                 paper_faithful: bool = False) -> TuneReport:
    """Trace -> calibrate -> search -> measure -> pin, for one Program
    run on the device ``x`` lies on.

    For every tunable op not already covered by ``cache``: enumerate the
    feasible candidates, drop any whose modeled traffic exceeds the
    incumbent's, rank the rest by
    calibrated cost, replay-measure the best ``top_k`` (incumbent always
    included), and pin the fastest.  Ties go to lower modeled traffic,
    then to the incumbent.  ``measure=False`` ranks on the calibrated
    model alone.  On the card the trace and the replays read the device
    clock, and a candidate whose launches equal an already measured
    one's (``replay.launch_key``) takes that time without a replay.

    Ops already in the cache are *not* re-measured -- a fully covered
    Program tunes with zero replay measurements.  A candidate the
    hardware model finds infeasible (``ValueError`` from
    ``entry_to_replay_candidate``) is skipped; anything else a replay
    raises (a kernel that fails to build or launch) propagates.
    """
    from ..runtime.executor import trace_program
    from ..runtime.replay import launch_key, replay_record
    cache = cache if cache is not None else TunedCache()
    dev = x.device
    fp = hw_fingerprint(hw, dev)
    on_card = dev.type == "cuda" and impl != "reference"
    nodes = {n.name: n for n in graph}
    trace = trace_program(program, params, x, impl=impl, repeats=repeats,
                          measure=measure,
                          clock="device" if dev.type == "cuda" else "host",
                          state=state, mask=mask)
    cm = None
    if measure:
        cm = fit_cost_model(trace.record_dicts())
        cache.set_cost_model(fp, cm)
    else:
        cm = cache.cost_model(fp)

    results: list[OpTuneResult] = []
    n_meas = 0
    for rec in trace.records:
        if rec.kind not in TUNABLE or rec.name not in nodes:
            continue
        node = nodes[rec.name]
        sig = op_signature(node)
        incumbent = _incumbent_decisions(rec)
        hit = cache.lookup(config_name, fp, batch, sig)
        if hit is not None:
            results.append(OpTuneResult(
                name=rec.name, sig=sig, kind=rec.kind, incumbent=incumbent,
                winner=hit, measurements=0, cached=True, record=rec))
            continue

        cands = enumerate_candidates(node, hw,
                                     paper_faithful=paper_faithful)
        inc_traffic = next(
            (c["modeled_traffic"] for c in cands
             if _same_decisions(c, incumbent)), rec.traffic_bytes)
        cands = [c for c in cands
                 if c["modeled_traffic"] <= inc_traffic * (1 + 1e-9)]

        def predicted(c):
            analytic = hw.exec_time(rec.flops, c["modeled_traffic"])
            if cm is None:
                return analytic
            return cm.predict(rec.kind, rec.flops, c["modeled_traffic"],
                              analytic)

        cands.sort(key=lambda c: (predicted(c), c["modeled_traffic"]))
        short = cands[:max(top_k, 1)]
        if not any(_same_decisions(c, incumbent) for c in short):
            short.append({**incumbent, "modeled_traffic": inc_traffic})

        scored = []
        timed: dict = {}               # launch key -> its measured time
        op_meas = 0
        for c in short:
            rc = None
            if measure:
                try:
                    rc = entry_to_replay_candidate(node, c, hw)
                except ValueError:
                    continue           # infeasible candidate: skip
                key = launch_key(rec, rc) if on_card else None
                if key is not None and key in timed:
                    t = timed[key]
                else:
                    _, t = replay_record(rec, candidate=rc, impl=impl,
                                         repeats=repeats, seed=seed,
                                         device=dev)
                    op_meas += 1
                    if key is not None:
                        timed[key] = t
            else:
                t = predicted(c)
            scored.append((t, c["modeled_traffic"],
                           0 if _same_decisions(c, incumbent) else 1, c, rc))
        n_meas += op_meas
        scored.sort(key=lambda s: s[:3])
        t_win, traffic_win, _, winner, rc_win = scored[0]
        t_inc = next((s[0] for s in scored
                      if _same_decisions(s[3], incumbent)), None)
        entry = {k: v for k, v in winner.items() if k != "modeled_traffic"}
        entry.update(sig=sig, modeled_traffic=traffic_win,
                     measured_time_s=t_win if measure else None,
                     incumbent_time_s=t_inc if measure else None)
        cache.store(config_name, fp, batch, sig, entry)
        results.append(OpTuneResult(
            name=rec.name, sig=sig, kind=rec.kind, incumbent=incumbent,
            winner=entry, measurements=op_meas, candidates=len(scored),
            incumbent_time_s=t_inc if measure else None,
            winner_time_s=t_win if measure else None, record=rec,
            candidate=rc_win))

    if cache.path:
        cache.save()
    rows = error_table(trace.record_dicts(), cm) if measure else []
    return TuneReport(config=config_name, hw_fp=fp, batch=batch,
                      results=results, n_measurements=n_meas,
                      error_rows=rows)


# --- model-level entry points ------------------------------------------------------
def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def tune_cnn(cfg, batch: int = 1, hw: HardwareModel = TPU_V5E, *,
             cache: TunedCache | None = None, impl: str = "auto",
             top_k: int = 3, repeats: int = 3, measure: bool = True,
             paper_faithful: bool = False, seed: int = 0,
             device=None) -> TuneReport:
    """Tune a CNN config's Program on ``device`` (default: the card),
    with parameters from the port's initialiser and an input drawn from
    ``seed``."""
    from ..models import cnn
    from ..models.common import init_params
    dev = resolve_device(device)
    program = cnn.compile_program(cfg, batch=batch, hw=hw,
                                  paper_faithful=paper_faithful)
    graph = cnn.to_graph(cfg, batch=batch, dtype_bytes=cfg.tdtype.itemsize)
    graph.mark_residuals()
    graph.mark_pool_fusion()
    params = init_params(cnn.param_defs(cfg), _generator(seed, dev), dev)
    x = torch.randn((batch, cfg.input_hw, cfg.input_hw, cfg.input_ch),
                    generator=_generator(seed + 1, dev),
                    device=dev).to(cfg.tdtype)
    return tune_program(program, graph, params, x, config_name=cfg.name,
                        batch=batch, hw=hw, cache=cache, impl=impl,
                        top_k=top_k, repeats=repeats, measure=measure,
                        paper_faithful=paper_faithful, seed=seed)


def tune_lm_decode(cfg, slots: int = 2, max_len: int = 32,
                   hw: HardwareModel = TPU_V5E, *,
                   cache: TunedCache | None = None, impl: str = "auto",
                   top_k: int = 3, repeats: int = 3, measure: bool = True,
                   seed: int = 0, device=None) -> TuneReport:
    """Tune an LM's decode Program on ``device`` (default: the card):
    prefill every slot to ``max_len // 2`` (realistic cache occupancy),
    then trace + tune
    the per-token decode step.  The cache scope's batch is ``slots`` --
    the decode step's true batch."""
    from ..models import param_defs, transformer
    from ..models.common import init_params
    from ..runtime.executor import init_program_state, run_prefill
    dev = resolve_device(device)
    pair = transformer.compile_program_pair(cfg, slots=slots,
                                            max_len=max_len, hw=hw)
    graph = transformer.to_decode_graph(cfg, slots=slots, max_len=max_len)
    graph.mark_residuals()
    graph.mark_pool_fusion()
    params = init_params(param_defs(cfg), _generator(seed, dev), dev)
    state = init_program_state(pair, dev)
    plen = max(max_len // 2, 1)
    for slot in range(slots):
        toks = torch.randint(0, cfg.vocab, (1, max_len),
                             generator=_generator(seed + 2 + slot, dev),
                             device=dev, dtype=torch.int32)
        run_prefill(pair.prefill, params, toks, state, slot, plen, impl=impl)
    step = torch.randint(0, cfg.vocab, (slots,),
                         generator=_generator(seed + 99, dev), device=dev,
                         dtype=torch.int32)
    return tune_program(pair.decode, graph, params, step,
                        config_name=cfg.name, batch=slots, hw=hw,
                        cache=cache, impl=impl, top_k=top_k,
                        repeats=repeats, measure=measure,
                        state=state, seed=seed)


_HW = {"tpu_v5e": TPU_V5E, "snowflake": SNOWFLAKE}


def main(argv=None) -> int:
    from ..configs import get_config
    from ..configs.base import CNNConfig
    ap = argparse.ArgumentParser(description="trace + calibrate + tune")
    ap.add_argument("--config", required=True,
                    help="config name (CNN or LM; -smoke suffix ok)")
    ap.add_argument("--cache", required=True, help="tuned-cache JSON path")
    ap.add_argument("--batch", type=int, default=1, help="CNN batch size")
    ap.add_argument("--slots", type=int, default=2, help="LM decode slots")
    ap.add_argument("--max-len", type=int, default=32, help="LM max_len")
    ap.add_argument("--hw", choices=sorted(_HW), default="tpu_v5e")
    ap.add_argument("--impl", default="auto")
    ap.add_argument("--top-k", type=int, default=3,
                    help="candidates measured per op")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--no-measure", action="store_true",
                    help="rank on the calibrated model only (no replay)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs "
                         "the plain PyTorch versions)")
    args = ap.parse_args(argv)
    cfg = get_config(args.config)
    cache = TunedCache.load(args.cache)
    kw = dict(cache=cache, impl=args.impl, top_k=args.top_k,
              repeats=args.repeats, measure=not args.no_measure,
              hw=_HW[args.hw], device=args.device)
    if isinstance(cfg, CNNConfig):
        report = tune_cnn(cfg, batch=args.batch, **kw)
    else:
        report = tune_lm_decode(cfg, slots=args.slots, max_len=args.max_len,
                                **kw)
    print(report.summary())
    if report.error_rows:
        print(format_error_table(report.error_rows))
    cache.save(args.cache)
    print(f"cache {args.cache}: {len(cache.entries)} entries, "
          f"generation {cache.generation()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
