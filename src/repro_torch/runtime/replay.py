"""Replay harness — re-execute one traced ProgramOp, optionally with a
*candidate* schedule substituted (counterpart of
``repro/runtime/replay.py``).

This is the autotuner's measurement primitive (byteprofile-style: the
trace records what ran; replay re-runs it in isolation).  A trace
record (``runtime/executor.TraceRecord``) fully determines an op's
dispatch — kind, resolved schedule, operand shapes and dtypes — so a
single op can be rebuilt and timed without its Program, its params or
its upstream activations: operands are synthesized at the recorded
shapes from a seeded ``torch.Generator`` on the replay's device, regions
are remapped to a private id space, and the param path is rewritten to
a flat ``"p"`` / ``"p_b"`` dict.  Execution goes through the executor's
own per-op dispatcher (``executor._run_decode_op``, which ``run``,
``run_decode`` and ``trace_program`` call), so a replayed op cannot
drift from what the executor runs.

``candidate`` substitutes schedule decisions before dispatch — conv
(out_rows, kernels_per_tile, strip_storage, loop order), matmul
(dataflow, block), attention (block_q, block_kv) — which is how
``core/autotune.py`` measures a candidate: schedule decisions change
where bytes move, never the math, so a replayed output matches the
incumbent's (bit for bit on the plain path, to kernel tolerance on the
card).  ``launch_key`` says which candidates make the same CUDA
launches, from each kernel's plan.

On the card a replay is timed on the device clock
(``executor.device_times``: calls captured in one CUDA graph, replays
read between CUDA events), on the CPU on the host clock, as the trace
is.

The module is also a CLI: ``python -m repro_torch.runtime.replay
TRACE.jsonl`` prints the measured-vs-predicted error table per kernel
kind, before and after calibration (``core/cost.fit_cost_model``); it
reads a trace of either package.
"""
from __future__ import annotations

import argparse
import json
import math

import torch

from ..core.dataflow import Dataflow
from ..core.program import AttentionSpec, ProgramOp
from ..core.tiling import ConvTiling
from ..kernels.common import resolve_device
from .executor import (_FAMILY_KERNELS, CLOCK_CALLS, TraceRecord,
                       _run_decode_op, _time_thunk, device_times)

__all__ = ["op_from_record", "synth_operands", "replay_record",
           "replay_outputs", "launch_key", "error_report"]

# Private region-id space for rebuilt ops (never collides with a real
# plan: replay builds its own regions dict).
_RID = {"in": 0, "k": 1, "v": 2, "in2": 3, "bypass": 4, "out": 9,
        "k_cache": 10, "v_cache": 11}
# Kinds a record cannot rebuild: the recurrent blocks and the MoE
# dispatch carry a whole block's param subtree (and persistent state),
# cross attention the encoder memory regions.
_NOT_REPLAYABLE = _FAMILY_KERNELS + ("moe_dispatch", "cross_attention")


def _record(record: TraceRecord | dict) -> TraceRecord:
    return (record if isinstance(record, TraceRecord)
            else TraceRecord.from_dict(record))


def op_from_record(record: TraceRecord | dict,
                   candidate: dict | None = None) -> ProgramOp:
    """Rebuild an executable ProgramOp from a trace record, with
    ``candidate`` schedule decisions substituted.

    Candidate keys (all optional): ``conv_tiling`` (ConvTiling or its
    asdict), ``strip_storage``, ``dataflow`` (Dataflow or its value),
    ``block`` ((bm, bk, bn)), ``block_q``, ``block_kv``.
    """
    r = _record(record)
    s = dict(r.schedule)
    if candidate:
        s.update({k: v for k, v in candidate.items()
                  if k not in ("block_q", "block_kv")})
    ct = s.get("conv_tiling")
    if isinstance(ct, dict):
        ct = ConvTiling(**ct)
    df = s.get("dataflow")
    if isinstance(df, str):
        df = Dataflow(df)
    block = tuple(s["block"]) if s.get("block") else None
    attn = None
    if s.get("attn"):
        a = dict(s["attn"])
        if candidate:
            for k in ("block_q", "block_kv"):
                if k in candidate:
                    a[k] = candidate[k]
        attn = AttentionSpec(**a)
    # Keep the op's strip_storage consistent with a substituted tiling.
    strip = s.get("strip_storage")
    if ct is not None and candidate and "conv_tiling" in candidate:
        strip = ct.strip_storage
    has_bypass = s.get("fuse_bypass") and "bypass" in r.operands
    return ProgramOp(
        index=0, name=r.name, kernel=r.kind,
        in_region=_RID["in"], out_region=_RID["out"],
        param_key="p" if ("w" in r.operands or r.kind == "embed") else None,
        param_key_b="p_b" if "b" in r.operands and r.kind == "norm" else None,
        bypass_region=_RID["bypass"] if has_bypass else None,
        k_region=_RID["k"] if "k" in r.operands else None,
        v_region=_RID["v"] if "v" in r.operands else None,
        in2_region=_RID["in2"] if "in2" in r.operands else None,
        k_cache_region=_RID["k_cache"] if "k_cache" in r.operands else None,
        v_cache_region=_RID["v_cache"] if "v_cache" in r.operands else None,
        stride=s.get("stride", 1), pad=s.get("pad", 0),
        window=s.get("window", 0),
        fuse_bias=s.get("fuse_bias", False),
        fuse_activation=s.get("fuse_activation"),
        fuse_bypass=bool(has_bypass),
        bypass_first=s.get("bypass_first", True),
        fuse_pool=tuple(s["fuse_pool"]) if s.get("fuse_pool") else None,
        strip_storage=strip, dataflow=df, conv_tiling=ct, block=block,
        attn=attn, norm_kind=s.get("norm_kind"),
        flatten_input=s.get("flatten_input", False),
        transpose_w=s.get("transpose_w", False),
        flops=r.flops, traffic_bytes=r.traffic_bytes,
        exec_time_s=r.modeled_time_s)


def _dtype(name: str) -> torch.dtype:
    """A recorded (numpy-named) dtype as torch's."""
    return getattr(torch, name)


def _synth(shape, dtype: str, gen: torch.Generator, device, *,
           vocab: int | None = None, scale: float = 0.1) -> torch.Tensor:
    shape, dt = tuple(shape), _dtype(dtype)
    if dt == torch.bool:
        return torch.ones(shape, dtype=torch.bool, device=device)
    if not dt.is_floating_point:
        return torch.randint(0, max(vocab or 2, 2), shape, generator=gen,
                             device=device, dtype=dt)
    x = torch.randn(shape, generator=gen, device=device)
    return (x * scale).to(dt)


def synth_operands(record: TraceRecord | dict, seed: int = 0, *,
                   device=None, scale: float = 0.1) -> tuple[dict, dict]:
    """(regions, params) with random tensors at the recorded shapes and
    dtypes on ``device`` (default: the card), drawn from a
    ``torch.Generator`` seeded by ``seed``, so the same seed gives the
    same operands; float operands are normal with std ``scale`` (at 1,
    a decode op's scores spread by about one, so its softmax is far
    from uniform).  Token inputs (int dtypes) draw from the recorded
    embed-table row count when present."""
    r = _record(record)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    vocab = r.operands["w"][0][0] if r.kind == "embed" else None
    regions: dict[int, torch.Tensor] = {}
    for role in ("in", "k", "v", "in2", "bypass", "k_cache", "v_cache"):
        if role in r.operands:
            shape, dt = r.operands[role]
            regions[_RID[role]] = _synth(shape, dt, gen, dev, vocab=vocab,
                                         scale=scale)
    params: dict = {}
    if "w" in r.operands:
        flag = r.operands.get("param_dict")
        w = _synth(*r.operands["w"], gen, dev, scale=scale)
        if flag and flag[1] == "dict":
            params["p"] = {"w": w}
            if "b" in r.operands:
                params["p"]["b"] = _synth(*r.operands["b"], gen, dev,
                                          scale=scale)
        else:
            params["p"] = w
            if "b" in r.operands:          # norm bias rides separately
                params["p_b"] = _synth(*r.operands["b"], gen, dev,
                                       scale=scale)
    return regions, params


def replay_outputs(record: TraceRecord | dict, *,
                   candidate: dict | None = None, impl: str = "auto",
                   seed: int = 0, device=None, scale: float = 0.1):
    """Execute the rebuilt op once; returns its output tensor (decode
    ops: the attention output).  Same seed (and ``scale``) => same
    synthetic operands, so two candidates' outputs are directly
    comparable."""
    out, _ = replay_record(record, candidate=candidate, impl=impl,
                           seed=seed, device=device, measure=False,
                           scale=scale)
    return out


@torch.no_grad()
def replay_record(record: TraceRecord | dict, *,
                  candidate: dict | None = None, impl: str = "auto",
                  repeats: int = 3, measure: bool = True, seed: int = 0,
                  device=None, scale: float = 0.1):
    """(output, measured_time_s | None) for one rebuilt op on
    ``synth_operands(record, seed, device=device, scale=scale)``.

    The measurement is the trace's clock for the operands' device: on
    the card ``device_times`` (``CLOCK_CALLS`` calls a graph, the minimum
    over ``repeats`` replays), on the CPU ``_time_thunk``'s
    min-of-repeats.  A decode op's cache rows are put back before each
    timed replay.
    """
    r = _record(record)
    if r.kind in _NOT_REPLAYABLE:
        # Family ops carry whole-block param subtrees and persistent
        # state rows the record does not serialize, so they cannot be
        # rebuilt in isolation.  The autotuner never proposes
        # candidates for them (autotune.TUNABLE); calibration still fits
        # these kinds from their traced measurements.
        raise NotImplementedError(
            f"replay of family op kind {r.kind!r}: not rebuildable "
            f"from a trace record (block param subtree + persistent "
            f"state); these kinds are identity-only in the autotuner")
    op = op_from_record(r, candidate)
    regions, params = synth_operands(r, seed, device=device, scale=scale)
    dev = regions[op.in_region].device
    caches = pos = live = reset = None
    if r.kind == "decode_attention":
        slots, cache_len = r.operands["k_cache"][0][:2]
        pos = torch.tensor(r.extras.get("pos", [cache_len // 2] * slots),
                           dtype=torch.int32, device=dev)
        live = torch.tensor(r.extras.get("live", [True] * slots),
                            dtype=torch.bool, device=dev)
        caches = regions
        before = {rid: regions[rid].clone()
                  for rid in (op.k_cache_region, op.v_cache_region)}

        def reset():
            for rid, t in before.items():
                regions[rid].copy_(t)

    def thunk():
        return _run_decode_op(op, regions[op.in_region], regions, params,
                              caches, pos, live, impl=impl)

    out = thunk()
    t = None
    if measure:
        t = (min(device_times(thunk, CLOCK_CALLS, repeats, dev, reset=reset))
             if dev.type == "cuda" else _time_thunk(thunk, repeats, dev, reset))
    return out, t


def launch_key(record: TraceRecord | dict,
               candidate: dict | None = None) -> tuple | None:
    """What the rebuilt op (with ``candidate`` substituted) launches on
    the card, from its kernel's plan (the ops modules' ``launch_key``):
    two candidates with equal keys make the same launches, so one
    measurement times both.  None for a kind without a tunable kernel."""
    r = _record(record)
    op = op_from_record(r, candidate)
    shape = {role: tuple(r.operands[role][0]) for role in r.operands}
    dtype = _dtype(r.operands["in"][1])
    if op.kernel == "conv2d":
        from ..kernels.conv2d.ops import launch_key as conv_key
        return conv_key(
            shape["in"], shape["w"], dtype, stride=op.stride, pad=op.pad,
            tiling=op.conv_tiling, dataflow=op.dataflow,
            strip_storage=op.strip_storage or "auto", fuse_pool=op.fuse_pool,
            bias=op.fuse_bias, activation=op.fuse_activation,
            bypass=op.fuse_bypass, bypass_first=op.bypass_first)
    if op.kernel == "matmul":
        from ..kernels.matmul.ops import launch_key as matmul_key
        K, N = shape["w"][::-1] if op.transpose_w else shape["w"]
        M = (shape["in"][0] if op.flatten_input
             else math.prod(shape["in"][:-1]))
        return matmul_key(M, K, N, dtype, dataflow=op.dataflow,
                          block=op.block,
                          b_transposed=op.transpose_w
                          and dtype == torch.bfloat16)
    a = op.attn
    if op.kernel == "flash_attention":
        from ..kernels.flash_attention.ops import launch_key as flash_key
        B, S = shape["in"][:2]
        return flash_key((B, a.heads, S, a.head_dim),
                         (B, a.kv_heads, S, a.head_dim), dtype,
                         causal=a.causal, window=a.window, kv_len=None,
                         block_q=a.block_q, block_kv=a.block_kv)
    if op.kernel == "decode_attention" and op.page_table_region is None:
        from ..kernels.decode_attention.ops import launch_key as decode_key
        slots, S, Hkv, D = shape["k_cache"]
        return decode_key((shape["in"][0], a.heads, a.head_dim),
                          (slots, Hkv, S, D), dtype,
                          _dtype(r.operands["k_cache"][1]))
    return None


def error_report(trace, calibrate: bool = True) -> tuple[list[dict], str]:
    """(rows, rendered table) of measured-vs-predicted error per kernel
    kind for a trace — the harness's headline artifact.  With
    ``calibrate`` the table also shows the post-fit error of
    ``core/cost.fit_cost_model`` on the same records."""
    from ..core.cost import error_table, fit_cost_model, format_error_table
    recs = trace.record_dicts()
    model = fit_cost_model(recs) if calibrate else None
    rows = error_table(recs, model)
    return rows, format_error_table(rows)


def main(argv=None) -> int:
    from .executor import ExecutorTrace
    ap = argparse.ArgumentParser(
        description="measured-vs-predicted error table for a trace")
    ap.add_argument("trace", help="JSONL trace from trace_program(...).save")
    ap.add_argument("--no-calibrate", action="store_true",
                    help="skip the least-squares fit column")
    ap.add_argument("--json", metavar="PATH",
                    help="also write the table rows as JSON")
    args = ap.parse_args(argv)
    trace = ExecutorTrace.load(args.trace)
    rows, table = error_report(trace, calibrate=not args.no_calibrate)
    print(f"trace {args.trace}: program {trace.program} on {trace.hw} "
          f"(impl={trace.impl}, repeats={trace.repeats})")
    print(table)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
