"""Program executor — runs the compiler's instruction stream (§5.2).

Counterpart of ``repro/runtime/executor.py`` for the CNN, dense-LM, MoE,
recurrent-family (rwkv6, zamba2 / mamba2) and audio (whisper) Program
paths: ``run`` walks a
``core/program.py::Program`` and dispatches each op to the kernels with
the schedule's *pre-resolved* decisions — conv strip tiling, strip
storage, loop order, matmul block, attention (block_q, block_kv) and the
fused epilogue flags.  Nothing is re-derived at run time; region ids are
the allocator's, read from the ops.

Stateful Programs (the LM serving pair) add a ``ProgramState``: the
persistent KV-cache buffers keyed by the allocator's persistent region
ids, plus the per-slot sequence lengths.  ``run_prefill`` executes the
prefill Program for one admitted request and writes each block's K/V
into the cache regions at its slot; ``run_decode`` advances every slot
by one token through the ``decode_attention`` ops.  The reference
threads the state functionally and donates it to XLA; here both update
the state's tensors **in place**, on the device they live on.

The recurrent families' coarse block ops (``wkv``, ``ssm_scan``) carry
their state in the allocator's generic persistent regions, named by
``op.state_regions`` in the family's order: prefill runs the model's
``block_prefill`` from zero state and scatters each final state into its
region at the admitted slot, decode runs ``block_decode`` against every
slot's state and keeps a dead slot's rows (``live``).

The §5.1 paged plan keeps the KV rows in page pools addressed through
a per-slot page table: ``run_prefill`` scatters whole pages (the rows of
a shared prefix redirected to the null page 0) and ``run_decode`` writes
each new row into its table-mapped page -- an int8 pool requantizes the
page -- and attends through ``paged_decode_attention``.  The host-side
``PagePool`` decides admission, on-demand pages and copy-on-write forks
between calls; ``sync_page_table`` and ``apply_page_copies`` hand its
decisions to the state's device tensors in place.  ``run_prefill_chunk``
prefills rows ``[start, stop)`` of several admissions at once against
the cache rows earlier chunks wrote, bitwise-equal to a whole prefill.

The reference's jitted runners (``jitted_runner``,
``jitted_prefill_runner``, ``jitted_decode_runner``,
``jitted_chunk_runner``) become CUDA-graph runners: ``graphed_runner``
and its prefill, decode and chunk counterparts run a Program's first
call of each input shape eagerly, capture the second into a CUDA graph
and replay it from then on, so a call on the card costs one graph
launch instead of one Python dispatch per op.  ``disable_graphs()`` is
the counterpart of ``jax.disable_jit()``; on the CPU every call runs
eagerly (the plain path).  The kernels run on the device the input lies
on (``impl="auto"``).  The training step (``launch/steps.py``) runs off
the same graphs (``_Graph``, ``GraphStore``).

A ``moe_dispatch`` op runs ``models/moe.py::moe_mlp`` on its block's
expert weights and adds the residual on the writeback; a prefill hands
it the prompt's length as ``valid_count``, so the padded rows claim no
expert capacity.

``trace_program`` walks a Program op by op, eagerly, timing each op and
recording the reference's ``TraceRecord`` schema (shapes with numpy's
dtype names, so the JSONL of either package reads in the other); it
works on a copy of the state it is given.  It reads one of two clocks:
the host's, each call between two synchronises (eager dispatch plus
kernels), or the device's (``device_times``: calls captured in one CUDA
graph, replays read between CUDA events), which the autotuner ranks and
calibrates on.  ``OpTimingSampler`` runs it on one serving tick in N on
the host clock and files the times on the metrics plane.

A ``cross_attention`` op (whisper's decoder) reads the slot's read-only
encoder memory regions, which the serving engine writes at admission
before the prefill runs: a prefill takes the admitted slot's rows
(``index_select`` with the (1,) device slot, no host read) through the
non-causal flash kernel, a decode tick runs the decode kernel over every
slot's whole memory through a transposed view of the region.  An
``embed`` op with a second table (``param_key_b``, learned positions)
adds rows ``[0, S)`` at prefill and each slot's position row at decode.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.program import Program, ProgramOp, ProgramPair
from ..core.quant import int8_quantize_pages, int8_requantize_page
from ..core.regions import PAGE_TABLE_REGION, PagedPlan, pages_for_len
from ..kernels.common import resolve_device
from ..kernels.conv2d import avgpool2d_ref, conv2d, maxpool2d_ref
from ..kernels.decode_attention import (decode_attention,
                                        paged_decode_attention, ring_kv_len,
                                        ring_positions)
from ..kernels.flash_attention import flash_attention
from ..kernels.matmul import matmul

__all__ = ["run", "walk", "ProgramState", "GraphStore",
           "init_program_state", "run_prefill", "run_prefill_chunk",
           "run_decode", "graphed_runner", "graphed_prefill_runner",
           "graphed_decode_runner", "graphed_chunk_runner",
           "disable_graphs", "PagePool", "paged_pool_regions",
           "sync_page_table", "apply_page_copies", "TraceRecord",
           "ExecutorTrace", "trace_program", "device_times", "graph_seconds",
           "OpTimingSampler"]

# coarse recurrent block ops, dispatched by ``_run_family_op``
_FAMILY_KERNELS = ("wkv", "ssm_scan")


def _param(params, key: str | None):
    """Resolve a ProgramOp param path.

    ``"layer_03"``       -> params["layer_03"]           (CNN groups)
    ``"blocks/wq:3"``    -> params["blocks"]["wq"][3]    (stacked LM blocks)
    ``"blocks:3"``       -> every leaf of params["blocks"] at index 3
    """
    if key is None:
        return None
    path, _, idx = key.partition(":")
    p = params
    for part in path.split("/"):
        p = p[part]
    if not idx:
        return p
    i = int(idx)
    if isinstance(p, dict):
        return {k: v[i] for k, v in p.items()}
    return p[i]


def _bypass(op: ProgramOp, regions: dict):
    """The region ``op``'s epilogue adds, or None."""
    if op.fuse_bypass and op.bypass_region is not None:
        return regions[op.bypass_region]
    return None


def _attention_heads(op: ProgramOp, regions: dict):
    """The flat q/k/v regions as per-head (B, heads, S, head_dim) views,
    RoPE'd at positions [0, S) when the spec says so."""
    from ..models.common import Rotary, apply_rope
    a = op.attn
    q, k, v = regions[op.in_region], regions[op.k_region], regions[op.v_region]
    B, S = q.shape[0], q.shape[1]
    q = q.reshape(B, S, a.heads, a.head_dim).transpose(1, 2)
    k = k.reshape(B, S, a.kv_heads, a.head_dim).transpose(1, 2)
    v = v.reshape(B, S, a.kv_heads, a.head_dim).transpose(1, 2)
    if a.rope_theta:
        cos, sin = Rotary(a.head_dim, a.rope_theta).freqs(
            torch.arange(S, device=q.device))
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    return q, k, v


def _run_attention(op: ProgramOp, regions: dict, *, impl: str,
                   return_kv: bool = False):
    """One flash_attention op with the schedule's exact (block_q,
    block_kv); ``return_kv`` also hands back the per-head post-RoPE K
    and V, what a cache-writing prefill op stores."""
    a = op.attn
    q, k, v = _attention_heads(op, regions)
    B, S = q.shape[0], q.shape[2]
    out = flash_attention(q, k, v, causal=a.causal, window=a.window,
                          block_q=a.block_q, block_kv=a.block_kv, impl=impl)
    out = out.transpose(1, 2).reshape(B, S, a.heads * a.head_dim)
    if return_kv:
        return out, k, v
    return out


def _run_embed(op: ProgramOp, src: torch.Tensor, params,
               pos=None) -> torch.Tensor:
    """The token gather, plus the learned position table when the op
    names one: rows ``[0, S)`` for (B, S) tokens, each slot's row at
    ``pos`` (the state's lengths, on the device) for a decode tick."""
    out = _param(params, op.param_key)[src]
    if op.param_key_b is not None:
        pe = _param(params, op.param_key_b)
        if src.ndim >= 2:
            out = out + pe[:src.shape[1]][None].to(out.dtype)
        else:
            out = out + pe[pos].to(out.dtype)
    return out


def _run_cross_attention(op: ProgramOp, src: torch.Tensor, caches: dict,
                         *, slot=None, impl: str) -> torch.Tensor:
    """One cross-attention op against the read-only (slots, T_enc, KV,
    hd) encoder memory regions.  Prefill (B, S, H*hd): the admitted
    slot's memory (an int, or a (1,) int tensor on the device taken by
    ``index_select``), non-causal flash over all T_enc rows.  Decode
    (slots, H*hd): one query row a slot over its whole memory, read
    through a transposed view of the region."""
    a = op.attn
    ck, cv = caches[op.k_cache_region], caches[op.v_cache_region]
    if src.ndim == 3:                             # prefill: one slot
        B, S = src.shape[:2]
        q = src.reshape(B, S, a.heads, a.head_dim).transpose(1, 2)
        idx = torch.as_tensor(slot, device=ck.device).reshape(-1).long()
        km, vm = ck.index_select(0, idx), cv.index_select(0, idx)
        out = flash_attention(q, km.transpose(1, 2).to(q.dtype),
                              vm.transpose(1, 2).to(q.dtype), causal=False,
                              block_q=a.block_q, block_kv=a.block_kv,
                              impl=impl)
        return out.transpose(1, 2).reshape(B, S, a.heads * a.head_dim)
    B = src.shape[0]                              # decode: all slots
    q = src.reshape(B, a.heads, a.head_dim)
    out = decode_attention(q, ck.transpose(1, 2).to(q.dtype),
                           cv.transpose(1, 2).to(q.dtype), impl=impl)
    return out.reshape(B, a.heads * a.head_dim)


def _run_norm(op: ProgramOp, src: torch.Tensor, params) -> torch.Tensor:
    from ..models.common import layer_norm, rms_norm
    w = _param(params, op.param_key)
    if op.norm_kind == "layernorm":
        return layer_norm(src, w, _param(params, op.param_key_b))
    if op.norm_kind == "nonparametric":
        return layer_norm(src)
    return rms_norm(src, w)


def _run_moe(op: ProgramOp, src: torch.Tensor, regions: dict, params,
             length=None) -> torch.Tensor:
    """One ``moe_dispatch`` op: ``moe_mlp`` over the (tokens, D) rows of
    ``src`` with the routing config the op carries, the residual added
    on the writeback.  A prefill passes the prompt's ``length`` (an int
    or a (1,) int tensor on the device): the right-padded rows past it
    route to the sentinel expert and claim no capacity."""
    from ..models.moe import moe_mlp
    c = dict(op.op_cfg)
    p = _param(params, op.param_key)
    shp = src.shape
    vc = length if src.ndim == 3 else None
    out, _ = moe_mlp(src.reshape(-1, shp[-1]), p["router"], p["w_gate"],
                     p.get("w_up", p["w_gate"]), p["w_down"],
                     top_k=c["top_k"], capacity_factor=c["capacity_factor"],
                     activation=c["activation"], gated=c["gated"],
                     valid_count=vc)
    out = out.reshape(shp).to(src.dtype)
    bypass = _bypass(op, regions)
    return out if bypass is None else out + bypass


def _run_op(op: ProgramOp, src: torch.Tensor, regions: dict, params, *,
            impl: str, pos=None) -> torch.Tensor:
    """Dispatch one (stateless) op with its pre-resolved schedule; a
    decode tick passes the slots' positions (``pos``) for a learned
    position table."""
    if op.kernel == "conv2d":
        p = _param(params, op.param_key)
        bypass = _bypass(op, regions)
        return conv2d(
            src, p["w"], stride=op.stride, pad=op.pad,
            bias=p["b"] if op.fuse_bias else None,
            activation=op.fuse_activation, bypass=bypass,
            bypass_first=op.bypass_first, fuse_pool=op.fuse_pool,
            strip_storage=op.strip_storage or "auto",
            tiling=op.conv_tiling, dataflow=op.dataflow, impl=impl)
    if op.kernel == "matmul":
        p = _param(params, op.param_key)
        w = p["w"] if isinstance(p, dict) else p
        if op.transpose_w:
            w = w.T
        if op.flatten_input:
            # NHWC order, the order param_defs lays the FC weight out in.
            src = src.reshape(src.shape[0], -1)
        bypass = _bypass(op, regions)
        if bypass is not None and op.flatten_input:
            bypass = bypass.reshape(bypass.shape[0], -1)
        return matmul(
            src, w,
            bias=(p["b"] if isinstance(p, dict) and op.fuse_bias
                  else None),
            activation=op.fuse_activation, bypass=bypass,
            dataflow=op.dataflow, block=op.block, impl=impl)
    if op.kernel == "flash_attention":
        return _run_attention(op, regions, impl=impl)
    if op.kernel == "embed":
        return _run_embed(op, src, params, pos)
    if op.kernel == "norm":
        return _run_norm(op, src, params)
    if op.kernel == "mul":
        return src * regions[op.in2_region]
    if op.kernel == "add":
        return src + regions[op.in2_region]
    if op.kernel == "maxpool":
        return maxpool2d_ref(src, window=op.window, stride=op.stride,
                             pad=op.pad)
    if op.kernel == "avgpool":
        return avgpool2d_ref(src, window=op.window, stride=op.stride,
                             pad=op.pad)
    if op.kernel == "moe_dispatch":
        return _run_moe(op, src, regions, params)
    if op.kernel in _FAMILY_KERNELS:
        raise ValueError(
            f"op {op.name}: the recurrent {op.kernel!r} block runs through "
            f"run, run_prefill or run_decode; chunked prefill is refused "
            f"for its family (ProgramPair.chunk_blocker)")
    if op.kernel == "cross_attention":
        raise ValueError(
            f"op {op.name} reads persistent encoder memory; use "
            f"run_prefill/run_decode with a ProgramState")
    raise NotImplementedError(f"unknown program kernel {op.kernel}")


@torch.no_grad()
def run(program: Program, params, x: torch.Tensor, *,
        impl: str = "auto") -> torch.Tensor:
    """Execute ``program`` against ``params`` on input ``x``: (B, H, W,
    C) images for CNN programs, (B, S) int tokens for LM programs.
    Returns the final op's output (the tensor living in
    ``program.output_region``).  Cache-writing prefill ops run as plain
    flash attention here; ``decode_attention`` ops need state — use
    ``run_decode``."""
    regions: dict[int, torch.Tensor] = {program.input_region: x}
    for op in program.ops:
        if op.kernel == "decode_attention":
            raise ValueError(
                f"op {op.name} needs a ProgramState (persistent KV "
                f"regions); use run_decode for decode Programs")
        regions[op.out_region] = _run_decode_op(
            op, regions[op.in_region], regions, params, None, None, None,
            impl=impl)
    return regions[program.output_region]


def walk(program: Program, params, x: torch.Tensor, *,
         impl: str = "auto"):
    """Execute ``program`` as ``run`` does, yielding each op before it
    runs with its operands: ``(op, src, op_params, bypass)`` — the input
    region, the op's parameter subtree (None for a parameterless op) and
    the region its epilogue adds (None without one), before any
    flattening the op applies."""
    regions: dict[int, torch.Tensor] = {program.input_region: x}
    for op in program.ops:
        src = regions[op.in_region]
        yield op, src, _param(params, op.param_key), _bypass(op, regions)
        with torch.no_grad():
            regions[op.out_region] = _run_op(op, src, regions, params,
                                             impl=impl)


def _write_state_row(caches: dict, rid: int, val: torch.Tensor,
                     slot) -> None:
    """Scatter a prefill op's (1, ...) final state into the (slots, ...)
    persistent region at the admitted slot (an int or a (1,) int tensor
    on the state's device), in place."""
    buf = caches[rid]
    buf[slot] = val[0].to(buf.dtype)


def _run_family_op(op: ProgramOp, src: torch.Tensor, params,
                   caches: dict | None, *, slot=None, length=None,
                   live=None, impl: str) -> torch.Tensor:
    """Dispatch one coarse recurrent block op (``wkv`` | ``ssm_scan``).

    Prefill and decode share one arm per kernel, split on the operand
    rank -- (B, S, D) is a prefill pass, (slots, D) a decode tick --
    because the instruction stream is the only difference the lowering
    leaves between the two.  The ops resolve their buffers through
    ``op.state_regions`` (the allocator's generic persistent rids, in
    the family's order) and never assume a KV shape.  Prefill scatters
    the block's final state at the admitted slot; decode reads and
    rewrites all slots in place, dead ones kept at their old rows via
    ``live``.  ``caches=None`` (stateless ``run``) skips the writes --
    the blocks still compute from their zero init."""
    from ..models import rwkv, zamba2
    model = rwkv if op.kernel == "wkv" else zamba2
    p = _param(params, op.param_key)
    if src.ndim == 3:                             # prefill pass
        out, states = model.block_prefill(src, p, impl=impl, length=length)
        if caches is not None and op.state_regions:
            for rid, val in zip(op.state_regions, states):
                _write_state_row(caches, rid, val, slot)
        return out
    if caches is None:
        raise ValueError(
            f"op {op.name} needs a ProgramState (persistent state "
            f"regions); use run_decode for decode Programs")
    states = [caches[r] for r in op.state_regions]
    if op.kernel == "wkv":
        out, new = rwkv.block_decode(src, p, *states)
    else:
        out, new = zamba2.block_decode(src, p, *states, impl=impl)
    for old, fresh in zip(states, new):
        fresh = fresh.to(old.dtype)
        if live is not None:
            keep = live.reshape((-1,) + (1,) * (old.ndim - 1))
            fresh = torch.where(keep, fresh, old)
        old.copy_(fresh)
    return out


# --- stateful Programs (the LM serving prefill/decode pair) -----------------------
@dataclass
class ProgramState:
    """Runtime carrier for a Program pair's persistent regions.

    ``caches`` maps the allocator's persistent region ids to their
    buffers — (slots, cache_len, kv_heads, head_dim) per block and cache
    side, cache_len being max_len or the attention window; for a paged
    plan the (n_pages, page_size, kv_heads, head_dim) pools, their
    (n_pages,) scales when int8, and the (slots, pages_per_slot) page
    table.  ``lengths`` is the per-slot sequence length (int32),
    counting absolute tokens even once the ring has wrapped.  The
    runners update both in place, and nothing replaces a tensor of
    either: ``graphs``, the state's captured CUDA graphs, read and
    write them at the addresses they had when captured."""

    caches: dict[int, torch.Tensor]
    lengths: torch.Tensor               # (slots,) int32
    graphs: "GraphStore" = field(default_factory=lambda: GraphStore(),
                                 repr=False, compare=False)


def init_program_state(pair: ProgramPair | Program,
                       device=None) -> ProgramState:
    """Zeroed persistent buffers from the plan's persistent regions (their
    shape and dtype are the allocator's), on ``device`` (the card unless
    the caller names another)."""
    dev = resolve_device(device)
    program = pair.decode if isinstance(pair, ProgramPair) else pair
    persistent = program.plan.persistent_regions()
    if not persistent:
        raise ValueError(
            f"program {program.name} reserves no persistent regions "
            f"({len(program.plan.regions)} transient only) — stateful "
            f"execution needs a plan extended via "
            f"regions.extend_with_persistent (e.g. "
            f"transformer.compile_program_pair)")
    caches = {r.rid: torch.zeros(r.shape, dtype=getattr(torch, r.dtype),
                                 device=dev) for r in persistent}
    # Paged plans take the slot count off the page table (pools are
    # slot-agnostic); contiguous plans off any cache region's axis 0.
    pt = next((r for r in persistent if r.name == PAGE_TABLE_REGION), None)
    slots = (pt if pt is not None else persistent[0]).shape[0]
    return ProgramState(caches, torch.zeros((slots,), dtype=torch.int32,
                                            device=dev))


def _write_prefill_cache(caches: dict, op: ProgramOp, k, v, slot,
                         length) -> None:
    """Store a prefill op's per-head K/V — (1, KV, S, hd) — into the
    (slots, cache_len, KV, hd) cache regions at ``slot``, in place.  A
    window-sized region (cache_len < S) receives the ring layout through
    the shared ``ring_positions`` rule; every ring slot is written, so a
    re-admitted slot never keeps a dead request's rows.  ``slot`` and
    ``length`` are ints or (1,) int tensors on the state's device (the
    graph-safe form: no value is read back to the host)."""
    for rid, val in ((op.k_cache_region, k), (op.v_cache_region, v)):
        buf = caches[rid]
        row = val[0].transpose(0, 1)                          # (S, KV, hd)
        S, cache_len = row.shape[0], buf.shape[1]
        if cache_len < S:
            row = row[ring_positions(length, cache_len, S, row.device)]
        buf[slot, :row.shape[0]] = row


def _write_prefill_cache_paged(caches: dict, op: ProgramOp, k, v, slot,
                               length, write_from) -> None:
    """Paged prefill write: scatter the prompt's K/V into the slot's
    table-mapped pool pages, one whole page per row of the scatter, in
    place.  Pages covering rows ``< write_from`` (a page multiple: the
    COW-shared prefix) and the unallocated tail entries land on the null
    page 0, so the write stays dense.  Rows at ``>= length`` are zeroed
    first, so an int8 tail page's scale is set by real rows only.
    ``slot`` / ``length`` / ``write_from``: ints or (1,) int tensors."""
    pg = op.attn.page_size
    pt_row = caches[op.page_table_region][slot].reshape(-1)
    quant = op.k_scale_region is not None
    for rid, srid, val in ((op.k_cache_region, op.k_scale_region, k),
                          (op.v_cache_region, op.v_scale_region, v)):
        buf = caches[rid]
        row = val[0].transpose(0, 1)                          # (S, KV, hd)
        S = row.shape[0]
        keep = torch.arange(S, device=row.device)[:, None, None] < length
        row = torch.where(keep, row, torch.zeros_like(row))
        pages = row.reshape(S // pg, pg, row.shape[1], row.shape[2])
        first = torch.arange(S // pg, device=row.device) * pg
        dest = torch.where(first >= write_from, pt_row,
                           torch.zeros_like(pt_row)).long()
        if quant:
            q, sc = int8_quantize_pages(pages)
            buf[dest] = q
            caches[srid][dest] = sc
        else:
            buf[dest] = pages.to(buf.dtype)


@torch.no_grad()
def run_prefill(program: Program, params, tokens: torch.Tensor,
                state: ProgramState, slot, length, write_from=0, *,
                impl: str = "auto") -> torch.Tensor:
    """Execute the prefill Program for one admitted request.

    tokens: (1, max_len) int, the prompt right-padded (rows past
    ``length`` are masked downstream by the slot's length).  Writes each
    block's K/V into the persistent cache regions at ``slot`` -- for a
    paged plan into the slot's pages, from row ``write_from`` (the
    shared-prefix redirect) on -- and sets ``lengths[slot] = length``,
    in place.  ``slot``, ``length`` and ``write_from`` are Python ints
    or (1,) int32 tensors on the state's device -- the reference's
    traced scalars; the tensor form reads nothing back to the host, so
    a CUDA graph can capture the call, and gives the int form's results
    bit for bit.  Returns the logits (1, max_len, vocab)."""
    regions: dict[int, torch.Tensor] = {program.input_region: tokens}
    for op in program.ops:
        if op.kernel == "flash_attention" and op.k_cache_region is not None:
            out, k, v = _run_attention(op, regions, impl=impl,
                                       return_kv=True)
            if op.page_table_region is not None:
                _write_prefill_cache_paged(state.caches, op, k, v, slot,
                                           length, write_from)
            else:
                _write_prefill_cache(state.caches, op, k, v, slot, length)
            regions[op.out_region] = out
            continue
        if op.kernel in _FAMILY_KERNELS:
            regions[op.out_region] = _run_family_op(
                op, regions[op.in_region], params, state.caches, slot=slot,
                length=length, impl=impl)
            continue
        if op.kernel == "moe_dispatch":
            regions[op.out_region] = _run_moe(op, regions[op.in_region],
                                              regions, params, length)
            continue
        if op.kernel == "cross_attention":
            regions[op.out_region] = _run_cross_attention(
                op, regions[op.in_region], state.caches, slot=slot,
                impl=impl)
            continue
        regions[op.out_region] = _run_op(op, regions[op.in_region], regions,
                                         params, impl=impl)
    state.lengths[slot] = length
    return regions[program.output_region]


# --- chunked prefill -----------------------------------------------------------------
def _run_attention_chunk(op: ProgramOp, regions: dict, caches: dict,
                         slot: torch.Tensor, start: torch.Tensor, *,
                         impl: str):
    """One flash op of a chunk pass: the whole-prefill front half, with
    the K/V columns at positions ``< start`` substituted from the slot's
    persistent cache rows before the kernel call.

    The pass runs over the full (B, max_len) padded token buffer, so the
    fresh rows are bitwise what a whole prefill computes there, and the
    substituted rows were written by earlier chunks of the same
    computation; the flash kernel gets the same shapes and blocks, so a
    chunked prefill reproduces the whole prefill bit for bit.  History
    per plan: contiguous rows are position-indexed; a ring holds
    position ``p`` at row ``p % cache_len``, valid for ``start -
    cache_len <= p < start``; a paged plan gathers through the slot's
    table row."""
    a = op.attn
    q, k, v = _attention_heads(op, regions)
    B, S = q.shape[0], q.shape[2]
    pos = torch.arange(S, device=q.device)
    if op.page_table_region is not None:
        pg = a.page_size
        pt_rows = caches[op.page_table_region][slot]     # (B, pages_per_slot)
        page = pt_rows[:, pos // pg].long()              # (B, S)
        hk = caches[op.k_cache_region][page, pos % pg]   # (B, S, KV, hd)
        hv = caches[op.v_cache_region][page, pos % pg]
        valid = pos[None] < start[:, None]
    else:
        buf_k, buf_v = caches[op.k_cache_region], caches[op.v_cache_region]
        cache_len = buf_k.shape[1]
        ring = pos % cache_len
        hk = buf_k[slot][:, ring]                        # (B, S, KV, hd)
        hv = buf_v[slot][:, ring]
        valid = ((pos[None] < start[:, None])
                 & (pos[None] >= start[:, None] - cache_len))
    m = valid[:, None, :, None]                          # (B, 1, S, 1)
    k = torch.where(m, hk.transpose(1, 2).to(k.dtype), k)
    v = torch.where(m, hv.transpose(1, 2).to(v.dtype), v)
    out = flash_attention(q, k, v, causal=a.causal, window=a.window,
                          block_q=a.block_q, block_kv=a.block_kv, impl=impl)
    out = out.transpose(1, 2).reshape(B, S, a.heads * a.head_dim)
    return out, k, v


def _write_chunk_cache(caches: dict, op: ProgramOp, k, v,
                       slot: torch.Tensor, start: torch.Tensor,
                       stop: torch.Tensor, length: torch.Tensor) -> None:
    """Store a chunk's fresh K/V rows -- (B, KV, S, hd), rows ``[start,
    stop)`` per entry -- into the (slots, cache_len, KV, hd) regions, in
    place.  Contiguous regions take the chunk rows; the final chunk
    (``stop == length``) extends the write through the padded tail, so
    the region ends bitwise-equal to a whole prefill's full-row write.
    Window-sized regions take the ring layout: ring row ``j`` receives
    the latest chunk position ``p < min(stop, length)`` with ``p %
    cache_len == j``, and the first chunk seeds every ring row with
    fresh row 0 -- ``ring_positions``' duplicate-early-row rule."""
    for rid, val in ((op.k_cache_region, k), (op.v_cache_region, v)):
        buf = caches[rid]
        row = val.transpose(1, 2).to(buf.dtype)             # (B, S, KV, hd)
        B, S, cache_len = row.shape[0], row.shape[1], buf.shape[1]
        old = buf[slot]                                     # (B, cl, KV, hd)
        if cache_len == S:
            wstop = torch.where(stop >= length, S, stop)
            pos = torch.arange(S, device=row.device)
            m = (pos[None] >= start[:, None]) & (pos[None] < wstop[:, None])
            new = torch.where(m[..., None, None], row, old)
        else:
            wstop = torch.minimum(stop, length)
            j = torch.arange(cache_len, device=row.device)
            last = (wstop - 1)[:, None]
            p = j[None] + torch.div(last - j[None], cache_len,
                                    rounding_mode="floor") * cache_len
            written = (p >= start[:, None]) & (p < wstop[:, None])
            batch = torch.arange(B, device=row.device)[:, None]
            gathered = row[batch, p.clamp(0, S - 1).long()]
            seed = row[:, :1].expand(old.shape)
            base = torch.where((start == 0)[:, None, None, None], seed, old)
            new = torch.where(written[..., None, None], gathered, base)
        buf[slot] = new


def _write_chunk_cache_paged(caches: dict, op: ProgramOp, k, v,
                             slot: torch.Tensor, start: torch.Tensor,
                             stop: torch.Tensor, length: torch.Tensor,
                             write_from: torch.Tensor) -> None:
    """Paged chunk write: scatter the chunk rows through the slots'
    page-table rows, one row per scatter entry, in place.  Rows outside
    ``[max(start, write_from), stop)`` -- and on the final chunk every
    row past ``length``, zeroed as in the whole-prefill write -- land
    on the null page 0, so COW-shared prefix pages are never touched.
    int8 pools are refused upstream (``ProgramPair.chunk_blocker``)."""
    if op.k_scale_region is not None:
        raise NotImplementedError(
            "chunked prefill over int8 paged KV: page scales are "
            "whole-page decisions (see ProgramPair.chunk_blocker)")
    pg = op.attn.page_size
    pt_rows = caches[op.page_table_region][slot]         # (B, pages_per_slot)
    for rid, val in ((op.k_cache_region, k), (op.v_cache_region, v)):
        buf = caches[rid]                                # (n_pages, pg, KV, hd)
        row = val.transpose(1, 2)                        # (B, S, KV, hd)
        S = row.shape[1]
        pos = torch.arange(S, device=row.device)
        wstop = torch.where(stop >= length, S, stop)
        write = ((pos[None] >= torch.maximum(start, write_from)[:, None])
                 & (pos[None] < wstop[:, None]))
        keep = pos[None, :, None, None] < length[:, None, None, None]
        rowv = torch.where(keep, row, torch.zeros_like(row))
        page = torch.where(write, pt_rows[:, pos // pg],
                           torch.zeros_like(write, dtype=pt_rows.dtype))
        buf[page.long(), pos[None] % pg] = rowv.to(buf.dtype)


@torch.no_grad()
def run_prefill_chunk(program: Program, params, tokens: torch.Tensor,
                      state: ProgramState, slot, start, stop, length,
                      write_from=None, *, impl: str = "auto") -> torch.Tensor:
    """Execute the prefill Program for one *chunk* of each of B in-flight
    admissions -- rows ``[start[i], stop[i])`` of slot ``slot[i]`` --
    against the full (B, max_len) padded token buffers.

    ``slot`` / ``start`` / ``stop`` / ``length`` / ``write_from`` are
    (B,) int sequences (uploaded here) or int32 tensors on the state's
    device (as ``graphed_chunk_runner`` passes them, uploaded before its
    replay): ``length`` is each prompt's row count
    (``stop == length`` marks the final chunk) and ``write_from`` the
    paged shared-prefix redirect.  Each flash op substitutes the slot's
    cache rows below ``start`` (``_run_attention_chunk``), then writes
    the chunk rows back; ``lengths[slot]`` advances to ``stop``, in
    place.  Returns the logits (B, max_len, vocab); rows ``[start,
    stop)`` are the chunk's.  A full-prompt chunk is ``run_prefill``, bit
    for bit."""
    dev = state.lengths.device

    def vec(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=torch.int32)
        return torch.as_tensor(np.asarray(x), dtype=torch.int32, device=dev)
    slot, start, stop, length = vec(slot), vec(start), vec(stop), vec(length)
    write_from = (torch.zeros_like(start) if write_from is None
                  else vec(write_from))
    slot_idx = slot.long()
    regions: dict[int, torch.Tensor] = {program.input_region: tokens}
    for op in program.ops:
        if op.kernel == "flash_attention" and op.k_cache_region is not None:
            out, k, v = _run_attention_chunk(op, regions, state.caches,
                                             slot_idx, start, impl=impl)
            if op.page_table_region is not None:
                _write_chunk_cache_paged(state.caches, op, k, v, slot_idx,
                                         start, stop, length, write_from)
            else:
                _write_chunk_cache(state.caches, op, k, v, slot_idx, start,
                                   stop, length)
            regions[op.out_region] = out
            continue
        regions[op.out_region] = _run_op(op, regions[op.in_region], regions,
                                         params, impl=impl)
    state.lengths[slot_idx] = stop
    return regions[program.output_region]


def _run_decode_attention(op: ProgramOp, src, k_src, v_src, ck, cv, pos,
                          live, *, impl: str) -> torch.Tensor:
    """One decode_attention step against the cache buffers: RoPE the new
    q/k at each slot's absolute position, write the new K/V row at
    ``pos % cache_len`` in place (a dead slot rewrites its current row
    with itself), attend over the ring-valid rows.  Returns (B,
    heads*head_dim)."""
    from ..models.common import Rotary, apply_rope
    a = op.attn
    B = src.shape[0]
    q = src.reshape(B, a.heads, a.head_dim)
    k_new = k_src.reshape(B, a.kv_heads, a.head_dim)
    v_new = v_src.reshape(B, a.kv_heads, a.head_dim)
    if a.rope_theta:
        cos, sin = Rotary(a.head_dim, a.rope_theta).freqs(pos)
        q = apply_rope(q, cos[:, None], sin[:, None])
        k_new = apply_rope(k_new, cos[:, None], sin[:, None])
    cache_len = ck.shape[1]
    slot = torch.arange(B, device=ck.device)
    row = (pos % cache_len).long()
    keep = live[:, None, None]
    ck[slot, row] = torch.where(keep, k_new.to(ck.dtype), ck[slot, row])
    cv[slot, row] = torch.where(keep, v_new.to(cv.dtype), cv[slot, row])
    out = decode_attention(q, ck.transpose(1, 2), cv.transpose(1, 2),
                           kv_len=ring_kv_len(pos, cache_len), impl=impl)
    return out.reshape(B, a.heads * a.head_dim)


def _run_decode_attention_paged(op: ProgramOp, src, k_src, v_src,
                                caches: dict, pos, live, *,
                                impl: str) -> torch.Tensor:
    """Paged decode step: the new K/V row goes into the pool page the
    slot's table names for virtual row ``pos % cache_len`` (the ring
    rule through the table), in place, and attention reads every live
    page through ``paged_decode_attention``.  The host ``PagePool`` has
    made that page allocated and private (COW-forked if shared) before
    this runs; dead slots write to the null page 0, which nothing live
    reads.  An int8 pool rewrites the whole target page: its scale grows
    to admit the new row (``max(old, |row| / 127)``) and the page is
    requantized under it -- exact when the scale is unchanged."""
    from ..models.common import Rotary, apply_rope
    a = op.attn
    B = src.shape[0]
    pg = a.page_size
    pt = caches[op.page_table_region]
    ck, cv = caches[op.k_cache_region], caches[op.v_cache_region]
    quant = op.k_scale_region is not None
    ks = caches[op.k_scale_region] if quant else None
    vs = caches[op.v_scale_region] if quant else None
    cache_len = pt.shape[1] * pg
    q = src.reshape(B, a.heads, a.head_dim)
    k_new = k_src.reshape(B, a.kv_heads, a.head_dim)
    v_new = v_src.reshape(B, a.kv_heads, a.head_dim)
    if a.rope_theta:
        cos, sin = Rotary(a.head_dim, a.rope_theta).freqs(pos)
        q = apply_rope(q, cos[:, None], sin[:, None])
        k_new = apply_rope(k_new, cos[:, None], sin[:, None])
    row = (pos % cache_len).long()
    offs = row % pg
    page = pt.gather(1, (row // pg)[:, None])[:, 0].long()
    page = torch.where(live, page, torch.zeros_like(page))
    if not quant:
        ck[page, offs] = k_new.to(ck.dtype)
        cv[page, offs] = v_new.to(cv.dtype)
    else:
        batch = torch.arange(B, device=src.device)
        for pool, scales, new_row in ((ck, ks, k_new), (cv, vs, v_new)):
            old_scale = scales[page]
            amax = new_row.float().abs().amax(dim=(1, 2))
            new_scale = torch.maximum(old_scale, amax / 127.0)
            new_scale = torch.where(new_scale > 0, new_scale,
                                    torch.ones_like(new_scale))
            qp = int8_requantize_page(pool[page], old_scale, new_scale)
            qp[batch, offs] = torch.round(
                new_row.float() / new_scale[:, None, None]).clamp(
                    -127, 127).to(torch.int8)
            pool[page] = qp
            scales[page] = new_scale
    out = paged_decode_attention(q, ck, cv, pt,
                                 kv_len=ring_kv_len(pos, cache_len),
                                 k_scale=ks, v_scale=vs, impl=impl)
    return out.reshape(B, a.heads * a.head_dim)


@torch.no_grad()
def run_decode(program: Program, params, tokens: torch.Tensor,
               state: ProgramState, mask: torch.Tensor | None = None, *,
               impl: str = "auto") -> torch.Tensor:
    """Advance the occupied slots by one token through the decode
    Program.

    tokens: (slots,) int; mask: (slots,) bool occupancy (None = all
    occupied).  Each ``decode_attention`` op writes the new K/V row into
    the cache regions at ``position % cache_len`` and attends over
    ``ring_kv_len(position, cache_len)`` rows.  Unoccupied slots stay
    inert: their rows are rewritten with themselves and their length
    does not advance.  Updates the state in place; returns the logits
    (slots, vocab), garbage in the unoccupied rows."""
    regions: dict[int, torch.Tensor] = {program.input_region: tokens}
    pos = state.lengths
    live = (torch.ones(pos.shape, dtype=torch.bool, device=pos.device)
            if mask is None else mask.to(device=pos.device, dtype=torch.bool))
    for op in program.ops:
        regions[op.out_region] = _run_decode_op(
            op, regions[op.in_region], regions, params, state.caches, pos,
            live, impl=impl)
    state.lengths += live.to(torch.int32)
    return regions[program.output_region]


def _run_decode_op(op: ProgramOp, src, regions: dict, params,
                   caches: dict | None, pos, live, *, impl: str):
    """One op of a decode tick against the state's ``caches`` (written in
    place) at the slots' positions ``pos``; with ``caches=None``, one op
    of a stateless Program.  The one per-op dispatcher of ``run``,
    ``run_decode`` and ``trace_program``."""
    if op.kernel == "decode_attention" and op.page_table_region is None:
        return _run_decode_attention(
            op, src, regions[op.k_region], regions[op.v_region],
            caches[op.k_cache_region], caches[op.v_cache_region], pos, live,
            impl=impl)
    if op.kernel == "decode_attention":
        return _run_decode_attention_paged(
            op, src, regions[op.k_region], regions[op.v_region], caches,
            pos, live, impl=impl)
    if op.kernel in _FAMILY_KERNELS:
        return _run_family_op(op, src, params, caches, live=live, impl=impl)
    if op.kernel == "cross_attention" and caches is not None:
        return _run_cross_attention(op, src, caches, impl=impl)
    return _run_op(op, src, regions, params, impl=impl, pos=pos)


# --- CUDA-graph runners (the reference's jitted runners) ----------------------------
_GRAPHS_ON = True                    # cleared inside ``disable_graphs()``


@contextlib.contextmanager
def disable_graphs():
    """Inside, the graphed runners run every call eagerly, op by op --
    the counterpart of ``jax.disable_jit()``.  The eager side of a
    graphed-against-eager comparison runs under it."""
    global _GRAPHS_ON
    prev, _GRAPHS_ON = _GRAPHS_ON, False
    try:
        yield
    finally:
        _GRAPHS_ON = prev


def _graphable(device: torch.device) -> bool:
    """Graphs on the card; the CPU (the plain path) always runs eagerly."""
    return _GRAPHS_ON and device.type == "cuda"


def _counted_kernels() -> tuple:
    """Every kernel wrapper that counts its launches, in the attributes
    its ``counters`` names: integers, or dicts of them by path."""
    from ..kernels.conv2d.kernel import (conv2d_strips_cuda,
                                         conv2d_virtual_cuda)
    from ..kernels.decode_attention.kernel import (
        decode_attention_cuda, paged_decode_attention_cuda)
    from ..kernels.flash_attention.bwd_kernel import flash_attention_bwd_cuda
    from ..kernels.flash_attention.kernel import flash_attention_cuda
    from ..kernels.mamba2.kernel import mamba2_scan_cuda
    from ..kernels.matmul.kernel import matmul_cuda
    from ..kernels.rwkv6.kernel import wkv6_cuda
    return (conv2d_virtual_cuda, conv2d_strips_cuda, matmul_cuda,
            flash_attention_cuda, flash_attention_bwd_cuda,
            decode_attention_cuda, paged_decode_attention_cuda,
            mamba2_scan_cuda, wkv6_cuda)


def _counts(fn) -> dict:
    """A copy of one wrapper's counters, by name."""
    return {name: dict(c) if isinstance(c := getattr(fn, name), dict) else c
            for name in fn.counters}


def _combine(a: dict, b: dict, sign: int) -> dict:
    """Counters ``a + sign * b``, name by name and path by path."""
    return {name: {k: v + sign * b[name][k] for k, v in x.items()}
            if isinstance(x, dict) else x + sign * b[name]
            for name, x in a.items()}


def _set_counts(fn, counts: dict):
    for name, c in counts.items():
        if isinstance(c, dict):
            getattr(fn, name).update(c)
        else:
            setattr(fn, name, c)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _clone(out):
    """A fresh copy of a tensor, or of a dict or tuple of them."""
    if isinstance(out, dict):
        return {k: _clone(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_clone(v) for v in out)
    return out.clone()


class _Graph:
    """One captured call: the static input buffers it reads, the output
    it writes (a tensor, or a dict or tuple of them), and the kernel
    launches one replay makes.  State the call reads and writes in
    place (a ``ProgramState``, a training step's parameters and
    optimizer state) is not the graph's: it stays where it was when
    captured, and the caller keys the graph on its addresses.

    The wrappers' launch counters are Python integers bumped as each
    wrapper is called.  Capture runs the Python (so it bumps them) but
    launches nothing on the card, so the bumps are rolled back and kept
    as the graph's count; every replay adds that count, so a counter
    still counts kernel executions on the card."""

    def __init__(self, fn, inputs, store: "GraphStore"):
        self.inputs = [torch.empty_like(x) for x in inputs]
        before = [(kernel, _counts(kernel)) for kernel in _counted_kernels()]
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph, pool=store.pool):
                self.output = fn(*self.inputs)
        finally:
            # (kernel, the counters one replay adds)
            self.launches = []
            for kernel, then in before:
                added = _combine(_counts(kernel), then, -1)
                _set_counts(kernel, then)
                if added["launches"]:
                    self.launches.append((kernel, added))
        store.capture_seconds += time.perf_counter() - t0

    def __call__(self, inputs):
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x)
        self.graph.replay()
        for kernel, added in self.launches:
            _set_counts(kernel, _combine(_counts(kernel), added, 1))
        # Fresh tensors: the next replay rewrites the static output.
        return _clone(self.output)


class GraphStore:
    """The captured graphs of one engine -- one ``ProgramState``, one
    CNN parameter tree, or one training step -- sharing one memory pool;
    they replay in turn on one stream.  ``graphs`` maps a run's key to its ``_Graph``, or
    to None after the key's first (eager) call; ``capture_seconds``
    sums the capture times."""

    def __init__(self):
        self.graphs: dict = {}
        self.capture_seconds = 0.0
        self._pool = None

    @property
    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def run(self, key, fn, inputs, device: torch.device):
        """``fn(*inputs)`` on ``device``: eagerly the first time ``key``
        is seen (the call that builds the kernels and warms the
        allocator and cuBLAS), captured and replayed the second time,
        replayed from then on.  ``inputs`` may lie on the host; they are
        copied into the graph's static buffers on every call.  A capture
        that fails raises."""
        if key not in self.graphs:
            self.graphs[key] = None
            return fn(*(x.to(device) for x in inputs))
        graph = self.graphs[key]
        if graph is None:
            graph = self.graphs[key] = _Graph(
                fn, [x.to(device) for x in inputs], self)
        return graph(inputs)


def _lru(cache: collections.OrderedDict, key, make):
    value = cache.get(key)
    if value is None:
        value = cache[key] = make()
        while len(cache) > _RUNNERS_CAP:
            cache.popitem(last=False)
    else:
        cache.move_to_end(key)
    return value


_RUNNERS: "collections.OrderedDict" = collections.OrderedDict()
_RUNNERS_CAP = 64


def _shapes(inputs) -> tuple:
    return tuple((tuple(x.shape), x.dtype) for x in inputs)


class _StatefulRunner:
    """A graphed runner of a stateful Program run (``kind``: prefill,
    decode or chunk).  Its graphs live in the state's ``GraphStore``:
    they read and write the state's buffers where they lie and die with
    the state.  A graph is keyed by the input shapes and the addresses
    of the parameters it reads (another parameter tree is another
    graph)."""
    kind = ""

    def __init__(self, program: Program, impl: str):
        self.program, self.impl = program, impl

    def _run(self, params, state: ProgramState, inputs):
        def fn(*xs):
            return self.eager(params, state, *xs)
        dev = state.lengths.device
        if not _graphable(dev):
            return fn(*(x.to(dev) for x in inputs))
        key = (id(self.program), self.impl, self.kind, _shapes(inputs),
               tuple(t.data_ptr() for t in _leaves(params)))
        return state.graphs.run(key, fn, inputs, dev)


def _ints(*xs) -> list[torch.Tensor]:
    """Host ints, int sequences or int tensors as (n,) int32 tensors."""
    return [(x if isinstance(x, torch.Tensor)
             else torch.from_numpy(np.asarray(x, np.int32)))
            .to(torch.int32).reshape(-1) for x in xs]


class _PrefillRunner(_StatefulRunner):
    kind = "prefill"

    def __call__(self, params, tokens, state, slot, length, write_from=0):
        return self._run(params, state,
                         [tokens, *_ints(slot, length, write_from)])

    def eager(self, params, state, tokens, slot, length, write_from):
        return run_prefill(self.program, params, tokens, state, slot,
                           length, write_from, impl=self.impl)


class _DecodeRunner(_StatefulRunner):
    kind = "decode"

    def __call__(self, params, tokens, state, mask=None):
        if mask is None:
            mask = torch.ones(state.lengths.shape, dtype=torch.bool)
        return self._run(params, state, [tokens, mask.to(torch.bool)])

    def eager(self, params, state, tokens, mask):
        return run_decode(self.program, params, tokens, state, mask,
                          impl=self.impl)


class _ChunkRunner(_StatefulRunner):
    kind = "chunk"

    def __call__(self, params, tokens, state, slot, start, stop, length,
                 write_from=None):
        if write_from is None:
            write_from = np.zeros(len(start), np.int32)
        return self._run(params, state, [tokens, *_ints(
            slot, start, stop, length, write_from)])

    def eager(self, params, state, tokens, slot, start, stop, length,
              write_from):
        return run_prefill_chunk(self.program, params, tokens, state, slot,
                                 start, stop, length, write_from,
                                 impl=self.impl)


def graphed_prefill_runner(program: Program, impl: str = "auto"):
    """Graphed prefill: ``(params, tokens, state, slot, length[,
    write_from]) -> logits``, ``run_prefill``'s work with the state
    updated in place.  One graph per state at (1, max_len); ``slot`` /
    ``length`` / ``write_from`` (ints or tensors) are static inputs."""
    return _lru(_RUNNERS, (id(program), impl, "prefill"),
                lambda: _PrefillRunner(program, impl))


def graphed_decode_runner(program: Program, impl: str = "auto"):
    """Graphed decode tick: ``(params, tokens, state[, mask]) ->
    logits``, ``run_decode``'s work with the state updated in place --
    the serving hot loop.  One graph per state at (slots,); the tokens
    and the (slots,) occupancy mask (omitted: every slot live) are
    static inputs."""
    return _lru(_RUNNERS, (id(program), impl, "decode"),
                lambda: _DecodeRunner(program, impl))


def graphed_chunk_runner(program: Program, impl: str = "auto"):
    """Graphed chunk prefill: ``(params, tokens, state, slot, start,
    stop, length[, write_from]) -> logits``, ``run_prefill_chunk``'s
    work.  One graph per state and in-flight batch width B (as XLA
    re-specializes on the leading shape); the (B,) vectors, host or
    device, are uploaded into the static inputs before the replay."""
    return _lru(_RUNNERS, (id(program), impl, "chunk"),
                lambda: _ChunkRunner(program, impl))


class _Runner:
    """The graphed stateless run (the CNN Programs): one ``GraphStore``
    per parameter tree, keyed by its leaves' addresses, LRU-bounded."""

    def __init__(self, program: Program, impl: str):
        self.program, self.impl = program, impl
        self.stores: "collections.OrderedDict" = collections.OrderedDict()

    def store(self, params) -> GraphStore:
        """The graphs this runner captured against ``params``."""
        return _lru(self.stores,
                    tuple(t.data_ptr() for t in _leaves(params)), GraphStore)

    def __call__(self, params, x: torch.Tensor) -> torch.Tensor:
        def fn(x):
            return run(self.program, params, x, impl=self.impl)
        if not _graphable(x.device):
            return fn(x)
        return self.store(params).run(_shapes([x]), fn, [x], x.device)


def graphed_runner(program: Program, impl: str = "auto"):
    """One graphed executor per (Program, impl) -- the models' fast
    path, ``(params, x) -> output``: the first call of an input shape
    runs eagerly, the second is captured into a CUDA graph and replayed,
    later ones replay; on the CPU every call runs eagerly.  Keyed by
    program identity (a Program holds dicts, so it is not hashable); the
    cached runner keeps the program alive, so the id cannot be recycled
    while the entry exists.  LRU-bounded."""
    return _lru(_RUNNERS, (id(program), impl, "run"),
                lambda: _Runner(program, impl))


# --- paged KV runtime (host-side page allocator, §5.1 paged plan) ------------------
class PagePool:
    """Host-side allocator for a pair's §5.1 paged-KV plan.

    The compiler minted the *capacity* (``regions.paged_kv_specs``: pool
    shape, table shape, null page 0); this object owns the *assignment*
    -- a free list, per-page refcounts, and a host mirror of the device
    page table.  Admission, on-demand decode pages, COW forks and
    retirement are decided here between executor calls; the device sees
    only the decided table (``sync_page_table``) and whole-page copies
    (``apply_page_copies``).

    Refcounts are table-granular, shared by every block's pools: slot
    tables are the same across blocks, so one count per page id covers
    all of them.

    Invariants:

    * page 0 is never allocated -- it is the dense-scatter target for
      masked writes (dead slots, shared-prefix prefill rows);
    * a page a slot is about to *write* (``prepare_decode``) always has
      refcount 1 -- shared pages are forked first (copy-on-write);
    * a freed page returns to the free list only at refcount 0, so a
      donor's retirement never invalidates a sharer's prefix.
    """

    def __init__(self, plan: PagedPlan, slots: int):
        self.plan = plan
        self.slots = slots
        self.free: list[int] = list(range(plan.n_pages - 1, 0, -1))
        self.refcount = np.zeros(plan.n_pages, np.int32)
        self.table = np.zeros((slots, plan.pages_per_slot), np.int32)
        # True while the host table has edits the device copy has not
        # seen; ``sync_page_table`` clears it, so a steady decode tick
        # (its write row inside an owned page) transfers nothing.
        self.dirty = True

    @property
    def free_pages(self) -> int:
        return len(self.free)

    @property
    def used_pages(self) -> int:
        return int((self.refcount > 0).sum())

    def _alloc(self) -> int:
        if not self.free:
            raise RuntimeError(
                f"page pool exhausted ({self.plan.n_pages} pages, "
                f"page_size={self.plan.page_size}) — retire a slot or "
                f"compile with a larger page_pool")
        p = self.free.pop()
        self.refcount[p] = 1
        return p

    def _unref(self, p: int) -> None:
        self.refcount[p] -= 1
        if self.refcount[p] == 0:
            self.free.append(p)

    def can_admit(self, length: int, shared_pages: int = 0) -> bool:
        need = pages_for_len(length, self.plan.page_size) - shared_pages
        return need <= len(self.free)

    def admit(self, slot: int, length: int,
              shared: tuple[int, ...] = ()) -> int:
        """Map ``shared`` donor pages (the full-page common prefix, in
        order) into ``slot``'s table, allocate fresh pages for the rest
        of the ``length``-row prompt, and return ``write_from`` -- the
        first row the prefill must write (the shared row count)."""
        pg = self.plan.page_size
        need = pages_for_len(length, pg)
        shared = tuple(shared)[:need]
        row = np.zeros(self.plan.pages_per_slot, np.int32)
        for i, p in enumerate(shared):
            self.refcount[p] += 1
            row[i] = p
        for i in range(len(shared), need):
            row[i] = self._alloc()
        self.table[slot] = row
        self.dirty = True
        return len(shared) * pg

    def release(self, slot: int) -> None:
        """Retire a slot: unref every mapped page (freed at refcount 0)
        and null its table row, so re-admission starts clean."""
        for p in self.table[slot]:
            if p:
                self._unref(int(p))
        self.table[slot] = 0
        self.dirty = True

    def slot_pages(self, slot: int, length: int) -> tuple[int, ...]:
        """The slot's first ``pages_for_len(length)`` page ids -- what a
        donor exposes for prefix sharing."""
        n = pages_for_len(length, self.plan.page_size)
        return tuple(int(p) for p in self.table[slot, :n])

    def shared_prefix_pages(self, slot: int, donor_prompt: tuple,
                            prompt: tuple) -> tuple[int, ...]:
        """Donor pages covered by the common *full-page* prefix of
        ``donor_prompt`` and ``prompt`` (a partial page cannot be
        shared: the donor's rows past the common prefix live in it)."""
        pg = self.plan.page_size
        common = 0
        for a, b in zip(donor_prompt, prompt):
            if a != b:
                break
            common += 1
        return self.slot_pages(slot, (common // pg) * pg)

    def prepare_decode(self, slot: int, pos: int):
        """Make the page receiving the write at ``pos % cache_len``
        writable: allocate it if the table entry is still null, fork it
        (a fresh page the caller copies into) if shared.  Returns the
        (src, dst) copy a COW fork needs, else None."""
        pg = self.plan.page_size
        idx = (pos % self.plan.cache_len) // pg
        p = int(self.table[slot, idx])
        if p == 0:
            self.table[slot, idx] = self._alloc()
            self.dirty = True
            return None
        if self.refcount[p] > 1:
            fresh = self._alloc()
            self._unref(p)
            self.table[slot, idx] = fresh
            self.dirty = True
            return (p, fresh)
        return None


def paged_pool_regions(pair: ProgramPair) -> list[tuple]:
    """(k_pages, v_pages, k_scale, v_scale) region-id tuples of every
    paged decode op -- the buffers a COW fork copies (the scale ids are
    None for float pools)."""
    return [(op.k_cache_region, op.v_cache_region, op.k_scale_region,
             op.v_scale_region) for op in pair.decode.ops
            if op.kernel == "decode_attention"
            and op.page_table_region is not None]


def sync_page_table(state: ProgramState, pair: ProgramPair,
                    pool: PagePool) -> None:
    """Copy the host page table into the state's device table, in place;
    nothing moves when the table is unchanged since the last sync."""
    if not pool.dirty:
        return
    state.caches[pair.page_table_region].copy_(torch.from_numpy(pool.table))
    pool.dirty = False


def apply_page_copies(state: ProgramState, pair: ProgramPair,
                      copies) -> None:
    """Apply COW forks: copy pool page ``src -> dst`` (its rows and, for
    int8 pools, its scale) in every block's K and V pools, in place."""
    if not copies:
        return
    rids = [r for quad in paged_pool_regions(pair) for r in quad
            if r is not None]
    src = torch.tensor([c[0] for c in copies], dtype=torch.long)
    dst = torch.tensor([c[1] for c in copies], dtype=torch.long)
    for rid in rids:
        buf = state.caches[rid]
        buf[dst.to(buf.device)] = buf[src.to(buf.device)]


# --- trace recorder and sampled op timing ------------------------------------------
def _shape_dtype(x: torch.Tensor) -> list:
    """[shape, dtype] with numpy's dtype names, as the reference records."""
    return [list(x.shape), str(x.dtype).removeprefix("torch.")]


def _op_operands(op: ProgramOp, regions: dict, params,
                 caches: dict | None = None) -> dict:
    """role -> [shape, dtype] for everything the op touches."""
    out: dict[str, list] = {"in": _shape_dtype(regions[op.in_region])}
    for role, rid in (("k", op.k_region), ("v", op.v_region),
                      ("in2", op.in2_region)):
        if rid is not None:
            out[role] = _shape_dtype(regions[rid])
    if op.fuse_bypass and op.bypass_region is not None:
        out["bypass"] = _shape_dtype(regions[op.bypass_region])
    if op.param_key is not None:
        p = _param(params, op.param_key)
        if isinstance(p, dict) and "w" not in p:
            # Family ops (wkv / ssm_scan / moe_dispatch) carry a whole
            # block subtree, not a w/b pair: record its leaf count.
            out["param_dict"] = [[sum(1 for _ in _leaves(p))], "tree"]
        elif isinstance(p, dict):
            out["w"] = _shape_dtype(p["w"])
            if "b" in p:
                out["b"] = _shape_dtype(p["b"])
            out["param_dict"] = [[], "dict"]
        else:
            out["w"] = _shape_dtype(p)
            out["param_dict"] = [[], "array"]
    if op.param_key_b is not None:
        out["b"] = _shape_dtype(_param(params, op.param_key_b))
    if caches is not None and op.k_cache_region is not None:
        out["k_cache"] = _shape_dtype(caches[op.k_cache_region])
        out["v_cache"] = _shape_dtype(caches[op.v_cache_region])
    if caches is not None and op.state_regions:
        for j, rid in enumerate(op.state_regions):
            out[f"state{j}"] = _shape_dtype(caches[rid])
    return out


def _op_schedule(op: ProgramOp) -> dict:
    """The op's resolved schedule decisions, JSON-shaped: every field
    the kernels receive verbatim."""
    d: dict = {
        "strip_storage": op.strip_storage,
        "dataflow": op.dataflow.value if op.dataflow else None,
        "block": list(op.block) if op.block else None,
        "stride": op.stride, "pad": op.pad, "window": op.window,
        "fuse_bias": op.fuse_bias, "fuse_activation": op.fuse_activation,
        "fuse_bypass": op.fuse_bypass, "bypass_first": op.bypass_first,
        "fuse_pool": list(op.fuse_pool) if op.fuse_pool else None,
        "norm_kind": op.norm_kind, "flatten_input": op.flatten_input,
        "transpose_w": op.transpose_w,
    }
    if op.conv_tiling is not None:
        d["conv_tiling"] = dataclasses.asdict(op.conv_tiling)
    if op.attn is not None:
        a = op.attn
        d["attn"] = {"heads": a.heads, "kv_heads": a.kv_heads,
                     "head_dim": a.head_dim, "causal": a.causal,
                     "window": a.window, "rope_theta": a.rope_theta,
                     "block_q": a.block_q, "block_kv": a.block_kv,
                     "page_size": a.page_size}
    return d


@dataclass
class TraceRecord:
    """One executed ProgramOp: identity, resolved schedule, operand
    shapes, modeled cost and measured time.  ``measured_time_s`` (and
    ``repeats``) are the only run-to-run varying fields (``static_dict``
    drops them); the rest is a function of the Program and its inputs,
    equal to the reference's record of the same op."""
    index: int
    name: str
    kind: str                        # ProgramOp.kernel
    operands: dict
    schedule: dict
    flops: float
    traffic_bytes: float
    modeled_time_s: float
    measured_time_s: float | None = None
    repeats: int = 0
    # runtime operand values a replay needs beyond shapes: the decode
    # slots' positions and occupancy (kv_len drives the attention work).
    extras: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TraceRecord":
        return cls(**d)

    def static_dict(self) -> dict:
        d = self.to_dict()
        d.pop("measured_time_s")
        d.pop("repeats")
        return d


@dataclass
class ExecutorTrace:
    """A traced Program execution: one TraceRecord per op and what is
    needed to read the timings.  Serializes to JSONL (a meta header
    line, then one record per line), the reference's interchange
    format.  ``state`` (not serialized) is the copy of the
    ``ProgramState`` the walk advanced; the caller's state is left as it
    was."""
    program: str
    hw: str
    impl: str
    interpret: bool | None
    repeats: int
    records: list = field(default_factory=list)
    state: "ProgramState | None" = field(default=None, repr=False,
                                         compare=False)

    def record_dicts(self) -> list[dict]:
        return [r.to_dict() for r in self.records]

    def to_jsonl(self) -> str:
        meta = {"trace_meta": {"program": self.program, "hw": self.hw,
                               "impl": self.impl, "interpret": self.interpret,
                               "repeats": self.repeats}}
        lines = [json.dumps(meta)]
        lines += [json.dumps(d, sort_keys=True) for d in self.record_dicts()]
        return "\n".join(lines) + "\n"

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_jsonl())

    @classmethod
    def from_jsonl(cls, text: str) -> "ExecutorTrace":
        lines = [ln for ln in text.splitlines() if ln.strip()]
        meta = json.loads(lines[0])["trace_meta"]
        recs = [TraceRecord.from_dict(json.loads(ln)) for ln in lines[1:]]
        return cls(records=recs, **meta)

    @classmethod
    def load(cls, path) -> "ExecutorTrace":
        with open(path) as f:
            return cls.from_jsonl(f.read())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_thunk(thunk, repeats: int, device: torch.device,
                reset=None) -> float:
    """The host clock: min-of-``repeats`` seconds of ``thunk()``, each
    call between two device synchronises, so on the card the time is
    the eager dispatch of the op's Python plus its kernels; ``reset()``
    (untimed) puts back the state an op writes before each call.  The
    caller's first call was the warm-up."""
    best = float("inf")
    for _ in range(repeats):
        if reset is not None:
            reset()
        _sync(device)
        t0 = time.perf_counter()
        thunk()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


# Calls of an op captured in one graph by the device clock.
CLOCK_CALLS = 10


def graph_seconds(graph: torch.cuda.CUDAGraph) -> float:
    """Seconds of one replay of a captured CUDA graph, between two CUDA
    events on the current stream."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3


def device_times(thunk, calls: int, repeats: int, device: torch.device, *,
                 warmup: int = 0, reset=None) -> list[float]:
    """Seconds of one ``thunk()`` call on the card, one reading per
    replay: ``calls`` calls captured in one CUDA graph (after ``warmup``
    eager calls), the graph replayed ``repeats`` times, each between two
    CUDA events, and its time divided by ``calls``.  The host's launch
    latency is not in the reading, so a kernel shorter than its Python
    wrapper is timed, not the wrapper.  ``reset()`` (untimed, before
    each replay) puts back the state the calls write.  A thunk that
    cannot be captured (a host read, a synchronise) raises; there is no
    fallback to the host clock.  As for ``_Graph``, the launch counters
    count what the replays launch, not the capture."""
    if device.type != "cuda":
        raise ValueError(f"the device clock times CUDA work, not {device}")
    with torch.cuda.device(device):
        for _ in range(warmup):
            thunk()
        torch.cuda.synchronize(device)
        before = [(kernel, _counts(kernel)) for kernel in _counted_kernels()]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                for _ in range(calls):
                    thunk()
        finally:
            launched = []
            for kernel, then in before:
                added = _combine(_counts(kernel), then, -1)
                _set_counts(kernel, then)
                if added["launches"]:
                    launched.append((kernel, added))
        times = []
        for _ in range(repeats):
            if reset is not None:
                reset()
            times.append(graph_seconds(graph) / calls)
            for kernel, added in launched:
                _set_counts(kernel, _combine(_counts(kernel), added, 1))
        del graph
    return times


def _written_regions(op: ProgramOp) -> tuple:
    """The persistent regions a decode-side op writes in place."""
    if op.kernel == "decode_attention":
        return tuple(r for r in (op.k_cache_region, op.v_cache_region,
                                 op.k_scale_region, op.v_scale_region)
                     if r is not None)
    if op.kernel in _FAMILY_KERNELS:
        return tuple(op.state_regions)
    return ()


@torch.no_grad()
def trace_program(program: Program, params, x: torch.Tensor, *,
                  impl: str = "auto", repeats: int = 3, measure: bool = True,
                  clock: str = "host", state: ProgramState | None = None,
                  mask: torch.Tensor | None = None) -> ExecutorTrace:
    """Execute ``program`` op by op, eagerly, recording each op's
    resolved schedule, operand shapes, modeled cost and measured time.

    Opt-in (the fast path is the graphed runners).  Stateless Programs
    take (params, x); decode Programs also need ``state`` (and an
    optional occupancy ``mask``), and a ``decode_attention`` op's cache
    write is timed as part of it.  The walk runs on a copy of ``state``
    (returned advanced as ``run_decode`` would leave it, in
    ``trace.state``): the caller's tensors, which captured CUDA graphs
    read, are never touched.  Each op runs once, untimed, and that
    call's result is what the walk keeps; then it is timed ``repeats``
    times (``repeats >= 1``), each reading from the pre-op copy of the
    state it writes, so a repeat never advances a cache row or a
    recurrent state twice.  ``measure=False`` skips the timing
    (schema-only traces; ``repeats`` is then recorded as 0).

    ``clock``: ``"host"`` times each call between two device
    synchronises (``_time_thunk``: on the card, eager host dispatch plus
    the kernels); ``"device"`` captures ``CLOCK_CALLS`` calls in one CUDA
    graph and reads its replays between CUDA events
    (``device_times``), the kernels' own time -- the clock the tuner
    ranks and calibrates on.  Never called while a CUDA graph is
    captured.
    """
    if clock not in ("host", "device"):
        raise ValueError(f"clock must be host|device, got {clock!r}")
    if measure and repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    if measure and clock == "device" and not x.is_cuda:
        raise ValueError(f"the device clock times CUDA work; the input "
                         f"lies on {x.device}")
    if x.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("trace_program runs eagerly; it cannot run "
                           "inside a CUDA graph capture")
    is_decode = (any(op.kernel == "decode_attention" for op in program.ops)
                 or program.name.endswith(".decode"))
    if is_decode and state is None:
        raise ValueError("decode Programs need state=; see run_decode")
    regions: dict[int, torch.Tensor] = {program.input_region: x}
    work = caches = pos = live = None
    if state is not None:
        work = ProgramState({r: t.clone() for r, t in state.caches.items()},
                            state.lengths.clone())
        caches, pos = work.caches, work.lengths
        live = (torch.ones(pos.shape, dtype=torch.bool, device=pos.device)
                if mask is None
                else mask.to(device=pos.device, dtype=torch.bool))
    trace = ExecutorTrace(program=program.name, hw=program.hw_name,
                          impl=impl, interpret=None,
                          repeats=repeats if measure else 0, state=work)
    for op in program.ops:
        src = regions[op.in_region]
        written = (_written_regions(op)
                   if caches is not None and measure else ())
        before = {r: caches[r].clone() for r in written}

        def thunk(op=op, src=src):
            return _run_decode_op(op, src, regions, params, caches,
                                  pos if is_decode else None, live,
                                  impl=impl)

        def reset(before=before):
            for r, t in before.items():
                caches[r].copy_(t)

        out = thunk()
        measured = None
        if measure:
            after = {r: caches[r].clone() for r in written}
            if clock == "device":
                measured = min(device_times(thunk, CLOCK_CALLS, repeats,
                                            x.device, reset=reset))
            else:
                measured = _time_thunk(thunk, repeats, x.device, reset)
            for r, t in after.items():
                caches[r].copy_(t)
        regions[op.out_region] = out
        operands = _op_operands(op, regions, params, caches)
        operands["out"] = _shape_dtype(out)
        extras = {}
        if op.kernel == "decode_attention":
            extras = {"pos": [int(p) for p in pos.tolist()],
                      "live": [bool(b) for b in live.tolist()]}
        trace.records.append(TraceRecord(
            index=op.index, name=op.name, kind=op.kernel,
            operands=operands, schedule=_op_schedule(op),
            flops=op.flops, traffic_bytes=op.traffic_bytes,
            modeled_time_s=op.exec_time_s, measured_time_s=measured,
            repeats=repeats if measure else 0, extras=extras))
    if work is not None and is_decode:
        work.lengths += live.to(torch.int32)
    return trace


class OpTimingSampler:
    """Sampled op timing for serving ticks.

    Every ``every``-th ``tick()`` walks a decode Program once through
    ``trace_program`` (``REPEATS`` timed calls an op, after the untimed
    first) on a copy of a ``ProgramState`` and attributes the measured
    times to op kinds on the metrics plane (``op_time_us{kind=...}``
    histograms), plus one ``op_sample`` flight event per op, labelled
    with the ``role`` of the Program the tick ran ("target", or "draft"
    for a speculative tick's draft round).  The other ``every - 1``
    ticks cost one integer increment.  The walk reads the live state and
    writes only its copy, so the engine's caches, lengths and captured
    graphs are untouched; the engine samples before the sampled
    Program's call, outside any capture."""

    REPEATS = 1

    def __init__(self, every: int, registry=None, flight=None, *,
                 impl: str = "auto"):
        if every < 0:
            raise ValueError(f"sample cadence must be >= 0, got {every}")
        self.every = every
        self.registry = registry
        self.flight = flight
        self.impl = impl
        self.n_calls = 0
        self.n_samples = 0

    def tick(self, program: Program, params, tokens, *,
             state: ProgramState | None = None, mask=None,
             role: str = "target") -> ExecutorTrace | None:
        """Count one tick; on the sampled ones, trace and time the
        Program and feed the records to the metrics and flight planes.
        Returns the trace on sampled ticks, None otherwise."""
        if not self.every:
            return None
        self.n_calls += 1
        if self.n_calls % self.every:
            return None
        trace = trace_program(program, params, tokens, impl=self.impl,
                              repeats=self.REPEATS, state=state, mask=mask)
        self.n_samples += 1
        for rec in trace.records:
            if self.registry is not None:
                self.registry.histogram(
                    "op_time_us",
                    help="sampled per-op executor wallclock",
                    kind=rec.kind).observe(rec.measured_time_s * 1e6)
            if self.flight is not None:
                self.flight.event(
                    "op_sample", kind=rec.kind, name=rec.name,
                    role=role, index=rec.index, flops=rec.flops,
                    traffic_bytes=rec.traffic_bytes,
                    modeled_time_s=rec.modeled_time_s,
                    measured_time_s=rec.measured_time_s)
        return trace
