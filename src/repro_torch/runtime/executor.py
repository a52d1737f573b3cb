"""Program executor — runs the compiler's instruction stream (§5.2).

Counterpart of ``repro/runtime/executor.py`` for the CNN and dense-LM
Program paths: ``run`` walks a ``core/program.py::Program`` and
dispatches each op to the kernels with the schedule's *pre-resolved*
decisions — conv strip tiling, strip storage, loop order, matmul block,
attention (block_q, block_kv) and the fused epilogue flags.  Nothing is
re-derived at run time; region ids are the allocator's, read from the
ops.

Stateful Programs (the LM serving pair) add a ``ProgramState``: the
persistent KV-cache buffers keyed by the allocator's persistent region
ids, plus the per-slot sequence lengths.  ``run_prefill`` executes the
prefill Program for one admitted request and writes each block's K/V
into the cache regions at its slot; ``run_decode`` advances every slot
by one token through the ``decode_attention`` ops.  The reference
threads the state functionally and donates it to XLA; here both update
the state's tensors **in place**, on the device they live on.

PyTorch runs eagerly, so the reference's ``jitted_runner`` becomes
``cached_runner``: one closure per (Program, impl).  The kernels run on
the device the input lies on (``impl="auto"``).  Op kinds of the other
LM families raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass

import torch

from ..core.program import Program, ProgramOp, ProgramPair
from ..kernels.common import resolve_device
from ..kernels.conv2d import avgpool2d_ref, conv2d, maxpool2d_ref
from ..kernels.decode_attention import (decode_attention, ring_kv_len,
                                        ring_positions)
from ..kernels.flash_attention import flash_attention
from ..kernels.matmul import matmul

__all__ = ["run", "walk", "cached_runner", "ProgramState",
           "init_program_state", "run_prefill", "run_decode"]

# op kind -> the ROADMAP item that ports it
_NOT_PORTED = {"wkv": "A.9", "ssm_scan": "A.9", "moe_dispatch": "A.9",
               "cross_attention": "A.9"}


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


def _run_norm(op: ProgramOp, src: torch.Tensor, params) -> torch.Tensor:
    from ..models.common import layer_norm, rms_norm
    w = _param(params, op.param_key)
    if op.norm_kind == "layernorm":
        return layer_norm(src, w, _param(params, op.param_key_b))
    if op.norm_kind == "nonparametric":
        return layer_norm(src)
    return rms_norm(src, w)


def _run_op(op: ProgramOp, src: torch.Tensor, regions: dict, params, *,
            impl: str) -> torch.Tensor:
    """Dispatch one (stateless) op with its pre-resolved schedule."""
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
        return _param(params, op.param_key)[src]
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
    if op.kernel in _NOT_PORTED:
        raise NotImplementedError(
            f"op {op.name}: program kernel {op.kernel!r} is not ported to "
            f"repro_torch yet (ROADMAP {_NOT_PORTED[op.kernel]})")
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
        regions[op.out_region] = _run_op(op, regions[op.in_region], regions,
                                         params, impl=impl)
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


# --- stateful Programs (the LM serving prefill/decode pair) -----------------------
@dataclass
class ProgramState:
    """Runtime carrier for a Program pair's persistent regions.

    ``caches`` maps the allocator's persistent region ids to their
    buffers — (slots, cache_len, kv_heads, head_dim) per block and cache
    side, cache_len being max_len or the attention window; ``lengths``
    is the per-slot sequence length (int32), counting absolute tokens
    even once the ring has wrapped.  ``run_prefill`` and ``run_decode``
    update both in place."""

    caches: dict[int, torch.Tensor]
    lengths: torch.Tensor               # (slots,) int32


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
    slots = persistent[0].shape[0]
    return ProgramState(caches, torch.zeros((slots,), dtype=torch.int32,
                                            device=dev))


def _write_prefill_cache(caches: dict, op: ProgramOp, k, v, slot: int,
                         length: int) -> None:
    """Store a prefill op's per-head K/V — (1, KV, S, hd) — into the
    (slots, cache_len, KV, hd) cache regions at ``slot``, in place.  A
    window-sized region (cache_len < S) receives the ring layout through
    the shared ``ring_positions`` rule; every ring slot is written, so a
    re-admitted slot never keeps a dead request's rows."""
    for rid, val in ((op.k_cache_region, k), (op.v_cache_region, v)):
        buf = caches[rid]
        row = val[0].transpose(0, 1)                          # (S, KV, hd)
        S, cache_len = row.shape[0], buf.shape[1]
        if cache_len < S:
            row = row[ring_positions(length, cache_len, S, row.device)]
        buf[slot, :row.shape[0]] = row


@torch.no_grad()
def run_prefill(program: Program, params, tokens: torch.Tensor,
                state: ProgramState, slot: int, length: int, *,
                impl: str = "auto") -> torch.Tensor:
    """Execute the prefill Program for one admitted request.

    tokens: (1, max_len) int, the prompt right-padded (rows past
    ``length`` are masked downstream by the slot's length).  Writes each
    block's K/V into the persistent cache regions at ``slot`` and sets
    ``lengths[slot] = length``, in place.  Returns the logits (1,
    max_len, vocab)."""
    regions: dict[int, torch.Tensor] = {program.input_region: tokens}
    for op in program.ops:
        if op.kernel == "flash_attention" and op.k_cache_region is not None:
            out, k, v = _run_attention(op, regions, impl=impl,
                                       return_kv=True)
            _write_prefill_cache(state.caches, op, k, v, slot, length)
            regions[op.out_region] = out
            continue
        regions[op.out_region] = _run_op(op, regions[op.in_region], regions,
                                         params, impl=impl)
    state.lengths[slot] = length
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
        src = regions[op.in_region]
        if op.kernel == "decode_attention":
            regions[op.out_region] = _run_decode_attention(
                op, src, regions[op.k_region], regions[op.v_region],
                state.caches[op.k_cache_region],
                state.caches[op.v_cache_region], pos, live, impl=impl)
            continue
        regions[op.out_region] = _run_op(op, src, regions, params, impl=impl)
    state.lengths += live.to(torch.int32)
    return regions[program.output_region]


_RUNNERS: "collections.OrderedDict" = collections.OrderedDict()
_RUNNERS_CAP = 64


def cached_runner(program: Program, impl: str = "auto"):
    """One executor closure per (Program, impl) — the models' fast path.

    Keyed by program identity (a Program holds dicts, so it is not
    hashable); the cached closure keeps the program alive, so the id
    cannot be recycled while the entry exists.  LRU-bounded."""
    key = (id(program), impl)
    fn = _RUNNERS.get(key)
    if fn is None:
        def fn(params, x, _program=program):
            return run(_program, params, x, impl=impl)
        _RUNNERS[key] = fn
        while len(_RUNNERS) > _RUNNERS_CAP:
            _RUNNERS.popitem(last=False)
    else:
        _RUNNERS.move_to_end(key)
    return fn
