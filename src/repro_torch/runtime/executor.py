"""Program executor — runs the compiler's instruction stream (§5.2).

Counterpart of ``repro/runtime/executor.py`` for the CNN Program path:
``run`` walks a ``core/program.py::Program`` and dispatches each op to
the kernels with the schedule's *pre-resolved* decisions — conv strip
tiling, strip storage, loop order, matmul block and the fused epilogue
flags.  Nothing is re-derived at run time; region ids are the
allocator's, read from the ops.

PyTorch runs eagerly, so the reference's ``jitted_runner`` becomes
``cached_runner``: one closure per (Program, impl).  The kernels run on
the device ``x`` lies on (``impl="auto"``).  The LM op kinds and the
stateful prefill/decode Programs are not ported yet; their ops raise
``NotImplementedError`` naming the ROADMAP item.
"""
from __future__ import annotations

import collections

import torch

from ..core.program import Program, ProgramOp
from ..kernels.conv2d import avgpool2d_ref, conv2d, maxpool2d_ref
from ..kernels.matmul import matmul

__all__ = ["run", "walk", "cached_runner"]

# op kind -> the ROADMAP item that ports it
_NOT_PORTED = {
    "flash_attention": "A.5", "embed": "A.5", "norm": "A.5", "mul": "A.5",
    "decode_attention": "A.6", "wkv": "A.9", "ssm_scan": "A.9",
    "moe_dispatch": "A.9", "cross_attention": "A.9",
}


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
    """Execute ``program`` against ``params`` on input ``x``
    ((B, H, W, C) images for CNN programs).  Returns the final op's
    output (the tensor living in ``program.output_region``)."""
    regions: dict[int, torch.Tensor] = {program.input_region: x}
    for op in program.ops:
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
