"""CNN models — the paper's own workloads (AlexNetOWT, ResNet18/50).

Counterpart of ``repro/models/cnn.py``.  The model makes *no*
scheduling decisions: ``to_graph`` lowers the config to the compiler IR,
the schedule compiler (core/schedule.py) decides strips / Mloop-Kloop /
strip storage / fusion, ``core/program.py`` lowers that schedule to an
executable ``Program`` with §5.1 memory regions, and ``forward``
compiles the Program once per (config, batch, hw, tuned-cache
generation) and executes it through ``runtime/executor.py``.  When a
tuned cache is active (``core/autotune.activate``) its measured
decisions and calibrated cost model are threaded into the compile.
"""
from __future__ import annotations

import functools

import torch

from ..configs.base import CNNConfig
from ..core.hw import TPU_V5E, HardwareModel
from ..core.ir import LayerKind, LayerNode, ModelGraph, conv_node, matmul_node
from ..core.program import Program, lower_to_program
from ..core.schedule import compile_model
from ..runtime.executor import graphed_runner
from .common import ParamDef

__all__ = ["param_defs", "forward", "reference_forward", "to_graph",
           "trace_shapes", "compile_program"]


def trace_shapes(cfg: CNNConfig) -> list[tuple[int, int, int]]:
    """(H, W, C) entering each layer; final output shape appended."""
    outs: list[tuple[int, int, int]] = []       # output shape per layer
    ins: list[tuple[int, int, int]] = []
    cur = (cfg.input_hw, cfg.input_hw, cfg.input_ch)
    for i, layer in enumerate(cfg.layers):
        src = outs[layer.input_of] if layer.input_of is not None else cur
        ins.append(src)
        h, w, c = src
        if layer.kind == "conv":
            h = (h + 2 * layer.pad - layer.k) // layer.stride + 1
            w = (w + 2 * layer.pad - layer.k) // layer.stride + 1
            c = layer.c_out
        elif layer.kind in ("maxpool", "avgpool"):
            h = (h + 2 * layer.pad - layer.k) // layer.stride + 1
            w = (w + 2 * layer.pad - layer.k) // layer.stride + 1
        elif layer.kind == "fc":
            h = w = 1
            c = layer.c_out
        cur = (h, w, c)
        outs.append(cur)
    return ins + [cur]


def param_defs(cfg: CNNConfig) -> dict:
    dt = cfg.tdtype
    shapes = trace_shapes(cfg)
    defs = {}
    for i, layer in enumerate(cfg.layers):
        h, w, c = shapes[i]
        if layer.kind == "conv":
            defs[f"layer_{i:02d}"] = {
                "w": ParamDef((layer.k, layer.k, c, layer.c_out),
                              (None, None, "embed", "ff"), dt),
                "b": ParamDef((layer.c_out,), ("ff",), dt, "zeros"),
            }
        elif layer.kind == "fc":
            defs[f"layer_{i:02d}"] = {
                "w": ParamDef((h * w * c, layer.c_out), ("embed", "ff"), dt),
                "b": ParamDef((layer.c_out,), ("ff",), dt, "zeros"),
            }
    return defs


def compile_program(cfg: CNNConfig, batch: int = 1,
                    hw: HardwareModel = TPU_V5E, *,
                    paper_faithful: bool = False) -> Program:
    """graph -> schedule -> regions -> Program, memoized per (config,
    batch, hw, paper_faithful, tuned-cache generation).  Every fusion /
    tiling / storage decision in the returned Program comes from
    ``compile_model``; when a tuned cache is active
    (``core/autotune.activate``), its entries for this config and batch
    are consulted before the analytic choosers and its calibrated cost
    model re-prices the schedule.  The generation in the memo key means
    a re-tune never serves a stale Program."""
    from ..core import autotune
    return _compile_program(cfg, batch, hw, paper_faithful,
                            autotune.active_generation())


@functools.lru_cache(maxsize=128)
def _compile_program(cfg: CNNConfig, batch: int, hw: HardwareModel,
                     paper_faithful: bool, generation: str) -> Program:
    from ..core import autotune
    tuned, cost_model = autotune.tuned_context(cfg.name, batch, hw)
    graph = to_graph(cfg, batch=batch, dtype_bytes=cfg.tdtype.itemsize)
    schedule = compile_model(graph, hw, paper_faithful=paper_faithful,
                             tuned=tuned, cost_model=cost_model)
    return lower_to_program(graph, schedule)


def forward(params, x, cfg: CNNConfig, *, impl: str = "auto",
            hw: HardwareModel = TPU_V5E):
    """x: (B, H, W, C) -> logits (B, n_classes).

    Compiles the config to a ``Program`` (cached) and executes it; the
    schedule's fusion and tiling flags drive the kernel calls — this
    function decides nothing itself.  The kernels run where ``x`` lies;
    on the card the run replays a CUDA graph (``graphed_runner``).
    """
    program = compile_program(cfg, batch=x.shape[0], hw=hw)
    runner = graphed_runner(program, impl=impl)
    return runner(params, x.to(cfg.tdtype))


@torch.no_grad()
def reference_forward(params, x, cfg: CNNConfig):
    """Unfused oracle: every layer as its own reference op, nothing
    scheduled, every intermediate materialized — the pre-Program
    semantics the parity tests compare the compiled Program against.
    Not a decision path: it executes the config literally."""
    from ..kernels.conv2d import avgpool2d_ref, conv2d_ref, maxpool2d_ref
    outputs: dict[int, torch.Tensor] = {}
    h = x.to(cfg.tdtype)
    for i, layer in enumerate(cfg.layers):
        src = outputs[layer.input_of] if layer.input_of is not None else h
        if layer.kind == "conv":
            p = params[f"layer_{i:02d}"]
            byp = (outputs.get(layer.bypass_of)
                   if layer.bypass_of is not None else None)
            h = conv2d_ref(src, p["w"], stride=layer.stride, pad=layer.pad,
                           bias=p["b"], activation=layer.activation,
                           bypass=byp, bypass_first=layer.bypass_first)
        elif layer.kind == "maxpool":
            h = maxpool2d_ref(src, window=layer.k, stride=layer.stride,
                              pad=layer.pad)
        elif layer.kind == "avgpool":
            h = avgpool2d_ref(src, window=layer.k, stride=layer.stride,
                              pad=layer.pad)
        elif layer.kind == "fc":
            p = params[f"layer_{i:02d}"]
            h = src.reshape(src.shape[0], -1) @ p["w"] + p["b"]
            if layer.activation == "relu":
                h = torch.relu(h)
        outputs[i] = h
    return h


def to_graph(cfg: CNNConfig, batch: int = 1,
             dtype_bytes: int = 2) -> ModelGraph:
    """Lower to the compiler IR (paper §5.1 steps 1-2).

    Pure lowering: dependency labelling and conv->pool fusion are the
    compiler's job (``mark_residuals`` / ``mark_pool_fusion`` inside
    ``compile_model``); the nodes carry the geometry and the execution
    metadata (param group, bypass order, pool window) the Program
    lowering needs.
    """
    g = ModelGraph(cfg.name)
    shapes = trace_shapes(cfg)
    prev_name = None
    names: dict[int, str] = {}
    for i, layer in enumerate(cfg.layers):
        h, w, c = shapes[i]
        name = f"{layer.kind}_{i:02d}"
        inp = (names[layer.input_of] if layer.input_of is not None
               else (prev_name or ""))
        inputs = [inp] if inp else []
        if layer.kind == "conv":
            g.add(conv_node(
                name, h, w, c, layer.c_out, layer.k, layer.k,
                stride=layer.stride, pad=layer.pad, batch=batch,
                dtype_bytes=dtype_bytes, inputs=inputs,
                bypass_of=names.get(layer.bypass_of)
                if layer.bypass_of is not None else None,
                fused_activation=layer.activation,
                param=f"layer_{i:02d}", bypass_first=layer.bypass_first))
        elif layer.kind in ("maxpool", "avgpool"):
            oh = (h + 2 * layer.pad - layer.k) // layer.stride + 1
            g.add(LayerNode(name=name, kind=LayerKind.POOL,
                            dims={"numel": batch * oh * oh * c},
                            dtype_bytes=dtype_bytes, inputs=inputs,
                            meta={"op": ("avg" if layer.kind == "avgpool"
                                         else "max"),
                                  "window": layer.k, "stride": layer.stride,
                                  "pad": layer.pad}))
        elif layer.kind == "fc":
            g.add(matmul_node(name, batch, h * w * c, layer.c_out,
                              dtype_bytes=dtype_bytes, inputs=inputs,
                              fused_bias=True,
                              fused_activation=layer.activation,
                              param=f"layer_{i:02d}", flatten_input=True))
        names[i] = name
        prev_name = name
    return g
