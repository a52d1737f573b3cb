"""Public conv2d wrapper: schedule lookup, strip-storage dispatch, and
the fused-pool rules (counterpart of ``repro/kernels/conv2d/ops.py``).

The default kernel path is the **zero-copy** one: the CUDA kernel reads
the whole unpadded maps and each output-row strip gathers its input
window itself.  ``fuse_pool=(window, stride[, pad[, op]])`` fuses a
following max or avg pool into the epilogue; with a bypass the conv runs
with its bypass in the kernel and the pool follows as a separate plain
op, as in the reference.  ``strip_offsets="prefetch"`` hands the kernel
a device table of strip input rows in place of the affine offsets.

``strip_storage="materialized"`` (or a tiling that says so, as every
paper-faithful or SNOWFLAKE Program does) is the paper's scheme: the
halo-augmented strips are copied into device memory
(``materialize_strips``) and ``conv2d_strips_cuda`` convolves them; a
requested pool runs after it as a separate plain op.  On a CPU tensor
every storage runs the plain oracle, as the reference's "reference"
path does: storage makes no difference to the numbers.
"""
from __future__ import annotations

import torch

from ...core.dataflow import Dataflow, choose_conv_dataflow
from ...core.hw import TPU_V5E
from ...core.tiling import ConvTiling, select_conv_row_strips
from ..common import use_kernel
from .kernel import (conv2d_strips_cuda, conv2d_virtual_cuda,
                     materialize_strips, pool_ref, prefetch_row_starts,
                     strip_bypass, strips_geometry, unstrip,
                     virtual_geometry)
from .ref import conv2d_ref

__all__ = ["conv2d", "norm_pool", "strips_plan", "virtual_plan"]


def norm_pool(fuse_pool):
    """Normalize to (window, stride, pad, op): pad defaults to 0, op to
    "max" (matching core/ir.py's fused_pool meta)."""
    if fuse_pool is None:
        return None
    fp = tuple(fuse_pool)
    if len(fp) == 2:
        fp = fp + (0,)
    if len(fp) == 3:
        fp = fp + ("max",)
    if fp[3] not in ("max", "avg"):
        raise ValueError(f"fuse_pool op must be max|avg, got {fp[3]!r}")
    return fp


def conv2d(x, w, *, stride: int = 1, pad: int = 0, bias=None,
           activation: str | None = None, bypass=None,
           bypass_first: bool = False,
           impl: str = "auto", dataflow: Dataflow | None = None,
           strip_storage: str = "auto",
           fuse_pool: tuple | None = None,
           strip_offsets: str = "affine",
           tiling: ConvTiling | None = None) -> torch.Tensor:
    """x: (B, H, W, Cin); w: (kh, kw, Cin, Cout); bypass broadcastable to
    the conv output (B, OH, OW, Cout).

    impl: "auto" (kernel on a CUDA tensor, plain version on a CPU one) |
    "cuda" | "reference".  strip_storage: "auto" (the tiling's decision)
    | "virtual" (zero-copy) | "materialized" (strips copied into device
    memory, paper-faithful).  strip_offsets: "affine" | "prefetch" (the
    zero-copy kernel reads its strip rows from a device table).  tiling:
    the schedule's resolved ``ConvTiling`` (as a ``core/program.py`` op
    carries it); when given, no tiling is re-derived here; without one
    the tiling is chosen for ``TPU_V5E``, the hardware the port's
    Programs are compiled for.  The kernels take f32 or bf16 operands,
    all of x's type.
    """
    if strip_storage not in ("auto", "virtual", "materialized"):
        raise ValueError(f"strip_storage must be auto|virtual|materialized, "
                         f"got {strip_storage!r}")
    if strip_offsets not in ("affine", "prefetch"):
        raise ValueError(f"strip_offsets must be affine|prefetch, "
                         f"got {strip_offsets!r}")
    pool = norm_pool(fuse_pool)
    if not use_kernel(impl, x):
        out = conv2d_ref(x, w, stride=stride, pad=pad, bias=bias,
                         activation=activation, bypass=bypass,
                         bypass_first=bypass_first)
        if pool is not None:
            out = pool_ref(out, pool)
        return out

    ct = tiling if tiling is not None else select_conv_row_strips(
        *x.shape[1:], w.shape[3], w.shape[0], w.shape[1], stride, pad,
        x.element_size(), TPU_V5E, batch=x.shape[0])
    storage = ct.strip_storage if strip_storage == "auto" else strip_storage
    kw = dict(bias=bias, activation=activation, bypass_first=bypass_first)
    if storage != "virtual":
        g, dataflow = strips_plan(
            tuple(x.shape), tuple(w.shape), stride=stride, pad=pad,
            tiling=ct, dataflow=dataflow, dtype_bytes=x.element_size())
        byp = None if bypass is None else strip_bypass(bypass, g)
        out = unstrip(conv2d_strips_cuda(
            materialize_strips(x, g), w.contiguous(), g, bypass=byp,
            dataflow=dataflow, **kw), g)
        return out if pool is None else pool_ref(out, pool)

    g, dataflow, post_pool = virtual_plan(
        tuple(x.shape), tuple(w.shape), stride=stride, pad=pad, pool=pool,
        has_bypass=bypass is not None, tiling=ct, dataflow=dataflow,
        dtype_bytes=x.element_size())
    byp = None
    if bypass is not None:
        byp = bypass.expand(g.B, g.OH, g.OW, g.Cout).contiguous()
    row_starts = (prefetch_row_starts(g, x.device)
                  if strip_offsets == "prefetch" else None)
    out = conv2d_virtual_cuda(x.contiguous(), w.contiguous(), g, bypass=byp,
                              dataflow=dataflow, row_starts=row_starts, **kw)
    return out if post_pool is None else pool_ref(out, post_pool)


def strips_plan(x_shape, w_shape, *, stride: int, pad: int,
                tiling: ConvTiling, dataflow: Dataflow | None,
                dtype_bytes: int = 4):
    """The materialized kernel call for one conv: its geometry and its
    dataflow (the schedule's, else the chooser's with
    ``strip_storage="materialized"``, as ``_conv2d_materialized``
    derives it).  Returns (StripsGeometry, Dataflow)."""
    g = strips_geometry(x_shape, w_shape, stride=stride, pad=pad,
                        out_rows=tiling.out_rows,
                        kpt=tiling.kernels_per_tile)
    if dataflow is None:
        by = dtype_bytes
        dataflow, _, _ = choose_conv_dataflow(
            g.B * g.H * g.W * g.Cin * by, g.Cin * g.kh * g.kw * g.Cout * by,
            g.B * g.OH * g.OW * g.Cout * by,
            n_map_tiles=g.NS, n_kernel_tiles=g.Cout // g.kpt,
            overlap_frac=tiling.overlap_frac, strip_storage="materialized")
    return g, dataflow


def virtual_plan(x_shape, w_shape, *, stride: int, pad: int, pool,
                 has_bypass: bool, tiling: ConvTiling,
                 dataflow: Dataflow | None, dtype_bytes: int = 4):
    """The zero-copy kernel call for one conv: its geometry, its
    dataflow (the schedule's, else the chooser's as the reference
    derives it) and the pool left to run as a separate plain op (a
    fused pool with a bypass: the kernel folds the residual add, the
    pool follows).  Returns (VirtualGeometry, Dataflow, pool or None)."""
    post_pool = None
    if pool is not None and has_bypass:
        pool, post_pool = None, pool
    g = virtual_geometry(x_shape, w_shape, stride=stride, pad=pad,
                         out_rows=tiling.out_rows,
                         kpt=tiling.kernels_per_tile, pool=pool)
    if dataflow is None:
        by = dtype_bytes
        dataflow, _, _ = choose_conv_dataflow(
            g.B * g.H * g.W * g.Cin * by, g.Cin * g.kh * g.kw * g.Cout * by,
            g.B * g.OHo * g.OWo * g.Cout * by,
            n_map_tiles=g.B * g.n_strips, n_kernel_tiles=g.Cout // g.kpt,
            overlap_frac=tiling.overlap_frac, strip_storage="virtual")
    return g, dataflow, post_pool
