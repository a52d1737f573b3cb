"""Row-strip conv2d: the two Hopper kernels and their plain versions.

``conv2d_virtual_cuda`` replaces
``repro/kernels/conv2d/kernel.py::conv2d_virtual_pallas`` (its
``pallas_call`` at lines 342/346).  It computes the same function: an
implicit-GEMM conv over NHWC maps with the fused epilogue bias -> bypass
if ``bypass_first`` -> activation -> bypass otherwise, then an optional
fused max or avg pool, with strip ``s`` owning output rows
``[s*SR, (s+1)*SR)``.  The source is ``csrc/conv2d.cu``; its header
says how a TPU strip block is cut into Hopper CTA tiles.

What bounds it on an H100: at batch 8 the alexnet-owt convs do 176-953
f32 FLOP per byte they must move and resnet18's 3x3 convs 93-332, far
above the card's f32 ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte),
so arithmetic bounds them; only resnet18's 1x1 stride-2 projections
(11-35 FLOP/byte) sit near the ridge.  This first kernel is a
register-tiled SIMT GEMM (no tensor cores); it reads the unpadded maps,
so no padded copy of the maps is made.

``virtual_geometry`` is the one pure-Python home of the strip extents
``repro/kernels/conv2d/ops.py:152-174`` derives (``out_rows`` rounded to
the pool stride, ``rows_c``, ``top_pad``, ``n_strips``, the pooled
extents), so the CPU tests hold them against the reference's.
``conv2d_virtual_plain`` computes the same output with PyTorch ops; the
CPU path and the on-card comparisons use it.  With ``row_starts`` (the
reference's ``strip_offsets="prefetch"``) each CTA reads its strip's
input row from a device table instead of the affine ``s * out_rows *
stride``, as the TPU kernel reads its scalar-prefetched table.

``conv2d_strips_cuda`` replaces
``repro/kernels/conv2d/kernel.py::conv2d_strips_pallas`` (its
``pallas_call`` at line 163), the paper-faithful baseline: the same
implicit GEMM and epilogue over halo-augmented row strips that
``materialize_strips`` has already copied into device memory,
(B*NS, in_rows, Wp, Cin) -> (B*NS, out_rows, OW, Cout).  Its source is
``csrc/conv2d_strips.cu``.  ``strips_geometry`` carries the reference's
strip extents and bottom-pad rule (``repro/kernels/conv2d/ops.py:
204-240``), which differ from the zero-copy path's; ``strip_bypass``
and ``unstrip`` are the reshapes around the call.  The copy is the
point of the baseline (Snowflake's DMA needs single-burst strips), so
it is a real device copy, never a view.  What bounds the kernel is what
bounds the zero-copy one (arithmetic), plus reading the strip buffer,
``1 + overlap_frac`` times the maps; ``conv2d_strips_plain`` is a pad-0
conv of each strip followed by the same epilogue.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ...core.dataflow import Dataflow
from ...core.ir import pool_out
from ..common import ACT_CODES, check_launch, load_library
from .ref import avgpool2d_ref, conv2d_ref, maxpool2d_ref

__all__ = ["VirtualGeometry", "virtual_geometry", "conv2d_virtual_cuda",
           "conv2d_virtual_plain", "pool_ref", "prefetch_row_starts",
           "StripsGeometry", "strips_geometry", "materialize_strips",
           "strip_bypass", "unstrip", "conv2d_strips_cuda",
           "conv2d_strips_plain"]

MAX_STAGE = 256           # conv pixels a pooled CTA tile stages (csrc)
_POOL_CODES = {None: 0, "max": 1, "avg": 2}


@dataclass(frozen=True)
class VirtualGeometry:
    """Strip extents of one zero-copy conv, as the reference passes them
    to ``conv2d_virtual_pallas``.  ``xp`` there is the maps padded to
    (B, Hp, Wp, Cin) with ``top_pad`` rows on top; the CUDA kernel reads
    the unpadded maps and treats those rows as zeros instead."""
    B: int
    H: int
    W: int
    Cin: int
    Cout: int
    kh: int
    kw: int
    stride: int
    pad: int
    out_rows: int          # conv rows a strip owns (before the pool)
    kpt: int               # kernels per tile (divides Cout)
    OH: int
    OW: int
    n_strips: int
    pool: tuple | None     # (window, stride, pad, "max"|"avg")
    rows_c: int            # conv rows a strip computes
    SR: int                # output rows a strip writes
    OHo: int
    OWo: int
    top_pad: int
    Hp: int
    Wp: int

    @property
    def in_rows(self) -> int:
        return (self.rows_c - 1) * self.stride + self.kh

    def cuda_tile(self) -> tuple[int, int]:
        """(tile_r, tile_c) pooled outputs per CTA with a fused pool: the
        widest tile whose conv region fits ``MAX_STAGE`` pixels."""
        if self.pool is None:
            return (0, 0)
        pw, ps = self.pool[0], self.pool[1]
        if pw * pw > MAX_STAGE:
            raise ValueError(f"fused pool window {pw} exceeds the CUDA "
                             f"kernel's {MAX_STAGE}-pixel stage")
        conv = lambda n: (n - 1) * ps + pw
        tile_c = min(self.OWo, 8)
        while tile_c > 1 and conv(tile_c) * pw > MAX_STAGE:
            tile_c -= 1
        tile_r = min(self.SR, 16)
        while tile_r > 1 and conv(tile_r) * conv(tile_c) > MAX_STAGE:
            tile_r -= 1
        return tile_r, tile_c


def virtual_geometry(x_shape, w_shape, *, stride: int, pad: int,
                     out_rows: int, kpt: int, pool=None) -> VirtualGeometry:
    """Strip extents for x (B, H, W, Cin), w (kh, kw, Cin, Cout), the
    schedule's ``out_rows`` / ``kpt`` and an optional normalized
    ``pool`` (window, stride, pad, op) — ``repro``'s ``conv2d`` rules:
    ``kpt`` is lowered until it divides Cout; with a pool, ``out_rows``
    is rounded to a multiple of the pool stride, each strip computes
    ``pw - ps`` extra conv rows, and ``top_pad`` grows by ``pp*stride``
    phantom rows for the pool's top padding."""
    B, H, W, Cin = x_shape
    kh, kw, _, Cout = w_shape
    OH = (H + 2 * pad - kh) // stride + 1
    OW = (W + 2 * pad - kw) // stride + 1
    while Cout % kpt != 0:
        kpt -= 1
    top_pad = pad
    if pool is None:
        rows_c, SR, OHo, OWo = out_rows, out_rows, OH, OW
        n_strips = math.ceil(OH / out_rows)
    else:
        pw, ps, pp, _ = pool
        out_rows = max(ps, (out_rows // ps) * ps)   # strips own whole windows
        rows_c = out_rows + pw - ps
        SR = out_rows // ps
        OHo = pool_out(OH, pw, ps, pp)
        OWo = pool_out(OW, pw, ps, pp)
        if OHo < 1 or OWo < 1:
            raise ValueError(
                f"fuse_pool window {pw} (pad {pp}) does not fit the "
                f"{OH}x{OW} conv output")
        n_strips = math.ceil(OHo / SR)
        top_pad = pad + pp * stride      # phantom rows for the pool's top pad
    in_rows = (rows_c - 1) * stride + kh
    Hp_needed = (n_strips - 1) * out_rows * stride + in_rows
    Hp = H + top_pad + max(0, Hp_needed - H - top_pad)
    return VirtualGeometry(
        B=B, H=H, W=W, Cin=Cin, Cout=Cout, kh=kh, kw=kw, stride=stride,
        pad=pad, out_rows=out_rows, kpt=kpt, OH=OH, OW=OW,
        n_strips=n_strips, pool=None if pool is None else tuple(pool),
        rows_c=rows_c, SR=SR, OHo=OHo, OWo=OWo, top_pad=top_pad, Hp=Hp,
        Wp=W + 2 * pad)


def prefetch_row_starts(g: VirtualGeometry, device) -> torch.Tensor:
    """The ``strip_offsets="prefetch"`` table: strip ``s``'s first input
    row in the padded maps, ``s * out_rows * stride``, as int32 on
    ``device`` (the reference builds the same ``row_starts``)."""
    return torch.arange(g.n_strips, dtype=torch.int32, device=device) * (
        g.out_rows * g.stride)


def pool_ref(out: torch.Tensor, pool) -> torch.Tensor:
    """A (window, stride, pad, op) pool as its own plain op."""
    pw, ps, pp, op = pool
    ref = avgpool2d_ref if op == "avg" else maxpool2d_ref
    return ref(out, window=pw, stride=ps, pad=pp)


def conv2d_virtual_plain(x, w, g: VirtualGeometry, *, bias=None,
                         activation: str | None = None, bypass=None,
                         bypass_first: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch ops: the conv oracle, then
    the pool as its own op.  Returns (B, OHo, OWo, Cout)."""
    out = conv2d_ref(x, w, stride=g.stride, pad=g.pad, bias=bias,
                     activation=activation, bypass=bypass,
                     bypass_first=bypass_first)
    return out if g.pool is None else pool_ref(out, g.pool)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def launch_args(x, w, g: VirtualGeometry, out, *, bias=None,
                activation: str | None = None, bypass=None,
                bypass_first: bool = False,
                dataflow: Dataflow = Dataflow.MAPS_RESIDENT,
                row_starts=None) -> list:
    """Checks the operands and returns ``conv2d_virtual_f32``'s arguments
    after the six pointers' tensors and before the stream."""
    if g.pool is not None and bypass is not None:
        raise ValueError("fused pool is not combinable with bypass")
    if row_starts is not None and (
            tuple(row_starts.shape) != (g.n_strips,)
            or row_starts.dtype != torch.int32
            or not row_starts.is_contiguous()
            or row_starts.device != x.device):
        raise TypeError(f"conv2d_virtual_cuda: row_starts must be a "
                        f"contiguous int32 ({g.n_strips},) on {x.device}")
    want = {"x": (x, (g.B, g.H, g.W, g.Cin)),
            "w": (w, (g.kh, g.kw, g.Cin, g.Cout)),
            "out": (out, (g.B, g.OHo, g.OWo, g.Cout))}
    if bias is not None:
        want["bias"] = (bias, (g.Cout,))
    if bypass is not None:
        want["bypass"] = (bypass, (g.B, g.OH, g.OW, g.Cout))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise TypeError(f"conv2d_virtual_cuda: {name} must be float32 "
                            f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"conv2d_virtual_cuda: {name} must be "
                             f"contiguous on {x.device}")
    pw, ps, pp, op = g.pool if g.pool is not None else (0, 0, 0, None)
    tile_r, tile_c = g.cuda_tile()
    return [g.B, g.H, g.W, g.Cin, g.kh, g.kw, g.Cout, g.stride, g.pad,
            g.out_rows, g.OH, g.OW, g.n_strips, g.kpt, pw, ps, pp,
            _POOL_CODES[op], g.SR, g.OHo, g.OWo, tile_r, tile_c,
            ACT_CODES[activation], int(bypass_first),
            int(dataflow is Dataflow.WEIGHTS_RESIDENT)]


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 26 + [ctypes.c_void_p]


def _launcher():
    lib = load_library("conv2d")
    fn = lib.conv2d_virtual_f32
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return lib, fn


def conv2d_virtual_cuda(x, w, g: VirtualGeometry, *, bias=None,
                        activation: str | None = None, bypass=None,
                        bypass_first: bool = False,
                        dataflow: Dataflow = Dataflow.MAPS_RESIDENT,
                        row_starts=None) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors: x (B, H, W, Cin) f32
    unpadded, w (kh, kw, Cin, Cout), bias (Cout,), bypass (B, OH, OW,
    Cout), row_starts (n_strips,) int32 strip input rows in the padded
    maps (``prefetch_row_starts``) or None for the affine offsets.
    Returns (B, OHo, OWo, Cout).  Raises on a CPU tensor."""
    if not x.is_cuda:
        raise RuntimeError("conv2d_virtual_cuda needs CUDA tensors, got "
                           f"one on {x.device}")
    out = torch.empty((g.B, g.OHo, g.OWo, g.Cout), dtype=torch.float32,
                      device=x.device)
    args = launch_args(x, w, g, out, bias=bias, activation=activation,
                       bypass=bypass, bypass_first=bypass_first,
                       dataflow=dataflow, row_starts=row_starts)
    lib, fn = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_ptr(x), _ptr(w), _ptr(bias), _ptr(bypass),
                 _ptr(row_starts), _ptr(out), *args, stream)
    check_launch(lib, "conv2d", err)
    conv2d_virtual_cuda.launches += 1
    return out


conv2d_virtual_cuda.launches = 0


# --- materialized strips (the paper-faithful baseline) -------------------------
@dataclass(frozen=True)
class StripsGeometry:
    """Strip extents of one materialized conv, as the reference derives
    them in ``_conv2d_materialized``: the maps are padded by ``pad`` on
    top and at the sides and ``bottom_pad`` below, and strip ``s`` of
    an image is padded rows ``[s*out_rows*stride, ... + in_rows)``."""
    B: int
    H: int
    W: int
    Cin: int
    Cout: int
    kh: int
    kw: int
    stride: int
    pad: int
    out_rows: int          # output rows a strip owns
    kpt: int               # kernels per tile (divides Cout)
    OH: int
    OW: int
    n_strips: int          # strips per image
    in_rows: int
    bottom_pad: int
    Hp: int
    Wp: int

    @property
    def NS(self) -> int:
        """Strips in the buffer, over the whole batch."""
        return self.B * self.n_strips


def strips_geometry(x_shape, w_shape, *, stride: int, pad: int,
                    out_rows: int, kpt: int) -> StripsGeometry:
    """Strip extents for x (B, H, W, Cin), w (kh, kw, Cin, Cout) and the
    schedule's ``out_rows`` / ``kpt`` (lowered until it divides Cout).
    The bottom pad is ``max(pad, Hp_needed - H - pad)``: at least the
    conv's own pad, not the zero-copy path's ``max(0, ...)``."""
    B, H, W, Cin = x_shape
    kh, kw, _, Cout = w_shape
    OH = (H + 2 * pad - kh) // stride + 1
    OW = (W + 2 * pad - kw) // stride + 1
    while Cout % kpt != 0:
        kpt -= 1
    in_rows = (out_rows - 1) * stride + kh
    n_strips = math.ceil(OH / out_rows)
    Hp_needed = (n_strips - 1) * out_rows * stride + in_rows
    bottom = max(pad, Hp_needed - H - pad)
    return StripsGeometry(
        B=B, H=H, W=W, Cin=Cin, Cout=Cout, kh=kh, kw=kw, stride=stride,
        pad=pad, out_rows=out_rows, kpt=kpt, OH=OH, OW=OW,
        n_strips=n_strips, in_rows=in_rows, bottom_pad=bottom,
        Hp=H + pad + bottom, Wp=W + 2 * pad)


def materialize_strips(x: torch.Tensor, g: StripsGeometry) -> torch.Tensor:
    """Copy the halo-augmented row strips of x (B, H, W, Cin) into one
    fresh contiguous (B*NS, in_rows, Wp, Cin) tensor, image-major: the
    maps padded once, then every strip's window copied out, so the rows
    two strips share are stored twice."""
    xp = F.pad(x, (0, 0, g.pad, g.pad, g.pad, g.bottom_pad))
    windows = xp.unfold(1, g.in_rows, g.out_rows * g.stride)[:, :g.n_strips]
    strips = torch.empty((g.B, g.n_strips, g.in_rows, g.Wp, g.Cin),
                         dtype=x.dtype, device=x.device)
    strips.copy_(windows.permute(0, 1, 4, 2, 3))
    return strips.reshape(g.NS, g.in_rows, g.Wp, g.Cin)


def strip_bypass(bypass: torch.Tensor, g: StripsGeometry) -> torch.Tensor:
    """A bypass broadcastable to (B, OH, OW, Cout), padded to the strips'
    ``n_strips * out_rows`` rows: (B*NS, out_rows, OW, Cout)."""
    byp = bypass.expand(g.B, g.OH, g.OW, g.Cout)
    byp = F.pad(byp, (0, 0, 0, 0, 0, g.n_strips * g.out_rows - g.OH))
    return byp.reshape(g.NS, g.out_rows, g.OW, g.Cout).contiguous()


def unstrip(out: torch.Tensor, g: StripsGeometry) -> torch.Tensor:
    """(B*NS, out_rows, OW, Cout) strip outputs back to (B, OH, OW, Cout):
    the rows past OH the last strip computed are dropped."""
    return out.reshape(g.B, g.n_strips * g.out_rows, g.OW, g.Cout)[:, :g.OH]


def conv2d_strips_plain(strips, w, g: StripsGeometry, *, bias=None,
                        activation: str | None = None, bypass=None,
                        bypass_first: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch ops: each strip is a pad-0
    conv of its own rows (``(in_rows - kh) / stride + 1 == out_rows``),
    then the epilogue.  Returns (B*NS, out_rows, OW, Cout)."""
    return conv2d_ref(strips, w, stride=g.stride, pad=0, bias=bias,
                      activation=activation, bypass=bypass,
                      bypass_first=bypass_first)


def strips_launch_args(strips, w, g: StripsGeometry, out, *, bias=None,
                       activation: str | None = None, bypass=None,
                       bypass_first: bool = False,
                       dataflow: Dataflow = Dataflow.MAPS_RESIDENT) -> list:
    """Checks the operands and returns ``conv2d_strips_f32``'s arguments
    after the five pointers' tensors and before the stream."""
    want = {"strips": (strips, (g.NS, g.in_rows, g.Wp, g.Cin)),
            "w": (w, (g.kh, g.kw, g.Cin, g.Cout)),
            "out": (out, (g.NS, g.out_rows, g.OW, g.Cout))}
    if bias is not None:
        want["bias"] = (bias, (g.Cout,))
    if bypass is not None:
        want["bypass"] = (bypass, (g.NS, g.out_rows, g.OW, g.Cout))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise TypeError(f"conv2d_strips_cuda: {name} must be float32 "
                            f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.device != strips.device:
            raise ValueError(f"conv2d_strips_cuda: {name} must be "
                             f"contiguous on {strips.device}")
    return [g.NS, g.in_rows, g.Wp, g.Cin, g.kh, g.kw, g.Cout, g.stride,
            g.out_rows, g.OW, ACT_CODES[activation], int(bypass_first),
            int(dataflow is Dataflow.WEIGHTS_RESIDENT)]


_STRIPS_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 13
                    + [ctypes.c_void_p])


def conv2d_strips_cuda(strips, w, g: StripsGeometry, *, bias=None,
                       activation: str | None = None, bypass=None,
                       bypass_first: bool = False,
                       dataflow: Dataflow = Dataflow.MAPS_RESIDENT
                       ) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors: strips (B*NS, in_rows, Wp,
    Cin) f32 from ``materialize_strips``, w (kh, kw, Cin, Cout), bias
    (Cout,), bypass (B*NS, out_rows, OW, Cout) from ``strip_bypass``.
    Returns (B*NS, out_rows, OW, Cout).  Raises on a CPU tensor."""
    if not strips.is_cuda:
        raise RuntimeError("conv2d_strips_cuda needs CUDA tensors, got "
                           f"one on {strips.device}")
    out = torch.empty((g.NS, g.out_rows, g.OW, g.Cout), dtype=torch.float32,
                      device=strips.device)
    args = strips_launch_args(strips, w, g, out, bias=bias,
                              activation=activation, bypass=bypass,
                              bypass_first=bypass_first, dataflow=dataflow)
    lib = load_library("conv2d_strips")
    fn = lib.conv2d_strips_f32
    fn.argtypes, fn.restype = _STRIPS_ARGTYPES, ctypes.c_int
    with torch.cuda.device(strips.device):
        stream = torch.cuda.current_stream(strips.device).cuda_stream
        err = fn(_ptr(strips), _ptr(w), _ptr(bias), _ptr(bypass), _ptr(out),
                 *args, stream)
    check_launch(lib, "conv2d_strips", err)
    conv2d_strips_cuda.launches += 1
    return out


conv2d_strips_cuda.launches = 0
