"""Zero-copy row-strip conv2d: the Hopper kernel and its plain version.

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
CPU path and the on-card comparisons use it.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from ...core.dataflow import Dataflow
from ...core.ir import pool_out
from ..common import ACT_CODES, check_launch, load_library
from .ref import avgpool2d_ref, conv2d_ref, maxpool2d_ref

__all__ = ["VirtualGeometry", "virtual_geometry", "conv2d_virtual_cuda",
           "conv2d_virtual_plain", "pool_ref"]

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
                dataflow: Dataflow = Dataflow.MAPS_RESIDENT) -> list:
    """Checks the operands and returns ``conv2d_virtual_f32``'s arguments
    after the five pointers' tensors and before the stream."""
    if g.pool is not None and bypass is not None:
        raise ValueError("fused pool is not combinable with bypass")
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


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 26 + [ctypes.c_void_p]


def _launcher():
    lib = load_library("conv2d")
    fn = lib.conv2d_virtual_f32
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return lib, fn


def conv2d_virtual_cuda(x, w, g: VirtualGeometry, *, bias=None,
                        activation: str | None = None, bypass=None,
                        bypass_first: bool = False,
                        dataflow: Dataflow = Dataflow.MAPS_RESIDENT
                        ) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors: x (B, H, W, Cin) f32
    unpadded, w (kh, kw, Cin, Cout), bias (Cout,), bypass (B, OH, OW,
    Cout).  Returns (B, OHo, OWo, Cout).  Raises on a CPU tensor."""
    if not x.is_cuda:
        raise RuntimeError("conv2d_virtual_cuda needs CUDA tensors, got "
                           f"one on {x.device}")
    out = torch.empty((g.B, g.OHo, g.OWo, g.Cout), dtype=torch.float32,
                      device=x.device)
    args = launch_args(x, w, g, out, bias=bias, activation=activation,
                       bypass=bypass, bypass_first=bypass_first,
                       dataflow=dataflow)
    lib, fn = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_ptr(x), _ptr(w), _ptr(bias), _ptr(bypass), _ptr(out),
                 *args, stream)
    check_launch(lib, "conv2d", err)
    conv2d_virtual_cuda.launches += 1
    return out


conv2d_virtual_cuda.launches = 0
