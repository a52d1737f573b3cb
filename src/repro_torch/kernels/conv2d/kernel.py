"""Row-strip conv2d: the two Hopper kernels and their plain versions.

``conv2d_virtual_cuda`` replaces
``repro/kernels/conv2d/kernel.py::conv2d_virtual_pallas`` (line 241;
its ``pallas_call`` at lines 342/346).  It computes the same function:
an implicit-GEMM conv over NHWC maps with the fused epilogue bias ->
bypass if ``bypass_first`` -> activation -> bypass otherwise, then an
optional fused max or avg pool, with strip ``s`` owning output rows
``[s*SR, (s+1)*SR)``.  Its source is ``csrc/conv2d.cu``; it reads the
unpadded maps, so no padded copy of the maps is made.

``conv2d_strips_cuda`` replaces
``repro/kernels/conv2d/kernel.py::conv2d_strips_pallas`` (line 111; its
``pallas_call`` at line 163), the paper-faithful baseline: the same
implicit GEMM and epilogue over halo-augmented row strips that
``materialize_strips`` has already copied into device memory,
(B*NS, in_rows, Wp, Cin) -> (B*NS, out_rows, OW, Cout).  Its source is
``csrc/conv2d_strips.cu``.  ``strips_geometry`` carries the reference's
strip extents and bottom-pad rule (``repro/kernels/conv2d/ops.py:
204-240``), which differ from the zero-copy path's; ``strip_bypass``
and ``unstrip`` are the reshapes around the call.  The copy is the
point of the baseline (Snowflake's DMA needs single-burst strips), so
it is a real device copy, never a view.

What bounds them on an H100: at batch 8 the alexnet-owt convs do 84-953
f32 FLOP per byte they must move and resnet18's 3x3 convs 93-332, far
above the card's f32 ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte),
so arithmetic bounds them; only resnet18's 1x1 stride-2 projections
(11-38 FLOP/byte) sit near the ridge.  Both kernels are one design
(``csrc/conv_mma.cuh``): the GEMM runs on the tensor cores in 3xTF32
(each f32 operand split into two TF32 parts, three mma.sync products
summed in f32, so f32 accuracy is kept), operands staged by cp.async in
a three-stage ring, 64-channel tiles over a flat pixel index (or, with a
fused pool, the whole conv region of a pooled tile, so K is streamed
once), and split-K over the CTAs of one thread-block cluster, merged in
split order through distributed shared memory: one launch, no
workspace, the same bits from run to run.  ``conv_plan`` picks the tile,
the pooled tile shape and the splits from shapes alone, so a launch
reads nothing on the host and can be captured in a CUDA graph.  Both
take f32 or bf16 operands (all of one type, as the reference takes the
input's type): a bf16 value is exact in TF32, so its products need no
split; the sums are f32 and the output is rounded to bf16 once.

``virtual_geometry`` is the one pure-Python home of the strip extents
``repro/kernels/conv2d/ops.py:152-174`` derives (``out_rows`` rounded to
the pool stride, ``rows_c``, ``top_pad``, ``n_strips``, the pooled
extents), so the CPU tests hold them against the reference's.
``conv2d_virtual_plain`` computes the same output with PyTorch ops; the
CPU path and the on-card comparisons use it.  With ``row_starts`` (the
reference's ``strip_offsets="prefetch"``) each pixel's strip input row
comes from a device table instead of the affine ``s * out_rows *
stride``, as the TPU kernel reads its scalar-prefetched table.
``conv2d_strips_plain`` is a pad-0 conv of each strip followed by the
same epilogue.
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

__all__ = ["ConvPlan", "conv_plan", "VirtualGeometry", "virtual_geometry",
           "conv2d_virtual_cuda",
           "conv2d_virtual_plain", "pool_ref", "prefetch_row_starts",
           "StripsGeometry", "strips_geometry", "materialize_strips",
           "strip_bypass", "unstrip", "conv2d_strips_cuda",
           "conv2d_strips_plain"]

_POOL_CODES = {None: 0, "max": 1, "avg": 2}
# The C launchers' suffix by operand type.
_TYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# The core's constants (csrc/conv_mma.cuh): channels a CTA tile holds, the
# reduction slice, the ring's stages, the pixel tiles it is built for.
BN, BK, STAGES = 64, 32, 3
TILE_PIXELS = (64, 256)
MAX_SPLITS = 8                 # CTAs of one cluster
SMS = 132                      # streaming multiprocessors of an H100


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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_smem(bm: int) -> int:
    """Shared bytes of a CTA with ``bm``-pixel tiles (csrc/conv_mma.cuh
    ``smem_bytes``): the ring of A and B slices in padded rows, which the
    split partials reuse after the K loop, then the tile's row table."""
    ring = STAGES * (bm * (BK + 8) + BK * (BN + 4))
    return 4 * max(ring, bm * BN) + 16 * bm


def resident(bm: int) -> int:
    """CTAs of ``bm``-pixel tiles one SM holds at once: its 228 KB of
    shared memory, 1 KB of it reserved per CTA (3 and 1)."""
    return (228 * 1024) // (tile_smem(bm) + 1024)


@dataclass(frozen=True)
class ConvPlan:
    """One conv launch of ``csrc/conv_mma.cuh``: tiles of ``bm`` pixels
    by 64 channels (``n_mt`` x ``n_nt`` of them), K in ``k_slices``
    slices of ``BK``, ``kps`` of them a split, ``splits`` CTAs a tile in
    one cluster.  With a fused pool a pixel tile is the conv region
    (``conv_r`` x ``conv_c`` <= ``bm``) under ``tile_r`` x ``tile_c``
    pooled outputs, ``n_tr`` x ``n_tc`` tiles a strip.  ``vec_a`` /
    ``vec_b``: 16-byte copies of the maps / weights (else 4-byte)."""
    bm: int
    n_mt: int
    n_nt: int
    k_slices: int
    kps: int
    splits: int
    smem: int
    vec_a: bool
    vec_b: bool
    tile_r: int = 0
    tile_c: int = 0
    conv_r: int = 0
    conv_c: int = 0
    n_tr: int = 0
    n_tc: int = 0

    @property
    def ctas(self) -> int:
        return self.n_mt * self.n_nt * self.splits


def _pool_tile(g: "VirtualGeometry", name: str):
    """(bm, tile_r, tile_c, conv_r, conv_c, n_tr, n_tc) of a fused-pool
    conv: of every pooled tile whose conv region fits a pixel tile, the
    one that computes the fewest pixel rows of the GEMM (tiles x bm), then
    the fewest recomputed halo pixels, then the smaller tile."""
    pw, ps = g.pool[0], g.pool[1]
    if pw * pw > TILE_PIXELS[-1]:
        raise ValueError(
            f"{name}: fused pool window {pw} needs a {pw}x{pw} conv region, "
            f"past the kernel's {TILE_PIXELS[-1]}-pixel tile "
            f"(conv {g.OH}x{g.OW}, pool stride {ps})")
    best = None
    for bm in TILE_PIXELS:
        for tile_r in range(1, g.SR + 1):
            conv_r = (tile_r - 1) * ps + pw
            if conv_r * pw > bm:
                break
            for tile_c in range(1, g.OWo + 1):
                conv_c = (tile_c - 1) * ps + pw
                if conv_r * conv_c > bm:
                    break
                n_tr, n_tc = _cdiv(g.SR, tile_r), _cdiv(g.OWo, tile_c)
                n_mt = g.B * g.n_strips * n_tr * n_tc
                key = (n_mt * bm, n_mt * conv_r * conv_c, bm)
                if best is None or key < best[0]:
                    best = (key, (bm, tile_r, tile_c, conv_r, conv_c, n_tr,
                                  n_tc))
    return best[1]


def conv_plan(g, *, aligned: bool = True) -> ConvPlan:
    """The launch of one conv of geometry ``g`` (a ``VirtualGeometry`` or
    a ``StripsGeometry``), from shapes alone.  Pixel tiles: a fused pool's
    conv regions (``_pool_tile``), else 64 flat pixels.  Splits: the most
    (a power of two up to ``MAX_SPLITS``, each at least one slice of K)
    for which every CTA of the grid is resident at once on the ``SMS``
    SMs: more CTAs hide more latency until they no longer fit in one
    wave.  ``aligned``: the operands start on 16-byte boundaries.  Raises
    on what the kernels do not take."""
    virtual = isinstance(g, VirtualGeometry)
    name = "conv2d_virtual_cuda" if virtual else "conv2d_strips_cuda"
    K = g.kh * g.kw * g.Cin
    n_nt = _cdiv(g.Cout, BN)
    pool_tile = {}
    if virtual and g.pool is not None:
        bm, *rest = _pool_tile(g, name)
        pool_tile = dict(zip(("tile_r", "tile_c", "conv_r", "conv_c", "n_tr",
                              "n_tc"), rest))
        n_mt = g.B * g.n_strips * pool_tile["n_tr"] * pool_tile["n_tc"]
    else:
        M = g.B * g.OH * g.OW if virtual else g.NS * g.out_rows * g.OW
        bm = TILE_PIXELS[0]
        n_mt = _cdiv(M, bm)
    k_slices = _cdiv(K, BK)
    splits = 1
    while (splits < MAX_SPLITS
           and 2 * splits * n_mt * n_nt <= SMS * resident(bm)
           and 2 * splits <= k_slices):
        splits *= 2
    return ConvPlan(bm=bm, n_mt=n_mt, n_nt=n_nt, k_slices=k_slices,
                    kps=_cdiv(k_slices, splits), splits=splits,
                    smem=tile_smem(bm),
                    vec_a=aligned and g.Cin % 4 == 0,
                    vec_b=aligned and g.Cout % 4 == 0, **pool_tile)


def plan_args(plan: ConvPlan) -> list:
    """The plan's fields both C launchers take after the geometry."""
    return [plan.bm, int(plan.vec_a), int(plan.vec_b), plan.smem, plan.n_mt,
            plan.n_nt, plan.splits, plan.kps]


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


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
    """Checks the operands (all float32 or all bfloat16) and returns the
    ints ``conv2d_virtual_f32`` / ``_bf16`` take after the six pointers:
    the geometry, then ``conv_plan``'s fields."""
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
        if (tuple(t.shape) != shape or t.dtype not in _TYPES
                or t.dtype != x.dtype and name != "x"):
            raise TypeError(f"conv2d_virtual_cuda: {name} must be float32 "
                            f"or bfloat16 {shape} in x's type, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"conv2d_virtual_cuda: {name} must be "
                             f"contiguous on {x.device}")
    pw, ps, pp, op = g.pool if g.pool is not None else (0, 0, 0, None)
    plan = conv_plan(g, aligned=_aligned(x, w))
    return [g.B, g.H, g.W, g.Cin, g.kh, g.kw, g.Cout, g.stride, g.pad,
            g.out_rows, g.OH, g.OW, g.n_strips, g.top_pad, pw, ps, pp,
            _POOL_CODES[op], g.SR, g.OHo, g.OWo, ACT_CODES[activation],
            int(bypass_first), int(dataflow is Dataflow.WEIGHTS_RESIDENT)
            ] + plan_args(plan) + [plan.tile_r, plan.tile_c, plan.n_tr,
                                   plan.n_tc]


def _call(lib_name: str, fn_name: str, ptrs, args, device) -> None:
    """Launch ``fn_name`` of library ``lib_name`` on ``device``'s current
    stream: the operand pointers, then the ints as one array and its
    length."""
    lib = load_library(lib_name)
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_void_p] * (len(ptrs) + 1) + [ctypes.c_int,
                                                         ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*ptrs, (ctypes.c_int * len(args))(*args), len(args), stream)
    check_launch(lib, lib_name, err)


def conv2d_virtual_cuda(x, w, g: VirtualGeometry, *, bias=None,
                        activation: str | None = None, bypass=None,
                        bypass_first: bool = False,
                        dataflow: Dataflow = Dataflow.MAPS_RESIDENT,
                        row_starts=None) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors: x (B, H, W, Cin) f32 or
    bf16 unpadded, w (kh, kw, Cin, Cout), bias (Cout,), bypass (B, OH,
    OW, Cout), all in x's type, row_starts (n_strips,) int32 strip input
    rows in the padded maps (``prefetch_row_starts``) or None for the
    affine offsets.  One launch on ``conv_plan``'s grid; ``launches``
    counts it.  Returns (B, OHo, OWo, Cout) in x's type.  Raises on a CPU
    tensor."""
    if not x.is_cuda:
        raise RuntimeError("conv2d_virtual_cuda needs CUDA tensors, got "
                           f"one on {x.device}")
    out = torch.empty((g.B, g.OHo, g.OWo, g.Cout), dtype=x.dtype,
                      device=x.device)
    args = launch_args(x, w, g, out, bias=bias, activation=activation,
                       bypass=bypass, bypass_first=bypass_first,
                       dataflow=dataflow, row_starts=row_starts)
    _call("conv2d", f"conv2d_virtual_{_TYPES[x.dtype]}", [
        _ptr(x), _ptr(w), _ptr(bias), _ptr(bypass), _ptr(row_starts),
        _ptr(out)], args, x.device)
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
    """Checks the operands (all float32 or all bfloat16) and returns the
    ints ``conv2d_strips_f32`` / ``_bf16`` take after the five pointers:
    the geometry, then ``conv_plan``'s fields."""
    want = {"strips": (strips, (g.NS, g.in_rows, g.Wp, g.Cin)),
            "w": (w, (g.kh, g.kw, g.Cin, g.Cout)),
            "out": (out, (g.NS, g.out_rows, g.OW, g.Cout))}
    if bias is not None:
        want["bias"] = (bias, (g.Cout,))
    if bypass is not None:
        want["bypass"] = (bypass, (g.NS, g.out_rows, g.OW, g.Cout))
    for name, (t, shape) in want.items():
        if (tuple(t.shape) != shape or t.dtype not in _TYPES
                or t.dtype != strips.dtype and name != "strips"):
            raise TypeError(f"conv2d_strips_cuda: {name} must be float32 "
                            f"or bfloat16 {shape} in the strips' type, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.device != strips.device:
            raise ValueError(f"conv2d_strips_cuda: {name} must be "
                             f"contiguous on {strips.device}")
    plan = conv_plan(g, aligned=_aligned(strips, w))
    return [g.NS, g.in_rows, g.Wp, g.Cin, g.kh, g.kw, g.Cout, g.stride,
            g.out_rows, g.OW, ACT_CODES[activation], int(bypass_first),
            int(dataflow is Dataflow.WEIGHTS_RESIDENT)] + plan_args(plan)


def conv2d_strips_cuda(strips, w, g: StripsGeometry, *, bias=None,
                       activation: str | None = None, bypass=None,
                       bypass_first: bool = False,
                       dataflow: Dataflow = Dataflow.MAPS_RESIDENT
                       ) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors: strips (B*NS, in_rows, Wp,
    Cin) f32 or bf16 from ``materialize_strips``, w (kh, kw, Cin, Cout),
    bias (Cout,), bypass (B*NS, out_rows, OW, Cout) from
    ``strip_bypass``, all in the strips' type.  One launch on
    ``conv_plan``'s grid; ``launches`` counts it.  Returns (B*NS,
    out_rows, OW, Cout) in the strips' type.  Raises on a CPU tensor."""
    if not strips.is_cuda:
        raise RuntimeError("conv2d_strips_cuda needs CUDA tensors, got "
                           f"one on {strips.device}")
    out = torch.empty((g.NS, g.out_rows, g.OW, g.Cout), dtype=strips.dtype,
                      device=strips.device)
    args = strips_launch_args(strips, w, g, out, bias=bias,
                              activation=activation, bypass=bypass,
                              bypass_first=bypass_first, dataflow=dataflow)
    _call("conv2d_strips", f"conv2d_strips_{_TYPES[strips.dtype]}", [
        _ptr(strips), _ptr(w), _ptr(bias), _ptr(bypass), _ptr(out)], args,
        strips.device)
    conv2d_strips_cuda.launches += 1
    return out


conv2d_strips_cuda.launches = 0
