"""The conv kernels' launch plan and the arithmetic of their 3xTF32 split-K
GEMM, on the CPU.

``conv_plan`` (``repro_torch/kernels/conv2d/kernel.py``) is plain Python:
from shapes alone it picks the pixel tile (a flat range of output pixels,
or the conv region under a fused pool's pooled tile), the 64-channel
tiles and the splits of K, whose CTAs are one thread-block cluster that
merges their partials in split order (``csrc/conv_mma.cuh``).  Here it is
held to every conv of the alexnet-owt and resnet18 Programs, zero-copy
(``TPU_V5E``) and paper-faithful (``SNOWFLAKE``), at batch 8; a walk of
its grid in Python, CTA by CTA as the kernel maps them, writes every
(pixel, channel) of the output exactly once; the wrappers refuse what the
kernels do not take; and a torch emulation of the kernels' arithmetic --
the im2col rows each tile gathers, each operand split into two TF32
parts by rounding its bits, three products per 8-deep step summed in a
fresh f32 fragment and added to the accumulator, each split's partial
added in split order, the epilogue and the pool -- is held at 1e-5 in f32
to the port's plain versions and to ``repro``'s reference.  The
emulation sums with elementwise f32 ops in a fixed order, never through
the CPU's matmul library, so its bits do not depend on the process
(thread count, the library's kernel or alignment path, precision mode).
"""
import dataclasses
import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.conv2d import (avgpool2d_ref as jax_avgpool,  # noqa: E402
                                  conv2d_ref as jax_conv2d_ref,
                                  maxpool2d_ref as jax_maxpool)

from repro_torch.configs import CNN_REGISTRY  # noqa: E402
from repro_torch.core import SNOWFLAKE, TPU_V5E  # noqa: E402
from repro_torch.core.dataflow import Dataflow  # noqa: E402
from repro_torch.kernels.common import apply_activation  # noqa: E402
from repro_torch.kernels.conv2d.kernel import (  # noqa: E402
    BK, BN, MAX_SPLITS, SMS, TILE_PIXELS, conv2d_strips_cuda,
    conv2d_strips_plain, conv2d_virtual_cuda, conv2d_virtual_plain,
    conv_plan, launch_args, materialize_strips, prefetch_row_starts,
    resident, strip_bypass, strips_geometry, strips_launch_args, tile_smem,
    virtual_geometry)
from repro_torch.kernels.conv2d.ops import (norm_pool,  # noqa: E402
                                            strips_plan, virtual_plan)
from repro_torch.models import cnn  # noqa: E402

# The package re-exports the function ``conv2d`` over its module name.
KMOD = importlib.import_module("repro_torch.kernels.conv2d.kernel")
TOL = 1e-5            # f32, the same sums in another order
SMEM_LIMIT = 232448   # bytes of shared memory an H100 block may use


def _program_convs():
    """(label, geometry, dataflow) of each distinct conv of the
    alexnet-owt and resnet18 Programs at batch 8: ``TPU_V5E`` zero-copy
    (fused pools) and ``SNOWFLAKE`` paper-faithful (materialized)."""
    out, seen = [], set()
    for arch in ("alexnet-owt", "resnet18"):
        cfg = CNN_REGISTRY[arch]
        shapes = cnn.trace_shapes(cfg)
        for hw, faithful in ((TPU_V5E, False), (SNOWFLAKE, True)):
            prog = cnn.compile_program(cfg, batch=8, hw=hw,
                                       paper_faithful=faithful)
            for op in prog.ops:
                if op.kernel != "conv2d":
                    continue
                i = int(op.param_key.split("_")[1])
                h, w, c = shapes[i]
                xs = (8, h, w, c)
                ws = (cfg.layers[i].k, cfg.layers[i].k, c,
                      cfg.layers[i].c_out)
                if op.strip_storage == "materialized":
                    g, df = strips_plan(xs, ws, stride=op.stride,
                                        pad=op.pad, tiling=op.conv_tiling,
                                        dataflow=op.dataflow)
                else:
                    g, df, _ = virtual_plan(
                        xs, ws, stride=op.stride, pad=op.pad,
                        pool=norm_pool(op.fuse_pool),
                        has_bypass=op.fuse_bypass, tiling=op.conv_tiling,
                        dataflow=op.dataflow)
                if (g, df) not in seen:
                    seen.add((g, df))
                    out.append((f"{arch}@{hw.name}:{op.name}", g, df))
    return out


PROGRAM_CONVS = _program_convs()
IDS = [c[0] for c in PROGRAM_CONVS]


@pytest.mark.parametrize("case", PROGRAM_CONVS, ids=IDS)
def test_program_conv_plan_fits_the_card(case):
    """Shared memory within the block's 227 KB, at most 8 splits (a
    power of two, so each CTA owns a slice of whole n8 tiles), every CTA
    resident at once (a split more would not be, or the splits are
    spent), and a pooled region held whole by one tile: it streams K
    once."""
    _, g, _ = case
    plan = conv_plan(g)
    K = g.kh * g.kw * g.Cin
    assert plan.smem == tile_smem(plan.bm) <= SMEM_LIMIT
    assert plan.bm in TILE_PIXELS
    assert plan.splits in (1, 2, 4, 8) and plan.splits <= MAX_SPLITS
    assert plan.k_slices == math.ceil(K / BK)
    assert plan.kps * plan.splits >= plan.k_slices
    assert (plan.kps - 1) * plan.splits < plan.k_slices
    assert plan.n_nt == math.ceil(g.Cout / BN)
    slots = SMS * resident(plan.bm)
    assert plan.ctas <= slots or plan.splits == 1
    assert (2 * plan.ctas > slots or plan.splits == MAX_SPLITS
            or plan.k_slices < 2 * plan.splits)
    assert plan.vec_b == (g.Cout % 4 == 0)
    assert plan.vec_a == (g.Cin % 4 == 0)
    if getattr(g, "pool", None) is not None:
        pw, ps = g.pool[:2]
        assert plan.conv_r == (plan.tile_r - 1) * ps + pw
        assert plan.conv_c == (plan.tile_c - 1) * ps + pw
        assert plan.conv_r * plan.conv_c <= plan.bm
        assert plan.n_mt == g.B * g.n_strips * plan.n_tr * plan.n_tc
    else:
        assert plan.tile_r == plan.conv_r == plan.n_tr == 0


def test_every_program_conv_is_on_the_tensor_core_path():
    """The plans the served Programs need: the alexnet-owt pooled convs
    hold 256-pixel regions (conv_06 a whole image's 13 x 13, split 4
    ways: one K pass) and the 7x7 resnet18 convs are split over more
    CTAs than the card has SMs."""
    plans = {label: conv_plan(g) for label, g, _ in PROGRAM_CONVS}
    conv_06 = plans["alexnet-owt@tpu_v5e:conv_06"]
    assert (conv_06.tile_r, conv_06.conv_r, conv_06.splits) == (6, 13, 4)
    for name in ("conv_00", "conv_02", "conv_06"):
        assert plans[f"alexnet-owt@tpu_v5e:{name}"].bm == 256
    for label, plan in plans.items():
        if label.endswith(("conv_18", "conv_19")):
            assert plan.splits > 1 and plan.ctas >= SMS


def _grid(plan, df):
    """(mt, nt, rank) of each CTA, blockIdx.x in order, as the kernel
    reads them."""
    for bx in range(plan.ctas):
        tile, rank = divmod(bx, plan.splits)
        if df is Dataflow.WEIGHTS_RESIDENT:
            nt, mt = divmod(tile, plan.n_mt)
        else:
            mt, nt = divmod(tile, plan.n_nt)
        yield mt, nt, rank


def _pool_tile(g, plan, mt):
    rest, tc = divmod(mt, plan.n_tc)
    rest, tr = divmod(rest, plan.n_tr)
    b, s = divmod(rest, g.n_strips)
    return b, s, tr, tc


def _written(g, plan, df):
    """How often the walk writes each element of the kernel's output."""
    pool = getattr(g, "pool", None)
    if isinstance(g, KMOD.StripsGeometry):
        shape = (g.NS * g.out_rows * g.OW, g.Cout)
    elif pool is None:
        shape = (g.B * g.OH * g.OW, g.Cout)
    else:
        shape = (g.B, g.OHo, g.OWo, g.Cout)
    count = np.zeros(shape, np.int32)
    CS = BN // plan.splits
    M = shape[0]
    for mt, nt, rank in _grid(plan, df):
        c = np.arange(nt * BN + rank * CS, nt * BN + (rank + 1) * CS)
        c = c[c < g.Cout]
        if pool is None:
            m = np.arange(mt * plan.bm, (mt + 1) * plan.bm)
            m = m[m < M]
            count[np.ix_(m, c)] += 1
            continue
        b, s, tr, tc = _pool_tile(g, plan, mt)
        pl = tr * plan.tile_r + np.arange(plan.tile_r)
        prow = s * g.SR + pl
        q = tc * plan.tile_c + np.arange(plan.tile_c)
        rows = prow[(pl < g.SR) & (prow < g.OHo)]
        cols = q[q < g.OWo]
        count[b][np.ix_(rows, cols, c)] += 1
    return count


@pytest.mark.parametrize("case", PROGRAM_CONVS, ids=IDS)
def test_program_conv_grid_writes_every_output_once(case):
    _, g, df = case
    assert (_written(g, conv_plan(g), df) == 1).all()


@pytest.mark.parametrize("splits", [1, 8])
@pytest.mark.parametrize("df", list(Dataflow))
def test_grid_walk_at_forced_splits(monkeypatch, splits, df):
    """A ragged pooled conv and a ragged strips conv, one split and 8."""
    _force_splits(monkeypatch, splits)
    g = virtual_geometry((2, 27, 27, 12), (5, 5, 12, 72), stride=1, pad=2,
                         out_rows=26, kpt=72, pool=(3, 2, 0, "max"))
    sg = strips_geometry((2, 13, 13, 64), (3, 3, 64, 70), stride=1,
                         pad=1, out_rows=2, kpt=7)
    for geom in (g, sg):
        plan = conv_plan(geom)
        assert plan.splits == splits
        assert (_written(geom, plan, df) == 1).all()


# --- refusals ----------------------------------------------------------------
def test_conv_plan_refuses_a_pool_window_past_the_tile():
    g = virtual_geometry((1, 40, 40, 4), (3, 3, 4, 8), stride=1, pad=1,
                         out_rows=34, kpt=8, pool=(17, 17, 0, "max"))
    with pytest.raises(ValueError, match="fused pool window 17 needs a "
                       "17x17 conv region, past the kernel's 256-pixel"):
        conv_plan(g)


def test_conv_plan_takes_4_byte_copies_off_alignment():
    g = virtual_geometry((1, 9, 9, 8), (3, 3, 8, 16), stride=1, pad=1,
                         out_rows=9, kpt=16)
    assert (conv_plan(g).vec_a, conv_plan(g).vec_b) == (True, True)
    off = conv_plan(g, aligned=False)
    assert (off.vec_a, off.vec_b) == (False, False)
    x = torch.zeros(1 + 9 * 9 * 8)[1:].view(1, 9, 9, 8)   # 4 bytes off
    w = torch.zeros((3, 3, 8, 16))
    out = torch.empty((1, 9, 9, 16))
    assert launch_args(x, w, g, out)[25:27] == [0, 0]


def test_wrappers_refuse_cpu_tensors_and_bad_operands():
    g = virtual_geometry((1, 9, 9, 4), (3, 3, 4, 8), stride=1, pad=1,
                         out_rows=4, kpt=8, pool=(2, 2, 0, "max"))
    x, w = torch.zeros((1, 9, 9, 4)), torch.zeros((3, 3, 4, 8))
    with pytest.raises(RuntimeError, match="conv2d_virtual_cuda needs "
                       "CUDA tensors"):
        conv2d_virtual_cuda(x, w, g)
    out = torch.empty((g.B, g.OHo, g.OWo, g.Cout))
    with pytest.raises(ValueError, match="fused pool is not combinable "
                       "with bypass"):
        launch_args(x, w, g, out, bypass=torch.zeros((1, 9, 9, 8)))
    with pytest.raises(TypeError, match="x must be float32"):
        launch_args(x.double(), w, g, out)
    with pytest.raises(ValueError, match="w must be contiguous"):
        launch_args(x, w.transpose(0, 1).contiguous().transpose(0, 1), g,
                    out)
    sg = strips_geometry((1, 9, 9, 4), (3, 3, 4, 8), stride=1, pad=1,
                         out_rows=3, kpt=8)
    strips = materialize_strips(x, sg)
    with pytest.raises(RuntimeError, match="conv2d_strips_cuda needs "
                       "CUDA tensors"):
        conv2d_strips_cuda(strips, w, sg)
    sout = torch.empty((sg.NS, sg.out_rows, sg.OW, sg.Cout))
    with pytest.raises(TypeError, match="out must be float32"):
        strips_launch_args(strips, w, sg, sout.double())


# --- the kernels' arithmetic, emulated ----------------------------------------
def _force_splits(monkeypatch, splits):
    """conv_plan with one split (no SMs to fill) or as many as it may."""
    if splits is None:
        return
    monkeypatch.setattr(KMOD, "SMS", 0 if splits == 1 else 10 ** 9)


def rna_tf32(t):
    """t rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero) by adding half of the dropped bits' range and masking them: the
    kernel's ``rna_tf32``."""
    u = t.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(t):
    hi = rna_tf32(t)
    return hi, rna_tf32(t - hi)


def test_tf32_split_is_exact_to_2_pow_22():
    t = torch.from_numpy(np.random.default_rng(0).standard_normal(
        4096).astype(np.float32) * 100)
    hi, lo = split_tf32(t)
    for part in (hi, lo):
        assert (part.view(torch.int32) & 0x1FFF == 0).all()
    assert ((hi + lo - t).abs() <= t.abs() * 2.0 ** -22).all()
    assert ((hi - t).abs() <= t.abs() * 2.0 ** -11).all()


def _step(A, B):
    """A (..., m, j) @ B (j, N) for one step of j <= 8 products, summed
    in k order by elementwise f32 ops: the same bits in any process
    (no BLAS kernel choice, alignment path or precision mode, no
    thread-count-dependent split)."""
    d = A[..., :, 0, None] * B[0]
    for j in range(1, A.shape[-1]):
        d = d + A[..., :, j, None] * B[j]
    return d


def gemm_3xtf32(A, B, plan):
    """A (tiles, bm, K) @ B (K, N) as the kernel sums it: per split, each
    8-deep step's lo.hi + hi.lo + hi.hi in a fresh f32 fragment added to
    the accumulator; the partials added in split order."""
    K = A.shape[-1]
    (Ah, Al), (Bh, Bl) = split_tf32(A), split_tf32(B)
    out = torch.zeros(A.shape[:-1] + (B.shape[1],), dtype=torch.float32)
    for r in range(plan.splits):
        acc = torch.zeros_like(out)
        lo, hi = r * plan.kps * BK, min(K, (r + 1) * plan.kps * BK)
        for k in range(lo, hi, 8):
            s = slice(k, min(k + 8, hi))
            d = _step(Al[..., s], Bh[s])
            d = d + _step(Ah[..., s], Bl[s])
            d = d + _step(Ah[..., s], Bh[s])
            acc = acc + d
        out = out + acc
    return out


def _taps(g):
    """(dy, dx, ci) of each k = (dy * kw + dx) * Cin + ci."""
    k = torch.arange(g.kh * g.kw * g.Cin)
    ci, tap = k % g.Cin, k // g.Cin
    return tap // g.kw, tap % g.kw, ci


def _virtual_rows(g, plan, row_starts):
    """(b, iy0, ix0, valid) of each tile pixel (tiles, bm): VirtualRows."""
    m = torch.arange(plan.bm)
    table = (row_starts if row_starts is not None else
             torch.arange(g.n_strips) * g.out_rows * g.stride)
    out = []
    for mt in range(plan.n_mt):
        if plan.tile_r == 0:
            gm = mt * plan.bm + m
            valid = gm < g.B * g.OH * g.OW
            b = gm // (g.OH * g.OW)
            gr = gm % (g.OH * g.OW) // g.OW
            gc = gm % g.OW
            s, pp = gr // g.out_rows, 0
        else:
            b, s, tr, tc = _pool_tile(g, plan, mt)
            pp = g.pool[2]
            ur, uc = m // plan.conv_c, m % plan.conv_c
            gr = s * g.out_rows - pp + tr * plan.tile_r * g.pool[1] + ur
            gc = tc * plan.tile_c * g.pool[1] - pp + uc
            valid = ((m < plan.conv_r * plan.conv_c) & (gr >= 0)
                     & (gr < g.OH) & (gc >= 0) & (gc < g.OW))
            b, s = torch.full_like(m, b), torch.full_like(m, s)
        lc = gr - (s * g.out_rows - pp)
        r0 = table[s.clamp(0, g.n_strips - 1)]
        out.append((b.clamp(0, g.B - 1), r0 + lc * g.stride - g.top_pad,
                    gc * g.stride - g.pad, valid))
    return [torch.stack(v) for v in zip(*out)]


def emulate_virtual(x, w, g, plan, *, bias, act, bypass, first,
                    row_starts=None):
    """conv2d_virtual_cuda's output, from the kernel's tiles."""
    b, iy0, ix0, valid = _virtual_rows(g, plan, row_starts)
    dy, dx, ci = _taps(g)
    iy, ix = iy0[..., None] + dy, ix0[..., None] + dx
    inb = (valid[..., None] & (iy >= 0) & (iy < g.H) & (ix >= 0)
           & (ix < g.W))
    A = x[b[..., None].expand_as(iy), iy.clamp(0, g.H - 1),
          ix.clamp(0, g.W - 1), ci.expand_as(iy)] * inb
    C = gemm_3xtf32(A, w.reshape(-1, g.Cout), plan)
    if bias is not None:
        C = C + bias
    if plan.tile_r == 0:
        flat = C.reshape(-1, g.Cout)[:g.B * g.OH * g.OW]
        byp = None if bypass is None else bypass.reshape(flat.shape)
        if byp is not None and first:
            flat = flat + byp
        flat = apply_activation(flat, act)
        if byp is not None and not first:
            flat = flat + byp
        return flat.reshape(g.B, g.OH, g.OW, g.Cout)
    pw, ps, _, op = g.pool
    ident = -math.inf if op == "max" else 0.0
    stage = torch.where(valid[..., None], apply_activation(C, act),
                        torch.full_like(C, ident))
    out = torch.full((g.B, g.OHo, g.OWo, g.Cout), math.nan,
                     dtype=torch.float32)
    for mt in range(plan.n_mt):
        bb, s, tr, tc = _pool_tile(g, plan, mt)
        region = stage[mt, :plan.conv_r * plan.conv_c].reshape(
            plan.conv_r, plan.conv_c, g.Cout)
        for r in range(plan.tile_r):
            pl = tr * plan.tile_r + r
            prow = s * g.SR + pl
            for cc in range(plan.tile_c):
                q = tc * plan.tile_c + cc
                if pl >= g.SR or prow >= g.OHo or q >= g.OWo:
                    continue
                win = region[r * ps:r * ps + pw, cc * ps:cc * ps + pw]
                if op == "max":
                    out[bb, prow, q] = win.amax((0, 1))
                else:                       # the window summed in order
                    acc = win[0, 0]
                    for i in range(1, pw * pw):
                        acc = acc + win[i // pw, i % pw]
                    out[bb, prow, q] = acc / (pw * pw)
    return out


def emulate_strips(strips, w, g, plan, *, bias, act, bypass, first):
    """conv2d_strips_cuda's output, from the kernel's tiles."""
    M = g.NS * g.out_rows * g.OW
    gm = torch.arange(plan.n_mt * plan.bm)
    valid = gm < M
    gm = gm.clamp(max=M - 1)
    s, rem = gm // (g.out_rows * g.OW), gm % (g.out_rows * g.OW)
    r, c = rem // g.OW, rem % g.OW
    dy, dx, ci = _taps(g)
    A = strips[s[:, None], r[:, None] * g.stride + dy,
               c[:, None] * g.stride + dx, ci] * valid[:, None]
    C = gemm_3xtf32(A.reshape(plan.n_mt, plan.bm, -1),
                    w.reshape(-1, g.Cout), plan).reshape(-1, g.Cout)[:M]
    if bias is not None:
        C = C + bias
    byp = None if bypass is None else bypass.reshape(C.shape)
    if byp is not None and first:
        C = C + byp
    C = apply_activation(C, act)
    if byp is not None and not first:
        C = C + byp
    return C.reshape(g.NS, g.out_rows, g.OW, g.Cout)


def _jax_ref(x, w, *, stride, pad, bias, act, bypass, first, pool):
    out = jax_conv2d_ref(jnp.asarray(x), jnp.asarray(w), stride=stride,
                         pad=pad, bias=None if bias is None
                         else jnp.asarray(bias), activation=act,
                         bypass=None if bypass is None
                         else jnp.asarray(bypass), bypass_first=first)
    if pool is not None:
        pw, ps, pp, op = pool
        ref = jax_maxpool if op == "max" else jax_avgpool
        out = ref(out, window=pw, stride=ps, pad=pp)
    return np.asarray(out)


# (x shape, k, Cout, stride, pad, out_rows, kpt, pool, bypass, first, act,
#  row_starts): ragged flat tiles with Cin = 5 and 3, a kpt = 96 channel
# tile, bypass after and first, max / avg pools (with the pool's pad),
# pooled tiles ragged at the right and bottom, the prefetched table.
VIRTUAL = [
    ((2, 9, 9, 5), 3, 12, 1, 1, 4, 8, None, False, True, "relu", False),
    ((1, 11, 10, 3), 3, 8, 2, 1, 3, 8, None, False, True, "gelu", False),
    ((1, 9, 9, 64), 3, 192, 1, 1, 4, 96, None, False, True, "relu", False),
    ((1, 8, 8, 4), 3, 8, 1, 1, 3, 4, None, True, False, "silu", False),
    ((1, 8, 8, 4), 3, 8, 1, 1, 8, 8, None, True, True, "relu", True),
    ((2, 16, 16, 4), 3, 8, 1, 1, 16, 8, (2, 2, 0, "max"), False, True,
     "relu", False),
    ((1, 13, 13, 3), 3, 8, 1, 1, 5, 8, (3, 2, 1, "max"), False, True,
     "relu", True),
    ((1, 13, 13, 3), 3, 8, 1, 1, 5, 8, (3, 2, 1, "avg"), False, True,
     "tanh", False),
    ((1, 27, 27, 12), 5, 72, 1, 2, 26, 72, (3, 2, 0, "max"), False, True,
     "relu", False),
    ((1, 23, 23, 3), 11, 8, 4, 2, 5, 8, (3, 2, 0, "max"), False, True,
     "relu", True),
]


@pytest.mark.parametrize("splits", [None, 1, 8])
@pytest.mark.parametrize("case", range(len(VIRTUAL)))
def test_emulated_virtual_kernel_matches_plain_and_reference(
        monkeypatch, case, splits):
    xs, k, cout, stride, pad, rows, kpt, pool, has_byp, first, act, pre = \
        VIRTUAL[case]
    _force_splits(monkeypatch, splits)
    rng = np.random.default_rng(case)
    x = rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal((k, k, xs[3], cout))
         * (k * k * xs[3]) ** -0.5).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    g = virtual_geometry(xs, w.shape, stride=stride, pad=pad,
                         out_rows=rows, kpt=kpt, pool=pool)
    byp = (rng.standard_normal((g.B, g.OH, g.OW, cout)).astype(np.float32)
           if has_byp else None)
    plan = conv_plan(g)
    if splits is not None:
        assert plan.splits == (1 if splits == 1 else min(
            8, 1 << (plan.k_slices.bit_length() - 1)))
    t = lambda a: None if a is None else torch.from_numpy(a)
    kw = dict(bias=t(bias), bypass=t(byp))
    got = emulate_virtual(
        t(x), t(w), g, plan, act=act, first=first,
        row_starts=prefetch_row_starts(g, "cpu") if pre else None, **kw)
    want = conv2d_virtual_plain(t(x), t(w), g, activation=act,
                                bypass_first=first, **kw)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        got.numpy(), _jax_ref(x, w, stride=stride, pad=pad, bias=bias,
                              act=act, bypass=byp, first=first, pool=pool),
        rtol=TOL, atol=TOL)


# (x shape, w shape, stride, pad, out_rows, kpt, bypass): a Cin = 3
# stride-4 conv over ragged strips, a tile spanning strips with a bypass,
# kpt = 1 strips of a 7 x 7 map.
STRIPS = [((1, 39, 39, 3), (11, 11, 3, 16), 4, 2, 4, 11, False),
          ((2, 13, 13, 16), (5, 5, 16, 16), 1, 2, 5, 2, True),
          ((1, 7, 7, 64), (3, 3, 64, 96), 1, 1, 1, 1, True)]


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("splits", [None, 1, 8])
@pytest.mark.parametrize("case", range(len(STRIPS)))
def test_emulated_strips_kernel_matches_plain_and_reference(
        monkeypatch, case, splits, first):
    xs, ws, stride, pad, rows, kpt, has_byp = STRIPS[case]
    _force_splits(monkeypatch, splits)
    rng = np.random.default_rng(10 + case)
    x = rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal(ws) * (ws[0] * ws[1] * ws[2]) ** -0.5
         ).astype(np.float32)
    bias = rng.standard_normal(ws[3]).astype(np.float32)
    g = strips_geometry(xs, ws, stride=stride, pad=pad, out_rows=rows,
                        kpt=kpt)
    byp = (rng.standard_normal((g.B, g.OH, g.OW, g.Cout)).astype(np.float32)
           if has_byp else None)
    plan = conv_plan(g)
    strips = materialize_strips(torch.from_numpy(x), g)
    sbyp = None if byp is None else strip_bypass(torch.from_numpy(byp), g)
    kw = dict(bias=torch.from_numpy(bias), bypass=sbyp)
    got = emulate_strips(strips, torch.from_numpy(w), g, plan, act="relu",
                         first=first, **kw)
    want = conv2d_strips_plain(strips, torch.from_numpy(w), g,
                               activation="relu", bypass_first=first, **kw)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    full = got.reshape(g.B, g.n_strips * g.out_rows, g.OW, g.Cout)[:, :g.OH]
    np.testing.assert_allclose(
        full.numpy(), _jax_ref(x, w, stride=stride, pad=pad, bias=bias,
                               act="relu", bypass=byp, first=first,
                               pool=None), rtol=TOL, atol=TOL)


def test_the_emulated_split_merge_is_the_same_at_any_split_count():
    """One split and eight give the same sums to f32 rounding: the split
    only regroups the 8-deep steps."""
    rng = np.random.default_rng(3)
    A = torch.from_numpy(rng.standard_normal((2, 64, 600)).astype(
        np.float32))
    B = torch.from_numpy((rng.standard_normal((600, 64)) / 25).astype(
        np.float32))
    g = strips_geometry((1, 3, 3, 600), (1, 1, 600, 64), stride=1, pad=0,
                        out_rows=3, kpt=64)
    base = conv_plan(g)
    one = dataclasses.replace(base, splits=1, kps=base.k_slices)
    eight = dataclasses.replace(base, splits=8,
                                kps=math.ceil(base.k_slices / 8))
    exact = (A.double() @ B.double()).float()
    for plan in (one, eight):
        torch.testing.assert_close(gemm_3xtf32(A, B, plan), exact,
                                   rtol=TOL, atol=TOL)
