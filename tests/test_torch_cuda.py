"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips where no CUDA card is present.  The
file imports no jax, so it runs on a machine with the card alone:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.configs import SMOLLM_360M  # noqa: E402
from repro_torch.core.dataflow import Dataflow  # noqa: E402
from repro_torch.kernels import (conv2d, decode_attention,  # noqa: E402
                                 flash_attention, matmul)
from repro_torch.kernels.conv2d.kernel import (  # noqa: E402
    conv2d_strips_cuda, conv2d_strips_plain, conv2d_virtual_cuda,
    conv2d_virtual_plain, materialize_strips, prefetch_row_starts,
    strip_bypass, strips_geometry, unstrip, virtual_geometry)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    paged_decode_attention)
from repro_torch.kernels.decode_attention.kernel import (  # noqa: E402
    decode_attention_cuda, decode_attention_plain, decode_plan,
    paged_decode_attention_cuda, paged_decode_attention_plain)
from repro_torch.kernels.flash_attention.bwd_kernel import (  # noqa: E402
    flash_attention_bwd_cuda, flash_attention_bwd_plain)
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_cuda, flash_attention_plain)
from repro_torch.kernels.mamba2 import mamba2_scan  # noqa: E402
from repro_torch.kernels.mamba2.kernel import (  # noqa: E402
    mamba2_scan_cuda, mamba2_scan_plain)
from repro_torch.kernels.matmul.kernel import (  # noqa: E402
    matmul_cuda, matmul_plain, matmul_plan)
from repro_torch.kernels.rwkv6 import wkv6  # noqa: E402
from repro_torch.kernels.rwkv6.kernel import wkv6_cuda, wkv6_plain  # noqa
from repro_torch.core import quant  # noqa: E402
from repro_torch.core import SNOWFLAKE  # noqa: E402
from repro_torch.core.quant import int8_quantize_pages  # noqa: E402
from repro_torch.configs import CNN_REGISTRY  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.models import init_params, param_defs  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.runtime import executor  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = 1e-4          # f32 sums in another order
# bf16: kernel and plain version both sum in f32 and round once to bf16,
# so they may land on neighbouring bf16 values: one ulp, <= 2^-7 relative.
BF16_TOL = 2.0 ** -7
DTYPES = {"f32": (torch.float32, TOL), "bf16": (torch.bfloat16, BF16_TOL)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (H100) and nvcc")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (x shape, k, Cout, stride, pad, out_rows, kpt, pool, bypass, first, act)
CONV = [
    ((2, 9, 9, 5), 3, 12, 1, 1, 4, 8, None, False, True, "relu"),
    ((1, 11, 10, 3), 3, 8, 2, 1, 3, 8, None, False, True, "gelu"),
    ((2, 6, 7, 16), 1, 70, 1, 0, 6, 70, None, False, True, None),
    ((1, 8, 8, 4), 3, 8, 1, 1, 3, 4, None, True, False, "silu"),
    ((1, 8, 8, 4), 3, 8, 1, 1, 8, 8, None, True, True, "relu"),
    ((2, 16, 16, 4), 3, 8, 1, 1, 16, 8, (2, 2, 0, "max"), False, True,
     "relu"),
    ((1, 13, 13, 3), 3, 8, 1, 1, 5, 8, (3, 2, 1, "max"), False, True,
     "relu"),
    ((1, 13, 13, 3), 3, 8, 1, 1, 5, 8, (3, 2, 1, "avg"), False, True,
     "tanh"),
    ((1, 23, 23, 3), 11, 8, 4, 2, 5, 8, (3, 2, 0, "max"), False, True,
     "relu"),
    # conv_plan's corners: kpt = 96 (a channel tile past a kpt tile), K =
    # 576 (18 slices: 8 splits leave the last ones empty), pooled tiles
    # ragged at the right and bottom edges (27 -> 13 pooled, 7 x 7 tiles),
    # a whole-image pooled tile, K = 900 not a multiple of BK * splits.
    ((1, 9, 9, 64), 3, 192, 1, 1, 4, 96, None, False, True, "relu"),
    ((1, 27, 27, 12), 5, 72, 1, 2, 26, 72, (3, 2, 0, "max"), False, True,
     "relu"),
    ((2, 13, 13, 36), 3, 64, 1, 1, 12, 64, (3, 2, 0, "avg"), False, True,
     "gelu"),
    ((1, 7, 7, 100), 3, 68, 1, 1, 7, 68, None, True, False, None),
]


@pytest.mark.parametrize("df", [Dataflow.MAPS_RESIDENT,
                                Dataflow.WEIGHTS_RESIDENT])
@pytest.mark.parametrize("case", range(len(CONV)))
def test_conv2d_kernel_matches_plain(dev, case, df):
    xs, k, cout, stride, pad, rows, kpt, pool, has_byp, first, act = \
        CONV[case]
    gen = torch.Generator(device=dev).manual_seed(case)
    x = torch.randn(xs, generator=gen, device=dev)
    w = torch.randn((k, k, xs[3], cout), generator=gen, device=dev) * 0.3
    b = torch.randn(cout, generator=gen, device=dev)
    g = virtual_geometry(xs, tuple(w.shape), stride=stride, pad=pad,
                         out_rows=rows, kpt=kpt, pool=pool)
    byp = (torch.randn((g.B, g.OH, g.OW, cout), generator=gen, device=dev)
           if has_byp else None)
    kw = dict(bias=b, activation=act, bypass=byp, bypass_first=first)
    n0 = conv2d_virtual_cuda.launches
    out = conv2d_virtual_cuda(x, w, g, dataflow=df, **kw)
    torch.cuda.synchronize()
    assert conv2d_virtual_cuda.launches == n0 + 1
    torch.testing.assert_close(out, conv2d_virtual_plain(x, w, g, **kw),
                               rtol=TOL, atol=TOL)


def _snowflake_convs():
    """(x shape, w shape, stride, pad, out_rows, kpt, bypass) of each
    distinct conv of the SNOWFLAKE paper-faithful alexnet-owt and
    resnet18 Programs, at batch 2."""
    cases = []
    for arch in ("alexnet-owt", "resnet18"):
        cfg = CNN_REGISTRY[arch]
        shapes = cnn.trace_shapes(cfg)
        prog = cnn.compile_program(cfg, batch=2, hw=SNOWFLAKE,
                                   paper_faithful=True)
        for op in prog.ops:
            if op.kernel != "conv2d":
                continue
            i = int(op.param_key.split("_")[1])
            h, w, c = shapes[i]
            case = ((2, h, w, c), (cfg.layers[i].k, cfg.layers[i].k, c,
                                   cfg.layers[i].c_out), op.stride, op.pad,
                    op.conv_tiling.out_rows,
                    op.conv_tiling.kernels_per_tile, op.fuse_bypass)
            if case not in cases:
                cases.append(case)
    return cases


# (x shape, w shape, stride, pad, out_rows, kpt, bypass): ragged strips,
# stride 2, pad 0 / 1 / 2 and a prime Cout.
STRIPS_RAGGED = [((1, 39, 39, 3), (11, 11, 3, 16), 4, 2, 4, 11, False),
                 ((2, 13, 13, 16), (5, 5, 16, 16), 1, 2, 5, 2, True),
                 ((1, 14, 14, 8), (1, 1, 8, 16), 2, 0, 2, 64, False),
                 ((1, 11, 9, 5), (3, 3, 5, 13), 1, 1, 4, 5, True),
                 ((2, 10, 10, 4), (5, 5, 4, 6), 2, 0, 3, 6, False),
                 ((1, 7, 7, 64), (3, 3, 64, 96), 1, 1, 1, 1, True)]
STRIPS_CASES = _snowflake_convs() + STRIPS_RAGGED


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("df", [Dataflow.MAPS_RESIDENT,
                                Dataflow.WEIGHTS_RESIDENT])
@pytest.mark.parametrize("case", range(len(STRIPS_CASES)))
def test_conv2d_strips_kernel_matches_plain(dev, case, df, first):
    xs, ws, stride, pad, rows, kpt, has_byp = STRIPS_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(case)
    x = torch.randn(xs, generator=gen, device=dev)
    w = torch.randn(ws, generator=gen, device=dev) * (
        ws[0] * ws[1] * ws[2]) ** -0.5
    b = torch.randn(ws[3], generator=gen, device=dev)
    g = strips_geometry(xs, ws, stride=stride, pad=pad, out_rows=rows,
                        kpt=kpt)
    byp = (strip_bypass(torch.randn((g.B, g.OH, g.OW, g.Cout), generator=gen,
                                    device=dev), g) if has_byp else None)
    strips = materialize_strips(x, g)
    kw = dict(bias=b, activation="relu", bypass=byp, bypass_first=first)
    n0 = conv2d_strips_cuda.launches
    out = conv2d_strips_cuda(strips, w, g, dataflow=df, **kw)
    torch.cuda.synchronize()
    assert conv2d_strips_cuda.launches == n0 + 1
    torch.testing.assert_close(out, conv2d_strips_plain(strips, w, g, **kw),
                               rtol=TOL, atol=TOL)
    torch.testing.assert_close(
        unstrip(out, g), conv2d(x, w, stride=stride, pad=pad, bias=b,
                                activation="relu", impl="reference",
                                bypass=None if byp is None
                                else unstrip(byp, g), bypass_first=first),
        rtol=TOL, atol=TOL)


def test_materialized_conv_dispatches_to_the_strips_kernel(dev):
    x = torch.randn((2, 12, 12, 4), device=dev)
    w = torch.randn((3, 3, 4, 8), device=dev)
    n_s, n_v = conv2d_strips_cuda.launches, conv2d_virtual_cuda.launches
    out = conv2d(x, w, pad=1, activation="relu", fuse_pool=(2, 2),
                 strip_storage="materialized")
    assert (conv2d_strips_cuda.launches, conv2d_virtual_cuda.launches) == (
        n_s + 1, n_v)
    torch.testing.assert_close(
        out, conv2d(x, w, pad=1, activation="relu", fuse_pool=(2, 2),
                    impl="reference"), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", range(len(CONV)))
def test_prefetched_row_starts_equal_affine_offsets_bit_for_bit(dev, case):
    xs, k, cout, stride, pad, rows, kpt, pool, has_byp, first, act = \
        CONV[case]
    gen = torch.Generator(device=dev).manual_seed(case)
    x = torch.randn(xs, generator=gen, device=dev)
    w = torch.randn((k, k, xs[3], cout), generator=gen, device=dev) * 0.3
    g = virtual_geometry(xs, tuple(w.shape), stride=stride, pad=pad,
                         out_rows=rows, kpt=kpt, pool=pool)
    byp = (torch.randn((g.B, g.OH, g.OW, cout), generator=gen, device=dev)
           if has_byp else None)
    kw = dict(activation=act, bypass=byp, bypass_first=first)
    affine = conv2d_virtual_cuda(x, w, g, **kw)
    table = conv2d_virtual_cuda(x, w, g, row_starts=prefetch_row_starts(
        g, dev), **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(table, affine, rtol=0, atol=0)


_CONV_KERNEL = importlib.import_module("repro_torch.kernels.conv2d.kernel")


def _force_splits(monkeypatch, splits: int) -> None:
    """Make conv_plan take one split (no SMs to fill) or as many as it may
    (SMs without end: one slice a split at least)."""
    monkeypatch.setattr(_CONV_KERNEL, "SMS", 0 if splits == 1 else 10 ** 9)


def _conv_call(dev, case, seed=0):
    """(zero-argument kernel call, its plain version, geometry) of CONV
    case ``case``."""
    xs, k, cout, stride, pad, rows, kpt, pool, has_byp, first, act = \
        CONV[case]
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(xs, generator=gen, device=dev)
    w = torch.randn((k, k, xs[3], cout), generator=gen, device=dev) * 0.3
    b = torch.randn(cout, generator=gen, device=dev)
    g = virtual_geometry(xs, tuple(w.shape), stride=stride, pad=pad,
                         out_rows=rows, kpt=kpt, pool=pool)
    byp = (torch.randn((g.B, g.OH, g.OW, cout), generator=gen, device=dev)
           if has_byp else None)
    kw = dict(bias=b, activation=act, bypass=byp, bypass_first=first)
    return (lambda: conv2d_virtual_cuda(x, w, g, **kw),
            lambda: conv2d_virtual_plain(x, w, g, **kw), g)


def _strips_call(dev, case, seed=0):
    xs, ws, stride, pad, rows, kpt, has_byp = STRIPS_RAGGED[case]
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(xs, generator=gen, device=dev)
    w = torch.randn(ws, generator=gen, device=dev) * (
        ws[0] * ws[1] * ws[2]) ** -0.5
    b = torch.randn(ws[3], generator=gen, device=dev)
    g = strips_geometry(xs, ws, stride=stride, pad=pad, out_rows=rows,
                        kpt=kpt)
    byp = (strip_bypass(torch.randn((g.B, g.OH, g.OW, g.Cout), generator=gen,
                                    device=dev), g) if has_byp else None)
    strips = materialize_strips(x, g)
    kw = dict(bias=b, activation="relu", bypass=byp, bypass_first=False)
    return (lambda: conv2d_strips_cuda(strips, w, g, **kw),
            lambda: conv2d_strips_plain(strips, w, g, **kw), g)


@pytest.mark.parametrize("splits", [1, 8])
@pytest.mark.parametrize("case", range(len(CONV)))
def test_conv2d_kernel_matches_plain_at_one_and_eight_splits(
        dev, monkeypatch, case, splits):
    """Every CONV case with one split, and with the most splits K allows
    (8 where K has 8 slices or more: the merge in the cluster)."""
    _force_splits(monkeypatch, splits)
    kern, plain, g = _conv_call(dev, case, seed=case)
    plan = _CONV_KERNEL.conv_plan(g)
    k_slices = plan.k_slices
    assert plan.splits == (1 if splits == 1 else
                           min(8, 1 << (k_slices.bit_length() - 1)))
    out = kern()
    torch.cuda.synchronize()
    torch.testing.assert_close(out, plain(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("splits", [1, 8])
@pytest.mark.parametrize("case", range(len(STRIPS_RAGGED)))
def test_conv2d_strips_kernel_matches_plain_at_one_and_eight_splits(
        dev, monkeypatch, case, splits):
    _force_splits(monkeypatch, splits)
    kern, plain, g = _strips_call(dev, case, seed=case)
    plan = _CONV_KERNEL.conv_plan(g)
    assert plan.splits == (1 if splits == 1 else
                           min(8, 1 << (plan.k_slices.bit_length() - 1)))
    out = kern()
    torch.cuda.synchronize()
    torch.testing.assert_close(out, plain(), rtol=TOL, atol=TOL)


def _split_conv_calls(dev):
    """A zero-copy (pooled, 8 splits) and a strips (4 splits) call as
    conv_plan gives them, as zero-argument callables."""
    kern, _, g = _conv_call(dev, 10, seed=5)
    assert _CONV_KERNEL.conv_plan(g).splits > 1
    skern, _, sg = _strips_call(dev, 5, seed=6)
    assert _CONV_KERNEL.conv_plan(sg).splits > 1
    return kern, skern


@pytest.mark.parametrize("case", range(len(CONV)))
def test_conv2d_kernel_takes_bf16(dev, case):
    """Every CONV case with bf16 maps, weights, bias and bypass: the
    products of bf16 values are exact in TF32, the sums f32, the output
    rounded to bf16 once, against the plain version's one rounding (a
    fused avg pool rounds the conv before pooling there): the bf16 rule."""
    xs, k, cout, stride, pad, rows, kpt, pool, has_byp, first, act = \
        CONV[case]
    gen = torch.Generator(device=dev).manual_seed(case)
    bf = torch.bfloat16
    x = torch.randn(xs, generator=gen, device=dev).to(bf)
    w = (torch.randn((k, k, xs[3], cout), generator=gen, device=dev)
         * 0.3).to(bf)
    b = torch.randn(cout, generator=gen, device=dev).to(bf)
    g = virtual_geometry(xs, tuple(w.shape), stride=stride, pad=pad,
                         out_rows=rows, kpt=kpt, pool=pool)
    byp = (torch.randn((g.B, g.OH, g.OW, cout), generator=gen,
                       device=dev).to(bf) if has_byp else None)
    kw = dict(bias=b, activation=act, bypass=byp, bypass_first=first)
    out = conv2d_virtual_cuda(x, w, g, **kw)
    torch.cuda.synchronize()
    assert out.dtype == bf
    torch.testing.assert_close(out.float(),
                               conv2d_virtual_plain(x, w, g, **kw).float(),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("case", range(len(STRIPS_RAGGED)))
def test_conv2d_strips_kernel_takes_bf16(dev, case):
    xs, ws, stride, pad, rows, kpt, has_byp = STRIPS_RAGGED[case]
    gen = torch.Generator(device=dev).manual_seed(case)
    bf = torch.bfloat16
    x = torch.randn(xs, generator=gen, device=dev).to(bf)
    w = (torch.randn(ws, generator=gen, device=dev)
         * (ws[0] * ws[1] * ws[2]) ** -0.5).to(bf)
    b = torch.randn(ws[3], generator=gen, device=dev).to(bf)
    g = strips_geometry(xs, ws, stride=stride, pad=pad, out_rows=rows,
                        kpt=kpt)
    byp = (strip_bypass(torch.randn((g.B, g.OH, g.OW, g.Cout), generator=gen,
                                    device=dev).to(bf), g)
           if has_byp else None)
    strips = materialize_strips(x, g)
    kw = dict(bias=b, activation="relu", bypass=byp, bypass_first=False)
    out = conv2d_strips_cuda(strips, w, g, **kw)
    torch.cuda.synchronize()
    assert out.dtype == bf
    torch.testing.assert_close(
        out.float(), conv2d_strips_plain(strips, w, g, **kw).float(),
        rtol=BF16_TOL, atol=BF16_TOL)


def test_conv_kernels_repeat_bit_for_bit(dev):
    """The splits merge in a fixed order: repeated calls, the same bits."""
    for call in _split_conv_calls(dev):
        first = call()
        for _ in range(3):
            assert torch.equal(call(), first)


def test_conv_kernels_replay_in_a_cuda_graph(dev):
    """A captured call replays equal to the eager one: the wrappers read
    nothing on the host (no sync to capture)."""
    for call in _split_conv_calls(dev):
        eager = call()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = call()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)


def test_qmatmul_on_the_card_equals_the_cpu(dev):
    gen = torch.Generator().manual_seed(0)
    a = torch.randint(-2 ** 15, 2 ** 15, (9, 300), generator=gen,
                      dtype=torch.int32).to(torch.int16)
    b = torch.randint(-2 ** 15, 2 ** 15, (300, 7), generator=gen,
                      dtype=torch.int32).to(torch.int16)
    bias = torch.randint(-300, 300, (7,), generator=gen,
                         dtype=torch.int32).to(torch.int16)
    for fmt in (quant.Q8_8, quant.Q5_11):
        cpu = quant.qmatmul(a, b, fmt, bias_q=bias, relu=True)
        card = quant.qmatmul(a.to(dev), b.to(dev), fmt,
                             bias_q=bias.to(dev), relu=True)
        assert torch.equal(card.cpu(), cpu)


@pytest.mark.parametrize("df", list(Dataflow))
@pytest.mark.parametrize("shape", [(5, 70, 45), (37, 300, 70),
                                   (8, 9216, 4096)])
def test_matmul_kernel_matches_plain(dev, shape, df):
    M, K, N = shape
    gen = torch.Generator(device=dev).manual_seed(M)
    a = torch.randn((M, K), generator=gen, device=dev)
    b = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
    bias = torch.randn(N, generator=gen, device=dev)
    byp = torch.randn((M, N), generator=gen, device=dev)
    kw = dict(bias=bias, activation="gelu", bypass=byp)
    out = matmul_cuda(a, b, dataflow=df, block=(32, 128, 64), **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, matmul_plain(a, b, **kw), rtol=TOL,
                               atol=TOL)


def test_ops_dispatch_to_the_kernels_on_cuda_tensors(dev):
    x = torch.randn((2, 12, 12, 4), device=dev)
    w = torch.randn((3, 3, 4, 8), device=dev)
    n_conv, n_mm = conv2d_virtual_cuda.launches, matmul_cuda.launches
    out = conv2d(x, w, pad=1, activation="relu", fuse_pool=(2, 2))
    ref = conv2d(x, w, pad=1, activation="relu", fuse_pool=(2, 2),
                 impl="reference")
    y = matmul(out.reshape(2, -1), torch.randn((288, 10), device=dev))
    assert conv2d_virtual_cuda.launches == n_conv + 1
    assert matmul_cuda.launches == n_mm + 1
    assert y.shape == (2, 10)
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(8, 960, 960), (8, 960, 49152),
                                   (512, 2560, 960), (37, 300, 70)])
def test_matmul_kernel_matches_plain_in_both_types(dev, shape, dt):
    dtype, tol = DTYPES[dt]
    M, K, N = shape
    gen = torch.Generator(device=dev).manual_seed(K)
    a = torch.randn((M, K), generator=gen, device=dev).to(dtype)
    b = (torch.randn((K, N), generator=gen, device=dev) * K ** -0.5).to(dtype)
    byp = torch.randn((M, N), generator=gen, device=dev).to(dtype)
    kw = dict(activation="silu", bypass=byp)
    out = matmul_cuda(a, b, **kw)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), matmul_plain(a, b, **kw).float(),
                               rtol=tol, atol=tol)


# Each matmul path against the plain version: every (M, K, N) of the
# grid in both types; the epilogue cycles over the cases so that every
# path meets bias, silu / gelu and bypass.
MATMUL_M = (1, 8, 37, 64, 65, 128, 512, 700)
MATMUL_K = (960, 300, 14336)
MATMUL_N = (70, 320, 960, 49152)
MATMUL_EPILOGUES = ({"bias": True, "activation": "gelu", "bypass": False},
                    {"bias": False, "activation": "silu", "bypass": True},
                    {"bias": True, "activation": "silu", "bypass": True},
                    {"bias": True, "activation": None, "bypass": True})
MATMUL_GRID = [(M, K, N) for M in MATMUL_M for K in MATMUL_K
               for N in MATMUL_N]


def _check_matmul_path(dev, shape, dt, epi):
    """matmul_cuda against matmul_plain on one shape, with the launch
    counted on the path matmul_plan names."""
    dtype, tol = DTYPES[dt]
    M, K, N = shape
    gen = torch.Generator(device=dev).manual_seed(M * 7 + K + N)
    a = torch.randn((M, K), generator=gen, device=dev).to(dtype)
    b = (torch.randn((K, N), generator=gen, device=dev) * K ** -0.5).to(dtype)
    kw = dict(
        bias=(torch.randn(N, generator=gen, device=dev).to(dtype)
              if epi["bias"] else None),
        activation=epi["activation"],
        bypass=(torch.randn((M, N), generator=gen, device=dev).to(dtype)
                if epi["bypass"] else None))
    path = matmul_plan(M, K, N, dtype).path
    before = dict(matmul_cuda.path_launches)
    out = matmul_cuda(a, b, dataflow=Dataflow.MAPS_RESIDENT,
                      block=(512, 1024, 1024), **kw)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in matmul_cuda.path_launches.items()
            } == {p: int(p == path) for p in before}
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), matmul_plain(a, b, **kw).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("shape", MATMUL_GRID, ids=str)
def test_matmul_paths_match_plain(dev, shape, dt):
    i = MATMUL_GRID.index(shape)      # every path meets all four epilogues
    _check_matmul_path(dev, shape, dt,
                       MATMUL_EPILOGUES[(i + i // 4) % len(MATMUL_EPILOGUES)])


# Ragged edges the grid leaves out: K and N whole 16-byte vectors but not
# whole tiles (a TMA box or a skinny stage past K or N is zero-filled),
# and the smallest aligned shapes.
MATMUL_RAGGED = [(8, 1000, 1000), (37, 1000, 1000), (65, 1000, 1000),
                 (512, 1000, 1000), (200, 264, 136), (1, 8, 8),
                 (130, 72, 8), (64, 8200, 72)]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("shape", MATMUL_RAGGED, ids=str)
def test_matmul_paths_match_plain_on_ragged_tiles(dev, shape, dt):
    i = MATMUL_RAGGED.index(shape)
    _check_matmul_path(dev, shape, dt,
                       MATMUL_EPILOGUES[i % len(MATMUL_EPILOGUES)])


def test_skinny_split_k_repeats_bit_for_bit(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    a = torch.randn((8, 960), generator=gen, device=dev).bfloat16()
    b = torch.randn((960, 320), generator=gen, device=dev).bfloat16()
    assert matmul_plan(8, 960, 320, torch.bfloat16).splits > 1
    first = matmul_cuda(a, b, activation="silu")
    for _ in range(3):
        assert torch.equal(matmul_cuda(a, b, activation="silu"), first)


# B read transposed (a tied head: the (N, K) embedding as it lies): odd N
# on skinny (M <= 64; one split at whisper-base's head, split-K at the
# narrow N) and on wgmma (M > 64), whisper-base's head shapes first.
MATMUL_BT = [(8, 512, 51865), (448, 512, 51865), (8, 960, 321),
             (37, 1000, 1001), (64, 264, 129), (65, 264, 129),
             (130, 72, 8193), (512, 1000, 1000)]


@pytest.mark.parametrize("shape", MATMUL_BT, ids=str)
def test_matmul_reads_b_transposed(dev, shape):
    """matmul_cuda on the (N, K) tensor against the plain product with
    its transpose, on the path the plan names and counted as read
    transposed; ``ops.matmul`` hands the kernel a ``w.T`` view so, with
    the same bits and no copy."""
    M, K, N = shape
    i = MATMUL_BT.index(shape)
    epi = MATMUL_EPILOGUES[i % len(MATMUL_EPILOGUES)]
    gen = torch.Generator(device=dev).manual_seed(M + K + N)
    a = torch.randn((M, K), generator=gen, device=dev).bfloat16()
    w = (torch.randn((N, K), generator=gen, device=dev)
         * K ** -0.5).bfloat16()
    kw = dict(
        bias=(torch.randn(N, generator=gen, device=dev).bfloat16()
              if epi["bias"] else None),
        activation=epi["activation"],
        bypass=(torch.randn((M, N), generator=gen, device=dev).bfloat16()
                if epi["bypass"] else None))
    plan = matmul_plan(M, K, N, torch.bfloat16, b_transposed=True)
    assert plan.path == ("skinny" if M <= 64 else "wgmma")
    before = dict(matmul_cuda.path_launches)
    n_bt = matmul_cuda.b_transposed_launches
    out = matmul_cuda(a, w, b_transposed=True, **kw)
    torch.cuda.synchronize()
    assert matmul_cuda.path_launches[plan.path] == before[plan.path] + 1
    assert matmul_cuda.b_transposed_launches == n_bt + 1
    torch.testing.assert_close(
        out.float(), matmul_plain(a, w, b_transposed=True, **kw).float(),
        rtol=BF16_TOL, atol=BF16_TOL)
    via = matmul(a, w.T, **kw)
    assert matmul_cuda.b_transposed_launches == n_bt + 2
    assert torch.equal(via, out)
    if plan.splits > 1:
        for _ in range(2):
            assert torch.equal(matmul_cuda(a, w, b_transposed=True, **kw),
                               out)


def test_flash_non_causal_over_whisper_memory(dev):
    """The non-causal flash kernel at whisper-base's encoder (1500 x 1500)
    and cross (448 x 1500) shapes with the Program's blocks: the memory
    padded to the kv block and masked by kv_len in the wrapper, on the
    mma path, against the plain version."""
    pair = transformer.compile_program_pair(REGISTRY["whisper-base"],
                                            slots=8, max_len=448)
    cross = next(op for op in pair.prefill.ops
                 if op.kernel == "cross_attention").attn
    gen = torch.Generator(device=dev).manual_seed(5)
    for Sq, Skv, blocks in ((448, 1500, (cross.block_q, cross.block_kv)),
                            (1500, 1500, (None, None))):
        q, k, v = (torch.randn((1, S, 8, 64), generator=gen, device=dev)
                   .bfloat16().transpose(1, 2) for S in (Sq, Skv, Skv))
        before = flash_attention_cuda.path_launches["mma"]
        out = flash_attention(q, k, v, causal=False, block_q=blocks[0],
                              block_kv=blocks[1], impl="cuda")
        torch.cuda.synchronize()
        assert flash_attention_cuda.path_launches["mma"] == before + 1
        ref = flash_attention(q, k, v, causal=False, impl="reference")
        torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL,
                                   atol=BF16_TOL)


def test_decode_over_a_transposed_memory_view(dev):
    """The decode kernel over whisper-base's (slots, 1500, KV, hd) encoder
    memory read through a transposed view (no copy), every row live."""
    gen = torch.Generator(device=dev).manual_seed(6)
    ck, cv = (torch.randn((8, 1500, 8, 64), generator=gen, device=dev)
              .bfloat16() for _ in range(2))
    q = torch.randn((8, 8, 64), generator=gen, device=dev).bfloat16()
    k, v = ck.transpose(1, 2), cv.transpose(1, 2)
    assert k.data_ptr() == ck.data_ptr()
    n = decode_attention_cuda.launches
    out = decode_attention(q, k, v, impl="cuda")
    torch.cuda.synchronize()
    assert decode_attention_cuda.launches == n + 1
    ref = decode_attention(q, k, v, impl="reference")
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_matmul_path_counters_of_a_smoke_lm_tick_and_admission(dev):
    """The bf16 smoke LM: every matmul of an admission (M = max_len = 128)
    runs on wgmma, every matmul of a decode tick (M = 8 slots) on skinny,
    none on simt."""
    cfg = dataclasses.replace(SMOLLM_360M.smoke(), dtype="bfloat16")
    pair = transformer.compile_program_pair(cfg, slots=8, max_len=128)
    params = init_params(transformer.param_defs(cfg),
                         torch.Generator(device=dev).manual_seed(0), dev)
    state = executor.init_program_state(pair, dev)
    n_pre = sum(op.kernel == "matmul" for op in pair.prefill.ops)
    n_dec = sum(op.kernel == "matmul" for op in pair.decode.ops)
    tokens = torch.zeros((1, 128), dtype=torch.int32, device=dev)
    tokens[0, :40] = torch.arange(1, 41, device=dev)

    def delta(fn):
        before = dict(matmul_cuda.path_launches)
        out = fn()
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all()
        return {k: v - before[k] for k, v in matmul_cuda.path_launches.items()}
    assert delta(lambda: executor.run_prefill(
        pair.prefill, params, tokens, state, 0, 40, impl="cuda")) == {
            "skinny": 0, "wgmma": n_pre, "simt": 0}
    toks = torch.ones((8,), dtype=torch.int32, device=dev)
    mask = torch.zeros((8,), dtype=torch.bool, device=dev)
    mask[0] = True
    assert delta(lambda: executor.run_decode(
        pair.decode, params, toks, state, mask, impl="cuda")) == {
            "skinny": n_dec, "wgmma": 0, "simt": 0}


# The flash path each type takes on aligned operands (flash_plan).
_PATH = {"f32": "simt", "bf16": "mma"}


def _one(path: str) -> dict:
    return {"mma": 0, "simt": 0, path: 1}


def _path_delta(fn, call):
    """``call()``'s result and the launches it added to each of ``fn``'s
    path counters."""
    before = dict(fn.path_launches)
    res = call()
    return res, {k: fn.path_launches[k] - before[k] for k in before}


def _offset(t):
    """``t`` (a (B,H,S,D) view of a (B,S,H,D) buffer) copied into a buffer
    that starts 2 bytes past a 16-byte boundary: the same values and
    layout, which the mma path cannot load in 16-byte vectors."""
    B, H, S, D = t.shape
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = buf[1:1 + t.numel()].view(B, S, H, D).transpose(1, 2)
    view.copy_(t)
    return view


# (B, Hq, Hkv, Sq, Skv, D, causal, window, kv_len)
FLASH = [(1, 15, 5, 512, 512, 64, True, None, None),
         (1, 15, 5, 512, 512, 64, True, 128, None),
         (2, 4, 2, 70, 70, 32, True, 20, None),
         (1, 8, 8, 50, 130, 128, False, None, 100),
         (1, 4, 1, 129, 129, 64, True, 64, 129)]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", range(len(FLASH)))
def test_flash_kernel_matches_plain(dev, case, dt):
    dtype, tol = DTYPES[dt]
    B, Hq, Hkv, Sq, Skv, D, causal, window, kv_len = FLASH[case]
    gen = torch.Generator(device=dev).manual_seed(case)

    def heads(S, H):                 # the executor's (B, S, H, D) layout
        return torch.randn((B, S, H, D), generator=gen, device=dev).to(
            dtype).transpose(1, 2)
    q, k, v = heads(Sq, Hq), heads(Skv, Hkv), heads(Skv, Hkv)
    kw = dict(scale=D ** -0.5, causal=causal, window=window, kv_len=kv_len)
    n0 = flash_attention_cuda.launches
    (out, lse), paths = _path_delta(
        flash_attention_cuda, lambda: flash_attention_cuda(q, k, v, **kw))
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == n0 + 1
    assert paths == _one(_PATH[dt])
    ref, ref_lse = flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=TOL, atol=TOL)


# zamba2-7b's shared block: head dim 112 on the tiles of 128; the smoke
# configs' 16 on the tiles of 32; 40 on the tiles of 64.
FLASH_D112 = [(1, 32, 32, 512, 512, 112, True, 4096, None),
              (2, 4, 2, 70, 70, 112, True, 20, None),
              (1, 2, 1, 64, 64, 40, False, None, 50)]
FLASH_BWD_D = [(2, 4, 2, 96, 96, 16, True, None, None),
               (1, 4, 4, 70, 130, 16, False, 40, 100),
               (1, 32, 32, 512, 512, 112, True, 4096, None),
               (2, 4, 2, 70, 70, 112, True, 20, None),
               (1, 2, 1, 64, 64, 40, False, None, 50)]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", range(len(FLASH_D112)))
def test_flash_kernel_takes_head_dims_past_the_multiples_of_32(dev, case,
                                                               dt):
    dtype, tol = DTYPES[dt]
    B, Hq, Hkv, Sq, Skv, D, causal, window, kv_len = FLASH_D112[case]
    gen = torch.Generator(device=dev).manual_seed(case)

    def heads(S, H):
        return torch.randn((B, S, H, D), generator=gen, device=dev).to(
            dtype).transpose(1, 2)
    q, k, v = heads(Sq, Hq), heads(Skv, Hkv), heads(Skv, Hkv)
    kw = dict(scale=D ** -0.5, causal=causal, window=window, kv_len=kv_len)
    (out, lse), paths = _path_delta(
        flash_attention_cuda, lambda: flash_attention_cuda(q, k, v, **kw))
    torch.cuda.synchronize()
    assert paths == _one(_PATH[dt])
    ref, ref_lse = flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", range(len(FLASH)))
def test_flash_bwd_kernel_matches_plain(dev, case, dt):
    """The backward kernel against its plain version on the forward
    kernel's out and lse, q / k / v / dO in the model's transposed
    (B, S, H, D) layout."""
    dtype, tol = DTYPES[dt]
    B, Hq, Hkv, Sq, Skv, D, causal, window, kv_len = FLASH[case]
    gen = torch.Generator(device=dev).manual_seed(100 + case)

    def heads(S, H):
        return torch.randn((B, S, H, D), generator=gen, device=dev).to(
            dtype).transpose(1, 2)
    q, k, v, do = heads(Sq, Hq), heads(Skv, Hkv), heads(Skv, Hkv), \
        heads(Sq, Hq)
    kw = dict(scale=D ** -0.5, causal=causal, window=window, kv_len=kv_len)
    out, lse = flash_attention_cuda(q, k, v, **kw)
    n0 = flash_attention_bwd_cuda.launches
    got, paths = _path_delta(flash_attention_bwd_cuda,
                             lambda: flash_attention_bwd_cuda(
                                 q, k, v, out, lse, do, **kw))
    torch.cuda.synchronize()
    assert flash_attention_bwd_cuda.launches == n0 + 1
    assert paths == _one(_PATH[dt])
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", range(len(FLASH_BWD_D)))
def test_flash_bwd_kernel_takes_head_dims_past_the_multiples_of_32(dev, case,
                                                                   dt):
    """The backward kernel at the smoke configs' D = 16 and zamba2-7b's
    D = 112, on the zero-filled tiles of the next multiple of 32."""
    dtype, tol = DTYPES[dt]
    B, Hq, Hkv, Sq, Skv, D, causal, window, kv_len = FLASH_BWD_D[case]
    gen = torch.Generator(device=dev).manual_seed(200 + case)

    def heads(S, H):
        return torch.randn((B, S, H, D), generator=gen, device=dev).to(
            dtype).transpose(1, 2)
    q, k, v, do = heads(Sq, Hq), heads(Skv, Hkv), heads(Skv, Hkv), \
        heads(Sq, Hq)
    kw = dict(scale=D ** -0.5, causal=causal, window=window, kv_len=kv_len)
    out, lse = flash_attention_cuda(q, k, v, **kw)
    got, paths = _path_delta(flash_attention_bwd_cuda,
                             lambda: flash_attention_bwd_cuda(
                                 q, k, v, out, lse, do, **kw))
    torch.cuda.synchronize()
    assert paths == _one(_PATH[dt])
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)


def test_flash_bwd_kernel_refuses_head_dims_past_128(dev):
    q = torch.zeros((1, 1, 8, 136), device=dev)
    with pytest.raises(ValueError, match="128"):
        flash_attention_bwd_cuda(q, q, q, q, torch.zeros((1, 1, 8),
                                                         device=dev), q,
                                 scale=1.0, causal=True, window=None,
                                 kv_len=None)


# Ragged q and kv lengths (not multiples of the 64-row tiles) with a
# kv_len and a window; every mma head-dim tile width with GQA.  Every
# query row sees at least one key: a row that sees none has no defined
# value (the plain version averages V over its own chunk, the Pallas
# kernel over its unskipped blocks, the CUDA kernels over their
# unskipped tiles).
FLASH_RAGGED = [(2, 6, 2, 129, 130, 64, False, 40, 120),
                (1, 4, 2, 70, 130, 32, True, 33, 65),
                (1, 4, 4, 70, 129, 112, True, 50, 129)]
FLASH_DIMS = [(1, 6, 2, 100, 100, D, True, None, None)
              for D in (16, 40, 64, 112, 128)]
# (case, path): the cases above run on mma in bf16 through the tests
# above (aligned operands) and on simt here; the new ones on both.
FLASH_FWD_PATHS = ([(c, "simt") for c in FLASH + FLASH_D112]
                   + [(c, path) for c in FLASH_RAGGED + FLASH_DIMS
                      for path in ("mma", "simt")])
FLASH_BWD_PATHS = ([(c, "simt") for c in FLASH + FLASH_BWD_D]
                   + [(c, path) for c in FLASH_RAGGED + FLASH_DIMS
                      for path in ("mma", "simt")])


def _flash_operands(case, dev, seed, grad: bool):
    B, Hq, Hkv, Sq, Skv, D, causal, window, kv_len = case
    gen = torch.Generator(device=dev).manual_seed(seed)

    def heads(S, H):                 # the executor's (B, S, H, D) layout
        return torch.randn((B, S, H, D), generator=gen, device=dev).to(
            torch.bfloat16).transpose(1, 2)
    ops = [heads(Sq, Hq), heads(Skv, Hkv), heads(Skv, Hkv)]
    if grad:
        ops.append(heads(Sq, Hq))
    kw = dict(scale=D ** -0.5, causal=causal, window=window, kv_len=kv_len)
    return ops, kw


@pytest.mark.parametrize("i", range(len(FLASH_FWD_PATHS)))
def test_flash_paths_match_plain_in_bf16(dev, i):
    """Both forward paths in bf16 (simt through operands 2 bytes off a
    16-byte boundary), each counted on its own path."""
    case, path = FLASH_FWD_PATHS[i]
    (q, k, v), kw = _flash_operands(case, dev, 300 + i, grad=False)
    if path == "simt":
        q, k, v = _offset(q), _offset(k), _offset(v)
    (out, lse), paths = _path_delta(
        flash_attention_cuda, lambda: flash_attention_cuda(q, k, v, **kw))
    torch.cuda.synchronize()
    assert paths == _one(path)
    ref, ref_lse = flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL,
                               atol=BF16_TOL)
    torch.testing.assert_close(lse, ref_lse, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("i", range(len(FLASH_BWD_PATHS)))
def test_flash_bwd_paths_match_plain_in_bf16(dev, i):
    """Both backward paths in bf16 on the forward kernel's out and lse,
    each counted on its own path."""
    case, path = FLASH_BWD_PATHS[i]
    (q, k, v, do), kw = _flash_operands(case, dev, 400 + i, grad=True)
    out, lse = flash_attention_cuda(q, k, v, **kw)
    if path == "simt":
        q, k, v, out, do = map(_offset, (q, k, v, out, do))
    got, paths = _path_delta(flash_attention_bwd_cuda,
                             lambda: flash_attention_bwd_cuda(
                                 q, k, v, out, lse, do, **kw))
    torch.cuda.synchronize()
    assert paths == _one(path)
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), rtol=BF16_TOL,
                                   atol=BF16_TOL)


def test_flash_mma_backward_repeats_bit_for_bit(dev):
    """Two backward calls on the same inputs at the smollm-360m training
    heads agree bit for bit: the two passes use no atomics."""
    (q, k, v, do), kw = _flash_operands(
        (2, 15, 5, 512, 512, 64, True, None, None), dev, 500, grad=True)
    out, lse = flash_attention_cuda(q, k, v, **kw)
    first, paths = _path_delta(flash_attention_bwd_cuda,
                               lambda: flash_attention_bwd_cuda(
                                   q, k, v, out, lse, do, **kw))
    second = flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert paths == _one("mma")
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_smoke_trainer_step_runs_on_the_backward_kernel(dev, tmp_path):
    """``launch.train --arch smollm-360m --smoke`` as it is (head dim 16):
    one Trainer step through the flash forward and backward kernels, and
    the same step's loss and gradients against the plain path."""
    from repro_torch.launch import train
    cfg = SMOLLM_360M.smoke()
    assert cfg.head_dim == 16
    f0, b0 = flash_attention_cuda.launches, flash_attention_bwd_cuda.launches
    res = train.main(["--arch", "smollm-360m", "--smoke", "--steps", "1",
                      "--batch", "2", "--seq", "64", "--ckpt-dir",
                      str(tmp_path), "--ckpt-every", "1"])
    torch.cuda.synchronize()
    assert res["step"] == 1
    assert np.isfinite(res["trainer"].metrics_history[0]["loss"])
    # Four layers train without remat (steps.py remats from 16 layers),
    # so one forward launch per layer.
    assert (flash_attention_cuda.launches - f0,
            flash_attention_bwd_cuda.launches - b0) == (cfg.n_layers,
                                                        cfg.n_layers)
    params = init_params(transformer.param_defs(cfg),
                         torch.Generator(device=dev).manual_seed(0), dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (2, 64), generator=gen,
                              device=dev) for k in ("tokens", "labels")}
    loss, grads = loss_and_grads(cfg, params, batch, impl="auto", remat=True)
    ref_loss, ref_grads = loss_and_grads(cfg, params, batch,
                                         impl="reference", remat=True)
    torch.testing.assert_close(loss, ref_loss, rtol=TOL, atol=TOL)
    for (g, w) in zip(_leaves(grads), _leaves(ref_grads)):
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", [(True, None, 96, 96), (True, 40, 96, 96),
                                  (False, None, 80, 150)])
def test_flash_trainable_grads_match_reference_autograd(dev, case):
    """``flash_attention`` on the card differentiates through the backward
    kernel; its gradients equal ``flash_ref``'s autograd in f32, padded
    q rows and kv rows included (block 64 does not divide 150)."""
    causal, window, Sq, Skv = case
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn(s, generator=gen, device=dev) for s in (
        (2, 6, Sq, 64), (2, 2, Skv, 64), (2, 2, Skv, 64)))
    do = torch.randn((2, 6, Sq, 64), generator=gen, device=dev)
    grads = {}
    for impl in ("cuda", "reference"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = flash_attention(*leaves, causal=causal, window=window,
                              block_q=64, block_kv=64, impl=impl)
        grads[impl] = torch.autograd.grad(out, leaves, do)
    for g, w in zip(grads["cuda"], grads["reference"]):
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)


def test_train_step_gradients_on_the_kernels_match_plain(dev):
    """A small f32 smollm (head dim 64) with remat: loss and every
    gradient through the flash kernels against the plain path, and the
    flash launches of one step (2 forward per layer under remat, 1
    backward)."""
    cfg = dataclasses.replace(SMOLLM_360M.smoke(), head_dim=64)
    params = init_params(transformer.param_defs(cfg),
                         torch.Generator(device=dev).manual_seed(0), dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (2, 96), generator=gen,
                              device=dev) for k in ("tokens", "labels")}
    f0, b0 = flash_attention_cuda.launches, flash_attention_bwd_cuda.launches
    loss, grads = loss_and_grads(cfg, params, batch, impl="auto", remat=True)
    torch.cuda.synchronize()
    assert (flash_attention_cuda.launches - f0,
            flash_attention_bwd_cuda.launches - b0) == (2 * cfg.n_layers,
                                                        cfg.n_layers)
    ref_loss, ref_grads = loss_and_grads(cfg, params, batch,
                                         impl="reference", remat=True)
    torch.testing.assert_close(loss, ref_loss, rtol=TOL, atol=TOL)
    for (g, w) in zip(_leaves(grads), _leaves(ref_grads)):
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)


def _leaves(tree):
    return [x for k in sorted(tree) for x in (
        _leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


# (B, Hq, Hkv, S, D, kv_len per sequence)
DECODE = [(8, 15, 5, 512, 64, [1, 37, 128, 200, 333, 448, 511, 512]),
          (8, 15, 5, 128, 64, [1, 5, 64, 127, 128, 128, 128, 100]),
          (3, 32, 8, 64, 128, [64, 1, 30]),
          (2, 4, 4, 16, 32, [3, 16]),
          (8, 32, 32, 512, 112, [1, 37, 128, 256, 511, 512, 512, 384]),
          (2, 6, 2, 30, 112, [30, 9]),
          # 8 splits of 32 rows: 100 ends mid-split, 64 on a boundary
          (4, 8, 2, 256, 64, [100, 64, 1, 256]),
          # 528 pairs: one split of three tiles, a cluster of one CTA
          (66, 8, 8, 96, 64, [1 + (37 * i) % 96 for i in range(66)])]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", range(len(DECODE)))
def test_decode_kernel_matches_plain(dev, case, dt):
    dtype, tol = DTYPES[dt]
    B, Hq, Hkv, S, D, lens = DECODE[case]
    if 16 // torch.tensor([], dtype=dtype).element_size() * 32 < D:
        pytest.skip(f"head dim {D} is past the {dt} kernel's row width")
    gen = torch.Generator(device=dev).manual_seed(case)
    q = torch.randn((B, Hq, D), generator=gen, device=dev).to(dtype)
    # the (slots, rows, kv heads, D) cache regions, viewed (B, Hkv, S, D)
    ck = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(dtype)
    cv = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(dtype)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    k, v = ck.transpose(1, 2), cv.transpose(1, 2)
    out = decode_attention_cuda(q, k, v, kv_len, scale=D ** -0.5)
    torch.cuda.synchronize()
    ref = decode_attention_plain(q, k, v, kv_len, scale=D ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", range(len(DECODE)))
def test_decode_kernel_takes_a_float8_cache(dev, case, dt):
    """A float8 e4m3 cache (the config's kv_dtype="float8") under an f32
    or bf16 q: the kernel widens each row to f32 in shared memory; the
    plain version reads the same float8 values as f32."""
    dtype, tol = DTYPES[dt]
    B, Hq, Hkv, S, D, lens = DECODE[case]
    gen = torch.Generator(device=dev).manual_seed(100 + case)
    q = torch.randn((B, Hq, D), generator=gen, device=dev).to(dtype)
    ck, cv = (torch.randn((B, S, Hkv, D), generator=gen, device=dev)
              .to(torch.float8_e4m3fn) for _ in range(2))
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    k, v = ck.transpose(1, 2), cv.transpose(1, 2)
    n0 = decode_attention_cuda.launches
    out = decode_attention_cuda(q, k, v, kv_len, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert decode_attention_cuda.launches == n0 + 1 and out.dtype == dtype
    ref = decode_attention_plain(q, k, v, kv_len, scale=D ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


# (B, Hq, Hkv, D, page_size, pages_per_slot, n_pages, kv_len per sequence)
PAGED = [(8, 15, 5, 64, 16, 32, 257, [1, 37, 128, 256, 511, 512, 512, 384]),
         (3, 32, 8, 128, 16, 4, 13, [64, 1, 30]),
         (2, 4, 4, 32, 4, 4, 9, [3, 16]),
         # 4 splits of 4 pages of 8 rows: 100 ends mid-split
         (4, 8, 2, 64, 8, 16, 70, [100, 64, 1, 128]),
         # 528 pairs: one split of 4 pages, a cluster of one CTA
         (66, 16, 8, 64, 16, 4, 270, [1 + (23 * i) % 64 for i in range(66)]),
         # head dims no power-of-two rule admits (zamba2-7b's 112)
         (8, 15, 5, 112, 16, 32, 257, [1, 37, 128, 256, 511, 512, 512, 384]),
         (3, 6, 2, 96, 16, 8, 30, [128, 17, 64])]
# pool type -> q types served with it
PAGED_TYPES = {"f32": ("f32",), "bf16": ("bf16",), "int8": ("f32", "bf16")}


def paged_case(dev, case, pool_dt, q_dt):
    """Pools, a table of shuffled page ids with sequence 1 sharing
    sequence 0's first two pages, and the kernel's inputs."""
    B, Hq, Hkv, D, pg, pps, n_pages, lens = PAGED[case]
    gen = torch.Generator(device=dev).manual_seed(case)
    q = torch.randn((B, Hq, D), generator=gen, device=dev).to(
        DTYPES[q_dt][0])
    kp, vp = (torch.randn((n_pages, pg, Hkv, D), generator=gen, device=dev)
              for _ in range(2))
    table = (torch.randperm(n_pages - 1, generator=gen, device=dev)[:B * pps]
             + 1).reshape(B, pps).to(torch.int32)
    table[1, :2] = table[0, :2]
    kw = {}
    if pool_dt == "int8":
        (kp, kw["k_scale"]), (vp, kw["v_scale"]) = map(int8_quantize_pages,
                                                       (kp, vp))
    else:
        kp, vp = kp.to(DTYPES[pool_dt][0]), vp.to(DTYPES[pool_dt][0])
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kp, vp, table, kv_len, kw


@pytest.mark.parametrize("types", [(p, q) for p, qs in PAGED_TYPES.items()
                                   for q in qs],
                         ids=lambda t: f"{t[0]}-pools-{t[1]}-q")
@pytest.mark.parametrize("case", range(len(PAGED)))
def test_paged_decode_kernel_matches_plain(dev, case, types):
    pool_dt, q_dt = types
    q, kp, vp, table, kv_len, kw = paged_case(dev, case, pool_dt, q_dt)
    D = q.shape[-1]
    n0 = paged_decode_attention_cuda.launches
    out = paged_decode_attention_cuda(q, kp, vp, table, kv_len,
                                      scale=D ** -0.5, **kw)
    torch.cuda.synchronize()
    assert paged_decode_attention_cuda.launches == n0 + 1
    ref = paged_decode_attention_plain(q, kp, vp, table, kv_len,
                                       scale=D ** -0.5, **kw)
    tol = DTYPES[q_dt][1]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def _decode_calls(dev):
    """The smollm-360m tick's contiguous and paged (int8 pools) calls, each
    split several ways, as zero-argument callables."""
    dtype = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(11)
    B, Hq, Hkv, S, D, lens = DECODE[0]
    q = torch.randn((B, Hq, D), generator=gen, device=dev).to(dtype)
    ck, cv = (torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(dtype)
              for _ in range(2))
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    k, v = ck.transpose(1, 2), cv.transpose(1, 2)
    assert decode_plan(B, Hq, Hkv, S, D, dtype).splits > 1
    pq, kp, vp, table, pl, kw = paged_case(dev, 0, "int8", "bf16")
    return (lambda: decode_attention_cuda(q, k, v, kv_len, scale=D ** -0.5),
            lambda: paged_decode_attention_cuda(pq, kp, vp, table, pl,
                                                scale=D ** -0.5, **kw))


def test_decode_kernels_repeat_bit_for_bit(dev):
    """The splits merge in a fixed order: two calls, the same bits."""
    for call in _decode_calls(dev):
        first = call()
        for _ in range(3):
            assert torch.equal(call(), first)


def test_decode_kernels_replay_in_a_cuda_graph(dev):
    """A captured call replays equal to the eager one: the wrappers read
    neither kv_len nor the table on the host (no sync to capture)."""
    for call in _decode_calls(dev):
        eager = call()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = call()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)


def test_paged_op_dispatches_to_the_kernel(dev):
    q, kp, vp, table, kv_len, kw = paged_case(dev, 2, "int8", "f32")
    n0 = paged_decode_attention_cuda.launches
    out = paged_decode_attention(q, kp, vp, table, kv_len=kv_len, **kw)
    assert paged_decode_attention_cuda.launches == n0 + 1
    torch.testing.assert_close(
        out, paged_decode_attention(q, kp, vp, table, kv_len=kv_len,
                                    impl="reference", **kw),
        rtol=TOL, atol=TOL)


def test_attention_ops_dispatch_to_the_kernels(dev):
    q = torch.randn((1, 4, 40, 64), device=dev)
    k = torch.randn((1, 2, 40, 64), device=dev)
    n_fl, n_de = flash_attention_cuda.launches, decode_attention_cuda.launches
    out = flash_attention(q, k, k, causal=True, block_q=512, block_kv=512)
    dec = decode_attention(q[:, :, 0], k, k,
                           kv_len=torch.tensor([7], device=dev))
    assert (flash_attention_cuda.launches, decode_attention_cuda.launches) \
        == (n_fl + 1, n_de + 1)
    torch.testing.assert_close(
        out, flash_attention(q, k, k, causal=True, impl="reference"),
        rtol=TOL, atol=TOL)
    torch.testing.assert_close(
        dec, decode_attention(q[:, :, 0], k, k, impl="reference",
                              kv_len=torch.tensor([7], device=dev)),
        rtol=TOL, atol=TOL)


def test_lm_prefill_and_decode_kernels_match_plain(dev):
    """A small f32 smollm (head dim 64, so every kernel takes it) through
    run_prefill + run_decode, kernels against plain versions, each on
    its own state."""
    cfg = dataclasses.replace(SMOLLM_360M.smoke(), head_dim=64,
                              attn_window=24)
    pair = transformer.compile_program_pair(cfg, slots=3, max_len=32)
    params = init_params(transformer.param_defs(cfg),
                         torch.Generator(device=dev).manual_seed(0), dev)
    states = {impl: executor.init_program_state(pair, dev)
              for impl in ("cuda", "reference")}
    rng = np.random.default_rng(0)
    toks = torch.zeros((3,), dtype=torch.int32, device=dev)
    for slot, n in enumerate((5, 30, 17)):
        padded = torch.zeros((1, 32), dtype=torch.int32, device=dev)
        padded[0, :n] = torch.from_numpy(rng.integers(0, cfg.vocab, n))
        outs = {impl: executor.run_prefill(pair.prefill, params, padded,
                                           st, slot, n, impl=impl)
                for impl, st in states.items()}
        torch.testing.assert_close(outs["cuda"], outs["reference"],
                                   rtol=TOL, atol=TOL)
        toks[slot] = outs["reference"][0, n - 1].argmax()
    mask = torch.tensor([True, True, False], device=dev)
    for _ in range(12):              # slot 1 wraps its 24-row ring
        outs = {impl: executor.run_decode(pair.decode, params, toks, st,
                                          mask, impl=impl)
                for impl, st in states.items()}
        torch.testing.assert_close(outs["cuda"], outs["reference"],
                                   rtol=TOL, atol=TOL)
        toks = outs["reference"].argmax(-1).to(torch.int32)
    for rid, buf in states["cuda"].caches.items():
        torch.testing.assert_close(buf, states["reference"].caches[rid],
                                   rtol=TOL, atol=TOL)


def _clone(state):
    return executor.ProgramState({r: b.clone()
                                  for r, b in state.caches.items()},
                                 state.lengths.clone())


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["f32", "int8"])
def test_lm_paged_prefill_and_decode_kernels_match_plain(dev, kv_quant):
    """The paged plan on the card: a small f32 smollm (head dim 64)
    through run_prefill + run_decode, page tables synced from a host
    PagePool; every call runs the kernels on a copy of the plain path's
    state, so both see the same pools (an int8 pool's rounding would
    otherwise amplify the kernels' last-bit differences).  Slot 1
    shares slot 0's first page, and slot 0's ring wraps onto it (a COW
    fork)."""
    cfg = dataclasses.replace(SMOLLM_360M.smoke(), head_dim=64)
    pair = transformer.compile_program_pair(cfg, slots=2, max_len=32,
                                            paged=True, page_size=8,
                                            kv_quant=kv_quant)
    params = init_params(transformer.param_defs(cfg),
                         torch.Generator(device=dev).manual_seed(0), dev)
    state = executor.init_program_state(pair, dev)
    pool = executor.PagePool(pair.paged, 2)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 27)]
    prompts.append(np.concatenate([prompts[0][:8], [1, 2, 3]]))
    toks = torch.zeros((2,), dtype=torch.int32, device=dev)
    lens = []
    for slot, prompt in enumerate(prompts):
        shared = (pool.shared_prefix_pages(0, tuple(prompts[0]),
                                           tuple(prompt)) if slot else ())
        wf = pool.admit(slot, len(prompt), shared)
        executor.sync_page_table(state, pair, pool)
        padded = torch.zeros((1, 32), dtype=torch.int32, device=dev)
        padded[0, :len(prompt)] = torch.from_numpy(prompt)
        kern_state = _clone(state)
        out = executor.run_prefill(pair.prefill, params, padded, kern_state,
                                   slot, len(prompt), wf, impl="cuda")
        ref = executor.run_prefill(pair.prefill, params, padded, state, slot,
                                   len(prompt), wf, impl="reference")
        torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)
        toks[slot] = ref[0, len(prompt) - 1].argmax()
        lens.append(len(prompt))
    forks = 0
    for _ in range(10):
        copies = [c for s in range(2)
                  if (c := pool.prepare_decode(s, lens[s])) is not None]
        forks += len(copies)
        executor.sync_page_table(state, pair, pool)
        executor.apply_page_copies(state, pair, copies)
        kern_state = _clone(state)
        out = executor.run_decode(pair.decode, params, toks, kern_state,
                                  impl="cuda")
        ref = executor.run_decode(pair.decode, params, toks, state,
                                  impl="reference")
        torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)
        toks = ref.argmax(-1).to(torch.int32)
        lens = [n + 1 for n in lens]
    assert forks > 0


# (Bt, L, H, P, N, with h0): zamba2-7b's prefill and decode shapes, an L
# that is not a multiple of the kernel's 64-step chunk, mamba2's N = 128,
# L = 2048 (32 chunks), the longest step path and the shortest chunked
# one, widths that are not multiples of 16.
SSD = [(1, 512, 112, 64, 64, False), (1, 512, 112, 64, 64, True),
       (8, 1, 112, 64, 64, True), (1, 300, 112, 64, 64, True),
       (2, 77, 40, 64, 128, True), (2, 9, 3, 16, 16, False),
       (1, 2048, 112, 64, 64, True), (3, 16, 8, 64, 64, True),
       (3, 17, 8, 64, 64, False), (2, 100, 5, 24, 40, True)]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", range(len(SSD)))
def test_mamba2_scan_kernel_matches_plain(dev, case, dt):
    """On the model's strided column slices of its conv output, with
    D-skip through the ops wrapper."""
    dtype, tol = DTYPES[dt]
    Bt, L, H, P, N, with_h0 = SSD[case]
    gen = torch.Generator(device=dev).manual_seed(case)
    xbc = torch.randn((Bt, L, H * P + 2 * N), generator=gen,
                      device=dev).to(dtype)
    x = xbc[..., :H * P].reshape(Bt, L, H, P)
    B, C = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dt_ = torch.nn.functional.softplus(
        torch.randn((Bt, L, H), generator=gen, device=dev))
    A = -torch.exp(torch.randn((H,), generator=gen, device=dev) * 0.5)
    h0 = (torch.randn((Bt, H, N, P), generator=gen, device=dev)
          if with_h0 else None)
    n0 = mamba2_scan_cuda.launches
    y, h = mamba2_scan_cuda(x, dt_, A, B, C, h0=h0)
    torch.cuda.synchronize()
    assert mamba2_scan_cuda.launches == n0 + 1
    ref_y, ref_h = mamba2_scan_plain(x, dt_, A, B, C, h0=h0)
    torch.testing.assert_close(y.float(), ref_y.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(h, ref_h, rtol=TOL, atol=TOL)
    D = torch.randn((H,), generator=gen, device=dev)
    got = mamba2_scan(x, dt_, A, B, C, D_skip=D, h0=h0)
    want = y + (D.float()[None, None, :, None] * x.float()).to(y.dtype)
    assert torch.equal(got, want)


# (B, L, H, D, with s0): rwkv6-7b's prefill and decode shapes, a short L,
# L = 2048 (32 chunks), head dims that are not powers of two (48, 96, 1)
WKV = [(1, 512, 64, 64, False), (1, 512, 64, 64, True), (8, 1, 64, 64, True),
       (2, 33, 4, 16, True), (1, 40, 2, 128, False), (3, 7, 5, 32, True),
       (1, 2048, 64, 64, True), (2, 130, 4, 48, True), (1, 70, 3, 96, False),
       (2, 20, 2, 1, True)]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", range(len(WKV)))
def test_wkv6_kernel_matches_plain(dev, case, dt):
    dtype, tol = DTYPES[dt]
    B, L, H, D, with_s0 = WKV[case]
    gen = torch.Generator(device=dev).manual_seed(case)

    def rows():
        return torch.randn((B, L, H, D), generator=gen, device=dev)
    r, k, v = (rows().to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(rows() * 0.5)).to(dtype)
    u = torch.randn((H, D), generator=gen, device=dev).to(dtype)
    s0 = (torch.randn((B, H, D, D), generator=gen, device=dev)
          if with_s0 else None)
    n0 = wkv6_cuda.launches
    y, s = wkv6_cuda(r, k, v, w, u, s0=s0)
    torch.cuda.synchronize()
    assert wkv6_cuda.launches == n0 + 1
    ref_y, ref_s = wkv6_plain(r, k, v, w, u, s0=s0)
    torch.testing.assert_close(y.float(), ref_y.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(s, ref_s, rtol=TOL, atol=TOL)
    assert torch.equal(wkv6(r, k, v, w, u, s0=s0), y)


def _recurrent_calls(dev):
    """mamba2_scan at zamba2-7b's admission (chunked) and tick (step) and
    wkv6 at rwkv6-7b's admission, bf16, as zero-argument callables."""
    gen = torch.Generator(device=dev).manual_seed(21)
    bf = torch.bfloat16
    calls = []
    for Bt, L in ((1, 512), (8, 1)):
        H, P, N = 112, 64, 64
        xbc = torch.randn((Bt, L, H * P + 2 * N), generator=gen,
                          device=dev).to(bf)
        x = xbc[..., :H * P].reshape(Bt, L, H, P)
        B, C = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
        dt_ = torch.nn.functional.softplus(
            torch.randn((Bt, L, H), generator=gen, device=dev))
        A = -torch.exp(torch.randn((H,), generator=gen, device=dev) * 0.5)
        h0 = torch.randn((Bt, H, N, P), generator=gen, device=dev)
        calls.append(lambda x=x, dt_=dt_, A=A, B=B, C=C, h0=h0:
                     mamba2_scan_cuda(x, dt_, A, B, C, h0=h0))
    r, k, v = (torch.randn((1, 512, 64, 64), generator=gen, device=dev)
               .to(bf) for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn((1, 512, 64, 64), generator=gen,
                                         device=dev) * 0.5)).to(bf)
    u = torch.randn((64, 64), generator=gen, device=dev)
    s0 = torch.randn((1, 64, 64, 64), generator=gen, device=dev)
    calls.append(lambda: wkv6_cuda(r, k, v, w, u, s0=s0))
    return calls


def test_recurrent_kernels_repeat_bit_for_bit(dev):
    """No atomics, a fixed order: repeated calls, the same bits."""
    for call in _recurrent_calls(dev):
        first = call()
        for _ in range(3):
            again = call()
            assert all(torch.equal(a, b) for a, b in zip(again, first))


def test_recurrent_kernels_replay_in_a_cuda_graph(dev):
    """A captured call (workspace from the graph's pool) replays equal to
    the eager one: the wrappers read nothing on the host."""
    for call in _recurrent_calls(dev):
        eager = call()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = call()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(captured, eager))


# (kind, shape, with the initial state): small cases of both trainable
# scans, one not a multiple of the kernels' 64-step chunk.
TRAINABLE = [("mamba2_scan", (2, 96, 6, 32, 16), False),
             ("mamba2_scan", (1, 77, 4, 64, 64), True),
             ("wkv6", (2, 96, 4, 32), False), ("wkv6", (1, 80, 3, 64), True)]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", range(len(TRAINABLE)))
def test_trainable_scans_match_chunked_autograd(dev, case, dt):
    """Under grad mode each scan op runs its CUDA kernel once through its
    autograd Function (y and the final state at the kernel's tolerance
    against its plain version, the sequential f32 recurrence) and its
    gradients in every input are autograd's through the chunked form on
    the same inputs and upstream gradients (y and the final state both
    read); the backward launches no kernel."""
    from repro_torch.kernels.mamba2.ref import mamba2_scan_chunked
    from repro_torch.kernels.rwkv6.ref import wkv6_chunked
    dtype, tol = DTYPES[dt]
    kind, shape, with_state = TRAINABLE[case]
    gen = torch.Generator(device=dev).manual_seed(300 + case)

    def randn(*sh):
        return torch.randn(sh, generator=gen, device=dev)
    if kind == "mamba2_scan":
        Bt, L, H, P, N = shape
        inputs = [randn(Bt, L, H, P).to(dtype),
                  torch.nn.functional.softplus(randn(Bt, L, H)),
                  -torch.exp(randn(H) * 0.5), randn(Bt, L, N).to(dtype),
                  randn(Bt, L, N).to(dtype),
                  randn(Bt, H, N, P) if with_state else None]
        launcher, plain = mamba2_scan_cuda, mamba2_scan_plain

        def kernel_path(*xs):
            return mamba2_scan(*xs[:5], h0=xs[5], return_state=True)

        def chunked(*xs):
            return mamba2_scan_chunked(*xs[:5], h0=xs[5], return_state=True,
                                       chunk=256)
    else:
        B, L, H, D = shape
        inputs = [randn(B, L, H, D).to(dtype) for _ in range(3)] + [
            torch.exp(-torch.exp(randn(B, L, H, D) * 0.5)).to(dtype),
            randn(H, D).to(dtype),
            randn(B, H, D, D) if with_state else None]
        launcher, plain = wkv6_cuda, wkv6_plain

        def kernel_path(*xs):
            return wkv6(*xs[:5], s0=xs[5], return_state=True)

        def chunked(*xs):
            return wkv6_chunked(*xs[:5], s0=xs[5], return_state=True)
    got_in = [None if t is None else t.clone().requires_grad_()
              for t in inputs]
    want_in = [None if t is None else t.clone().requires_grad_()
               for t in inputs]
    n0 = launcher.launches
    y, s = kernel_path(*got_in)
    y_want, s_want = chunked(*want_in)
    dy, ds = randn(*y.shape).to(dtype), randn(*s.shape)
    ((y.float() * dy.float()).sum() + (s * ds).sum()).backward()
    ((y_want.float() * dy.float()).sum() + (s_want * ds).sum()).backward()
    torch.cuda.synchronize()
    assert launcher.launches == n0 + 1
    with torch.no_grad():
        y_plain, s_plain = plain(*inputs[:5], **{
            "h0" if kind == "mamba2_scan" else "s0": inputs[5]})
    torch.testing.assert_close(y.float(), y_plain.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(s, s_plain, rtol=TOL, atol=TOL)
    for i, (a, b) in enumerate(zip(got_in, want_in)):
        if a is not None:
            scale = b.grad.float().abs().max().item()
            torch.testing.assert_close(a.grad.float(), b.grad.float(),
                                       rtol=1e-5, atol=1e-5 * scale,
                                       msg=f"input {i}")


# (B, Hq, Hkv, Sq, Skv, D): whisper's and the vlm's cross-attention as
# the wrapper hands them to the kernels: 448 (whisper) and 512 (the
# vlm) queries over 1500 / 1601 keys padded to the kv block and masked
# by kv_len, non-causal; the trainable wrapper with its padding.
FLASH_CROSS = [(2, 8, 8, 448, 1500, 64), (1, 32, 8, 512, 1601, 128),
               (2, 8, 8, 1500, 1500, 64)]


@pytest.mark.parametrize("case", range(len(FLASH_CROSS)))
def test_flash_trainable_cross_shapes_match_plain(dev, case):
    """The flash wrapper under autograd at the cross and encoder shapes
    (padded q, k and v; padded keys masked through kv_len; Sq != Skv),
    bf16 on the mma path: out and (dq, dk, dv) against ``flash_ref``'s
    autograd in f32 on the same bf16 inputs, at the bf16 tolerance of
    the result's scale; one forward and one backward launch."""
    from repro_torch.kernels.flash_attention.ref import flash_ref
    B, Hq, Hkv, Sq, Skv, D = FLASH_CROSS[case]
    gen = torch.Generator(device=dev).manual_seed(400 + case)

    def heads(S, H):
        return torch.randn((B, S, H, D), generator=gen, device=dev).to(
            torch.bfloat16).transpose(1, 2)
    q, k, v, do = heads(Sq, Hq), heads(Skv, Hkv), heads(Skv, Hkv), \
        heads(Sq, Hq)
    got = [t.clone().requires_grad_() for t in (q, k, v)]
    want = [t.float().requires_grad_() for t in (q, k, v)]
    n0 = (flash_attention_cuda.launches, flash_attention_bwd_cuda.launches)
    out = flash_attention(*got, causal=False)
    out.backward(do)
    ref = flash_ref(*want, scale=D ** -0.5, causal=False, window=None,
                    kv_len=None)
    ref.backward(do.float())
    torch.cuda.synchronize()
    assert (flash_attention_cuda.launches,
            flash_attention_bwd_cuda.launches) == (n0[0] + 1, n0[1] + 1)
    for g, w in ((out, ref), *((a.grad, b.grad) for a, b in zip(got,
                                                                  want))):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        scale = w.abs().max().item()
        torch.testing.assert_close(g.float(), w, rtol=BF16_TOL,
                                   atol=BF16_TOL * scale)


@pytest.mark.parametrize("name", ["zamba2-7b", "mamba2", "rwkv6-7b"])
def test_family_prefill_and_decode_kernels_match_plain(dev, name):
    """A small f32 config of each recurrent family through run_prefill +
    run_decode, kernels against plain versions, each on its own state;
    the scan kernel launches once per mamba layer per call, wkv6 once per
    rwkv layer per prefill and never in a decode tick."""
    cfg = REGISTRY[name].smoke()
    pair = transformer.compile_program_pair(cfg, slots=3, max_len=32)
    params = init_params(param_defs(cfg),
                         torch.Generator(device=dev).manual_seed(0), dev)
    states = {impl: executor.init_program_state(pair, dev)
              for impl in ("cuda", "reference")}
    rng = np.random.default_rng(0)
    toks = torch.zeros((3,), dtype=torch.int32, device=dev)
    counter = wkv6_cuda if cfg.family == "ssm" else mamba2_scan_cuda
    n0 = counter.launches
    for slot, n in enumerate((5, 30, 17)):
        padded = torch.zeros((1, 32), dtype=torch.int32, device=dev)
        padded[0, :n] = torch.from_numpy(rng.integers(0, cfg.vocab, n))
        outs = {impl: executor.run_prefill(pair.prefill, params, padded,
                                           st, slot, n, impl=impl)
                for impl, st in states.items()}
        torch.testing.assert_close(outs["cuda"], outs["reference"],
                                   rtol=TOL, atol=TOL)
        toks[slot] = outs["reference"][0, n - 1].argmax()
    assert counter.launches == n0 + 3 * cfg.n_layers
    mask = torch.tensor([True, True, False], device=dev)
    for _ in range(6):               # slot 1 passes max_len
        outs = {impl: executor.run_decode(pair.decode, params, toks, st,
                                          mask, impl=impl)
                for impl, st in states.items()}
        torch.testing.assert_close(outs["cuda"], outs["reference"],
                                   rtol=TOL, atol=TOL)
        toks = outs["reference"].argmax(-1).to(torch.int32)
    per_tick = 0 if cfg.family == "ssm" else cfg.n_layers
    assert counter.launches == n0 + 3 * cfg.n_layers + 6 * per_tick
    for rid, buf in states["cuda"].caches.items():
        torch.testing.assert_close(buf, states["reference"].caches[rid],
                                   rtol=TOL, atol=TOL)


# --- the CUDA-graph runners (executor.graphed_*runner) ----------------------------
def _twin(state):
    return executor.ProgramState(
        {r: t.clone() for r, t in state.caches.items()}, state.lengths.clone())


def _same(a, b, pair):
    """Bitwise equal states; a paged plan's null page 0 (the sink of
    masked writes, whose last writer is not defined) left out."""
    assert torch.equal(a.lengths, b.lengths)
    n = pair.paged.n_pages if pair.paged is not None else None
    for rid in a.caches:
        x, y = a.caches[rid], b.caches[rid]
        if n is not None and x.shape[0] == n:
            x, y = x[1:], y[1:]
        assert torch.equal(x, y), rid


def _counts():
    return {fn: (fn.launches, dict(getattr(fn, "path_launches", {})))
            for fn in executor._counted_kernels()}


def _added(before):
    return {fn.__name__: fn.launches - n for fn, (n, _) in before.items()
            if fn.launches != n}


# (config, overrides, pair kw, chunkable)
GRAPH_PLANS = {
    "contiguous": ("smollm-360m", {"dtype": "bfloat16"}, {}, True),
    "windowed": ("smollm-360m", {"dtype": "bfloat16", "attn_window": 48},
                 {}, True),
    "paged": ("smollm-360m", {"dtype": "bfloat16"},
              {"paged": True, "page_size": 16}, True),
    "int8": ("smollm-360m", {"dtype": "bfloat16"},
             {"paged": True, "page_size": 16, "kv_quant": "int8"}, False),
    "zamba2-7b": ("zamba2-7b", {}, {}, False),
    "rwkv6-7b": ("rwkv6-7b", {}, {}, False),
}


@pytest.mark.parametrize("plan", sorted(GRAPH_PLANS))
def test_graphed_runs_equal_the_eager_runs_bit_for_bit(dev, plan):
    """Three admissions, seven decode ticks and (where the plan is
    chunkable) chunk runs at B = 1 and B = 3 through the graphed
    runners, each call's logits and the state after it bitwise equal to
    the eager call's on a twin state; over the last five ticks (pure
    replays) each kernel's launches are exactly five times its ops per
    tick."""
    name, over, kw, chunkable = GRAPH_PLANS[plan]
    cfg = dataclasses.replace(REGISTRY[name].smoke(), **over)
    slots, max_len = 4, 128
    pair = transformer.compile_program_pair(cfg, slots=slots,
                                            max_len=max_len, **kw)
    params = init_params(param_defs(cfg),
                         torch.Generator(device=dev).manual_seed(0), dev)
    state = executor.init_program_state(pair, dev)
    eager = executor.init_program_state(pair, dev)
    pool = executor.PagePool(pair.paged, slots) if pair.paged else None
    pre = executor.graphed_prefill_runner(pair.prefill)
    dec = executor.graphed_decode_runner(pair.decode)
    chunk = executor.graphed_chunk_runner(pair.prefill)
    rng = np.random.default_rng(0)

    def both(runner, *args):
        """The graphed call (and the launches it added), then the eager
        one on the twin state."""
        before = _counts()
        out = runner(params, args[0], state, *args[1:])
        added = _added(before)
        with executor.disable_graphs():
            want = runner(params, args[0], eager, *args[1:])
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        _same(state, eager, pair)
        return out, added

    def sync():
        for st in (state, eager):
            st.caches[pair.page_table_region].copy_(
                torch.from_numpy(pool.table))

    last = torch.zeros((slots,), dtype=torch.int32)
    for slot, n in enumerate((40, 100, 7)):
        prompt = rng.integers(0, cfg.vocab, n)
        if pool is not None:
            pool.admit(slot, n)
            sync()
        padded = torch.zeros((1, max_len), dtype=torch.int32)
        padded[0, :n] = torch.from_numpy(prompt)
        out, _ = both(pre, padded, slot, n, 0)
        last[slot] = int(out[0, n - 1].argmax())
    mask = torch.tensor([True, True, True, False])
    lens = [40, 100, 7]
    replays = {}
    for step in range(7):
        if pool is not None:
            for s in range(3):
                pool.prepare_decode(s, lens[s])
            sync()
        out, added = both(dec, last, mask)
        if step == 1:
            captured = dict(state.graphs.graphs)
        for k, v in added.items():
            replays[k] = replays.get(k, 0) + v * (step >= 2)
        last = out.argmax(-1).to(torch.int32).cpu()
        lens = [n + 1 for n in lens]
    ops = {"matmul": "matmul_cuda", "decode_attention": (
        "paged_decode_attention_cuda" if pool is not None
        else "decode_attention_cuda"), "ssm_scan": "mamba2_scan_cuda"}
    want = {}
    for op in pair.decode.ops:
        if op.kernel in ops:
            want[ops[op.kernel]] = want.get(ops[op.kernel], 0) + 5
    assert replays == want
    assert state.graphs.graphs == captured
    if chunkable:
        for width, first in ((1, 3), (3, 0)):
            slots_b = list(range(first, first + width))
            tokens = torch.zeros((width, max_len), dtype=torch.int32)
            tokens[:, :50] = torch.from_numpy(
                rng.integers(0, cfg.vocab, (width, 50)))
            if pool is not None:
                for s in slots_b:
                    pool.release(s)
                    pool.admit(s, 50)
                sync()
            for start in range(0, 50, 16):
                stop = min(start + 16, 50)
                both(chunk, tokens, slots_b, [start] * width,
                     [stop] * width, [50] * width)
        widths = {k[3][0][0][0] for k, g in state.graphs.graphs.items()
                  if k[2] == "chunk" and g is not None}
        assert widths == {1, 3}


def test_a_graphed_paged_tick_reads_a_new_table_without_recapture(dev):
    """A captured paged decode tick, then a COW fork (a shared page
    copied to a fresh one) and a table change synced in place: the next
    replay writes and reads through the new table, bitwise equal to the
    eager tick, and no graph is captured anew."""
    cfg = dataclasses.replace(SMOLLM_360M.smoke(), dtype="bfloat16")
    pair = transformer.compile_program_pair(cfg, slots=2, max_len=64,
                                            paged=True, page_size=8)
    params = init_params(param_defs(cfg),
                         torch.Generator(device=dev).manual_seed(1), dev)
    state = executor.init_program_state(pair, dev)
    eager = executor.init_program_state(pair, dev)
    pool = executor.PagePool(pair.paged, 2)
    pre = executor.graphed_prefill_runner(pair.prefill)
    dec = executor.graphed_decode_runner(pair.decode)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab, 20)
    lens = [20, 20]
    for slot in range(2):            # slot 1 shares slot 0's two pages
        shared = pool.shared_prefix_pages(0, tuple(prompt), tuple(prompt)) \
            if slot else ()
        wf = pool.admit(slot, 20, shared)
        padded = torch.zeros((1, 64), dtype=torch.int32)
        padded[0, :20] = torch.from_numpy(prompt)
        for st in (state, eager):
            st.caches[pair.page_table_region].copy_(
                torch.from_numpy(pool.table))
            with executor.disable_graphs() if st is eager else \
                    contextlib.nullcontext():
                pre(params, padded, st, slot, 20, wf)
    toks = torch.tensor([3, 4], dtype=torch.int32)

    def tick():
        copies = [c for s in range(2)
                  if (c := pool.prepare_decode(s, lens[s])) is not None]
        for st in (state, eager):
            st.caches[pair.page_table_region].copy_(
                torch.from_numpy(pool.table))
            executor.apply_page_copies(st, pair, copies)
        out = dec(params, toks, state)
        with executor.disable_graphs():
            want = dec(params, toks, eager)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        _same(state, eager, pair)
        for s in range(2):
            lens[s] += 1
        return copies
    tick()
    tick()                            # captured here
    graphs = dict(state.graphs.graphs)
    # Rewind slot 1 into its shared pages: its next write forks one.
    lens[1] = 9
    for st in (state, eager):
        st.lengths[1] = 9
    assert tick()                     # a COW fork, a new table row
    assert state.graphs.graphs == graphs


def test_graphed_cnn_run_equals_the_eager_run(dev):
    """``cnn.forward`` (alexnet-owt, batch 2) through ``graphed_runner``:
    the replays bitwise equal to the eager run on the same input, and 5
    replays add exactly 5 x its conv and matmul launches."""
    cfg = CNN_REGISTRY["alexnet-owt"]
    params = init_params(cnn.param_defs(cfg),
                         torch.Generator(device=dev).manual_seed(2), dev)
    program = cnn.compile_program(cfg, batch=2)
    x = torch.randn((2, 224, 224, 3), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3))
    with executor.disable_graphs():
        want = cnn.forward(params, x, cfg)
    for _ in range(2):                # eager, then captured + replayed
        assert torch.equal(cnn.forward(params, x, cfg), want)
    inputs = [x if i % 2 == 0 else x.flip(0) for i in range(5)]
    before = _counts()
    outs = [cnn.forward(params, y, cfg) for y in inputs]
    torch.cuda.synchronize()
    kinds = [op.kernel for op in program.ops]
    assert _added(before) == {
        "conv2d_virtual_cuda": 5 * kinds.count("conv2d"),
        "matmul_cuda": 5 * kinds.count("matmul")}
    with executor.disable_graphs():
        for y, out in zip(inputs, outs):
            assert torch.equal(out, cnn.forward(params, y, cfg))


# --- the compiled train step and the MoE dispatch on the card ----------------------
@pytest.mark.parametrize("name", ["smollm-360m", "granite-moe-1b-a400m"])
def test_graphed_train_step_equals_eager_bit_for_bit(dev, name):
    """Three steps of the smoke config in bf16 through the compiled step
    (eager, captured and replayed, replayed) and three under
    ``disable_graphs()``: metrics, params and moments bit for bit, the
    state at its old addresses, one graph captured."""
    from repro_torch.checkpoint import tree_leaves
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import AdamW
    cfg = dataclasses.replace(REGISTRY[name].smoke(), dtype="bfloat16")
    gen = torch.Generator(dev).manual_seed(0)
    batches = [{k: torch.randint(0, cfg.vocab, (2, 64), generator=gen,
                                 device=dev) for k in ("tokens", "labels")}
               for _ in range(3)]
    runs = []
    for graphed in (True, False):
        opt = AdamW(state_bits=8)
        params = init_params(param_defs(cfg),
                             torch.Generator(dev).manual_seed(1))
        state = opt.init(params)
        ptrs = [t.data_ptr() for t in tree_leaves((params, state))]
        step = build_train_step(cfg, opt)
        with (contextlib.nullcontext() if graphed
              else executor.disable_graphs()):
            metrics = [step(params, state, b)[2] for b in batches]
        assert [t.data_ptr() for t in tree_leaves((params, state))] == ptrs
        assert len([g for g in step.graphs.graphs.values()
                    if g is not None]) == (1 if graphed else 0)
        runs.append((metrics, tree_leaves((params, state))))
    (mg, lg), (me, le) = runs
    for a, b in zip(mg, me):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16
                           else x, y.view(torch.int16)
                           if y.dtype == torch.bfloat16 else y)
               for x, y in zip(lg, le))


def test_moe_dispatch_replays_in_a_cuda_graph(dev):
    """``moe_mlp`` at granite's width (32 experts, top-8, a 512-row
    right-padded prefill block with ``valid_count`` a device tensor)
    captured in a CUDA graph: each replay equals the eager call bit for
    bit on new inputs."""
    from repro_torch.models.moe import moe_mlp
    gen = torch.Generator(dev).manual_seed(2)
    T, D, E, F = 512, 1024, 32, 512
    rnd = lambda *s: (torch.randn(s, generator=gen, device=dev)  # noqa
                      * s[-2] ** -0.5).to(torch.bfloat16)
    x, ws = rnd(T, D), [rnd(D, E), rnd(E, D, F), rnd(E, D, F), rnd(E, F, D)]
    vc = torch.tensor([300], dtype=torch.int32, device=dev)
    fn = lambda: moe_mlp(x, *ws, top_k=8, valid_count=vc)  # noqa: E731
    fn()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out, aux = fn()
    for n in (300, 17, 512):
        x.copy_(rnd(T, D))
        vc.fill_(n)
        g.replay()
        want, waux = fn()
        assert torch.equal(out, want)
        assert all(torch.equal(aux[k], waux[k]) for k in aux)


def _smoke_engine(dev, **kw):
    """smollm-360m-smoke in bf16 (2 layers) served off the graphed runners
    on the card: 3 requests on 2 slots, 6 new tokens each."""
    from repro_torch.serving import Request, ServingEngine
    cfg = dataclasses.replace(REGISTRY["smollm-360m"].smoke(),
                              dtype="bfloat16", n_layers=2)
    params = init_params(param_defs(cfg),
                         torch.Generator(device=dev).manual_seed(0), dev)
    eng = ServingEngine(cfg, params, slots=2, max_len=64, device=dev, **kw)
    rng = np.random.default_rng(0)
    for i, n in enumerate((5, 30, 12)):
        eng.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab, n)
                           .astype(np.int32), max_new_tokens=6))
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    return eng, {r.uid: r.out_tokens for r in done}


def test_trace_program_times_each_op_once_per_repeat_on_the_card(dev):
    """``trace_program`` on a bf16 decode state on the card: each
    kernel op launches 1 + repeats times, every record has a measured
    time, the walk's state is bitwise what one eager ``run_decode``
    leaves, and the caller's state (what captured graphs read) is
    untouched."""
    cfg = dataclasses.replace(REGISTRY["smollm-360m"].smoke(),
                              dtype="bfloat16", n_layers=2)
    pair = transformer.compile_program_pair(cfg, slots=4, max_len=64)
    params = init_params(param_defs(cfg),
                         torch.Generator(device=dev).manual_seed(1), dev)
    state = executor.init_program_state(pair, dev)
    for buf in state.caches.values():
        buf.normal_()
    state.lengths.copy_(torch.tensor([3, 0, 40, 63], dtype=torch.int32))
    kept = {r: t.clone() for r, t in state.caches.items()}
    tokens = torch.tensor([1, 2, 3, 4], dtype=torch.int32, device=dev)
    mask = torch.tensor([True, False, True, True], device=dev)
    before = _counts()
    trace = executor.trace_program(pair.decode, params, tokens, repeats=3,
                                   state=state, mask=mask)
    added = _added(before)
    want = {}
    for op in pair.decode.ops:
        name = {"matmul": "matmul_cuda",
                "decode_attention": "decode_attention_cuda"}.get(op.kernel)
        if name:
            want[name] = want.get(name, 0) + 4
    assert added == want
    assert all(r.measured_time_s > 0 for r in trace.records)
    for rid, t in kept.items():
        assert torch.equal(state.caches[rid], t), rid
    twin = executor.ProgramState({r: t.clone() for r, t in kept.items()},
                                 state.lengths.clone())
    with executor.disable_graphs():
        executor.run_decode(pair.decode, params, tokens, twin, mask)
    _same(trace.state, twin, pair)


def test_sampled_engine_equals_the_unsampled_one_on_the_card(dev):
    """Every tick sampled, plain and speculative: the graphed engine's
    streams and every byte of its state(s) equal the unsampled run's;
    ``op_time_us`` holds the matmul and decode-attention kernels' times."""
    from repro_torch.obs import Observability
    for spec_k in (0, 3):
        base, want = _smoke_engine(dev, spec_k=spec_k)
        eng, got = _smoke_engine(dev, spec_k=spec_k,
                                 obs=Observability(sample_ops_every=1))
        assert got == want
        assert eng._op_sampler.n_samples == eng.n_decode_ticks > 0
        _same(eng.state, base.state, eng.program)
        if spec_k:
            _same(eng._draft_state, base._draft_state, eng.program)
        hist = eng.obs.registry.snapshot()["histograms"]
        for kind in ("matmul", "decode_attention"):
            h = hist[f'op_time_us{{kind="{kind}"}}']
            assert h["count"] > 0 and h["sum"] > 0


def test_speculative_engine_graphed_equals_eager_on_the_card(dev):
    """Self-draft speculation off the graphed runners: the streams equal
    the eager engine's; both states keep their
    ``lengths`` tensors (rollback copies in place) and the verify ran
    off captured chunk graphs."""
    eng, got = _smoke_engine(dev, spec_k=3)
    ptrs = (eng.state.lengths.data_ptr(), eng._draft_state.lengths.data_ptr())
    with executor.disable_graphs():
        _, eager = _smoke_engine(dev, spec_k=3)
    assert got == eager
    assert eng.n_spec_accepted > 0
    assert ptrs[0] != ptrs[1]
    assert any(k[2] == "chunk" and g is not None
               for k, g in eng.state.graphs.graphs.items())
    assert any(k[2] == "decode" and g is not None
               for k, g in eng._draft_state.graphs.graphs.items())
    assert eng.capture_seconds > 0


# --- the autotuner on the card: replays, launch keys, the device clock --------------
@pytest.mark.parametrize("order", ["kloop", "mloop"])
@pytest.mark.parametrize("storage", ["virtual", "materialized"])
def test_conv_replay_under_each_storage_and_order_matches_plain(
        dev, storage, order):
    """Every conv of the alexnet-owt batch-2 Program replayed from its
    trace record with a candidate of each strip storage and loop order:
    the kernel (the storage's own: zero-copy or strips) against the
    plain version on the same seeded operands, within 1e-4."""
    from repro_torch.core import TPU_V5E, autotune
    from repro_torch.runtime import replay
    cfg = CNN_REGISTRY["alexnet-owt"]
    prog = cnn.compile_program(cfg, batch=2)
    params = init_params(cnn.param_defs(cfg),
                         torch.Generator(device=dev).manual_seed(0), dev)
    x = torch.randn((2, 224, 224, 3), device=dev)
    trace = executor.trace_program(prog, params, x, measure=False)
    graph = cnn.to_graph(cfg, batch=2, dtype_bytes=4)
    graph.mark_residuals()
    graph.mark_pool_fusion()
    nodes = {n.name: n for n in graph}
    kernel = {"virtual": conv2d_virtual_cuda,
              "materialized": conv2d_strips_cuda}[storage]
    n = 0
    for rec in trace.records:
        if rec.kind != "conv2d":
            continue
        cand = next(c for c in autotune.enumerate_candidates(
            nodes[rec.name], TPU_V5E) if c["strip_storage"] == storage
            and c["dataflow"] == order)
        rc = autotune.entry_to_replay_candidate(nodes[rec.name], cand,
                                                TPU_V5E)
        n0 = kernel.launches
        got = replay.replay_outputs(rec, candidate=rc, impl="cuda", seed=4)
        want = replay.replay_outputs(rec, candidate=rc, impl="reference",
                                     seed=4)
        torch.cuda.synchronize()
        assert kernel.launches == n0 + 1, rec.name
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
        n += 1
    assert n == 5


def _bf16_smoke(n_layers=2):
    return dataclasses.replace(REGISTRY["smollm-360m"].smoke(),
                               dtype="bfloat16", n_layers=n_layers)


def test_launch_key_merges_a_skinny_matmuls_candidates(dev):
    """Tuning a bf16 decode Program at 4 slots on the card: every
    matmul (the skinny path) and decode op measures one launch for all
    its candidates, and the incumbent keeps its place."""
    from repro_torch.core import autotune
    rep = autotune.tune_lm_decode(_bf16_smoke(), slots=4, max_len=64,
                                  top_k=3, repeats=2, device=dev)
    measured = [r for r in rep.results if not r.cached]
    assert {r.kind for r in measured} == {"matmul", "decode_attention"}
    for r in measured:
        assert r.measurements == 1 and r.candidates >= 2, r.name
        # one launch, one time: only lower modeled traffic moves a winner
        assert r.winner_time_s == r.incumbent_time_s > 0, r.name
    assert rep.n_measurements == len(measured)
    assert rep.error_rows


def test_device_clock_reads_a_decode_op_near_its_kernels(dev):
    """smollm-360m's decode attention (full width, 8 slots, 512 rows, two
    layers): on the device clock the op reads tens of microseconds --
    its kernels -- in the trace and in a replay, where the host clock
    reads its eager dispatch, several times more."""
    from repro_torch.runtime import replay
    cfg = dataclasses.replace(REGISTRY["smollm-360m"], n_layers=2)
    pair = transformer.compile_program_pair(cfg, slots=8, max_len=512)
    params = init_params(param_defs(cfg),
                         torch.Generator(device=dev).manual_seed(2), dev)
    state = executor.init_program_state(pair, dev)
    for buf in state.caches.values():
        buf.normal_()
    state.lengths.copy_(torch.arange(8, dtype=torch.int32) * 60 + 30)
    tokens = torch.arange(8, dtype=torch.int32, device=dev)
    times = {}
    for clock in ("device", "host"):
        trace = executor.trace_program(pair.decode, params, tokens,
                                       repeats=5, clock=clock, state=state)
        times[clock] = min(r.measured_time_s for r in trace.records
                           if r.kind == "decode_attention")
    rec = next(r for r in trace.records if r.kind == "decode_attention")
    _, t_replay = replay.replay_record(rec, repeats=5, device=dev)
    assert 0 < times["device"] < 150e-6, times
    assert 0 < t_replay < 150e-6, t_replay
    assert times["host"] > 3 * times["device"], times
