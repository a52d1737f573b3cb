"""The paper-faithful materialized-strip conv of the port against
``repro``'s: the strip copy bit for bit, the strip geometry and dataflow
as ``repro``'s conv2d hands them to ``conv2d_strips_pallas`` (a spy in
its place, every conv of the SNOWFLAKE and TPU_V5E paper-faithful
alexnet-owt and resnet18 Programs at full width), the plain version
against the Pallas kernel in interpret mode, the wrapper's composition
(copy, strips, unstrip) against the conv oracle, and the zero-copy
kernel's prefetched ``row_starts`` table against the one ``repro``
builds."""
import importlib
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.dataflow import Dataflow as JaxDataflow  # noqa: E402
from repro.core.tiling import ConvTiling as JaxConvTiling  # noqa: E402
from repro.kernels.conv2d.kernel import conv2d_strips_pallas  # noqa: E402

from repro_torch.core import SNOWFLAKE, TPU_V5E  # noqa: E402
from repro_torch.core.dataflow import Dataflow  # noqa: E402
from repro_torch.kernels.conv2d import conv2d_ref  # noqa: E402
from repro_torch.kernels.conv2d.kernel import (  # noqa: E402
    conv2d_strips_cuda, conv2d_strips_plain, conv_plan, launch_args,
    materialize_strips, plan_args, prefetch_row_starts, strip_bypass,
    strips_geometry, strips_launch_args, unstrip, virtual_geometry)
from repro_torch.kernels.conv2d.ops import (conv2d, norm_pool,  # noqa: E402
                                            strips_plan)
from repro_torch.models import cnn  # noqa: E402

from test_torch_compiler import _configs, _spy_cases  # noqa: E402

jax_conv_ops = importlib.import_module("repro.kernels.conv2d.ops")
TOL = 1e-4          # the interpret-mode comparisons' tolerance


def _jax_tiling(t):
    return JaxConvTiling(out_rows=t.out_rows, in_rows=t.in_rows,
                         kernels_per_tile=t.kernels_per_tile,
                         vmem_bytes=t.vmem_bytes,
                         n_map_tiles=t.n_map_tiles,
                         n_kernel_tiles=t.n_kernel_tiles,
                         overlap_frac=t.overlap_frac,
                         strip_storage=t.strip_storage)


def _program_convs():
    """(arch, hw name, op, x shape, w shape) of every conv of the
    paper-faithful Programs at full width (batch 2)."""
    out = []
    for arch in ("alexnet-owt", "resnet18"):
        cfg, _ = _configs(arch)
        shapes = cnn.trace_shapes(cfg)
        for hw in (SNOWFLAKE, TPU_V5E):
            prog = cnn.compile_program(cfg, batch=2, hw=hw,
                                       paper_faithful=True)
            for op in prog.ops:
                if op.kernel != "conv2d":
                    continue
                layer = cfg.layers[int(op.param_key.split("_")[1])]
                h, w, c = shapes[int(op.param_key.split("_")[1])]
                out.append((arch, hw.name, op, (2, h, w, c),
                            (layer.k, layer.k, c, layer.c_out)))
    return out


PROGRAM_CONVS = _program_convs()


def test_the_paper_faithful_programs_materialize_every_conv():
    kinds = {}
    for arch, hw, op, _, _ in PROGRAM_CONVS:
        assert op.strip_storage == "materialized"
        kinds[(arch, hw)] = kinds.get((arch, hw), 0) + 1
    assert kinds == {("alexnet-owt", "snowflake"): 5,
                     ("alexnet-owt", "tpu_v5e"): 5,
                     ("resnet18", "snowflake"): 20,
                     ("resnet18", "tpu_v5e"): 20}


@pytest.mark.parametrize("case", range(len(PROGRAM_CONVS)),
                         ids=[f"{a}-{h}-{op.name}"
                              for a, h, op, _, _ in PROGRAM_CONVS])
def test_strips_geometry_matches_reference_kernel_args(case, monkeypatch):
    _, _, op, xs, ws = PROGRAM_CONVS[case]
    seen = {}

    def spy(strips, w, **kw):
        seen.update(kw, strips_shape=strips.shape,
                    bypass_shape=None if kw["bypass"] is None
                    else kw["bypass"].shape)
        return jnp.zeros((strips.shape[0], kw["out_rows"], kw["OW"],
                          w.shape[-1]), strips.dtype)

    monkeypatch.setattr(jax_conv_ops, "conv2d_strips_pallas", spy)
    t = op.conv_tiling
    oh = (xs[1] + 2 * op.pad - ws[0]) // op.stride + 1
    ow = (xs[2] + 2 * op.pad - ws[1]) // op.stride + 1
    byp = (jnp.zeros((xs[0], oh, ow, ws[3])) if op.fuse_bypass else None)
    out = jax_conv_ops.conv2d(
        jnp.zeros(xs, jnp.float32), jnp.zeros(ws, jnp.float32),
        stride=op.stride, pad=op.pad, bypass=byp, impl="pallas",
        tiling=_jax_tiling(t), strip_storage=op.strip_storage)
    g, dataflow = strips_plan(xs, ws, stride=op.stride, pad=op.pad,
                              tiling=t, dataflow=None)
    assert tuple(seen["strips_shape"]) == (g.NS, g.in_rows, g.Wp, g.Cin)
    assert (g.out_rows, g.OW, g.stride, g.kpt) == (
        seen["out_rows"], seen["OW"], seen["stride"], seen["kpt"])
    assert dataflow.value == seen["dataflow"].value
    assert seen["bypass_shape"] == (
        None if byp is None else (g.NS, g.out_rows, g.OW, g.Cout))
    assert tuple(out.shape) == (xs[0], g.OH, g.OW, g.Cout)
    assert (g.n_strips - 1) * g.out_rows * g.stride + g.in_rows <= g.Hp


# (x shape, k, Cout, stride, pad, out_rows, kpt, bypass, first, act): the
# SNOWFLAKE convs' kh, stride, pad, out_rows and kpt with channels cut to
# <= 16 and the maps to a few strips, plus ragged, pad-0 and prime cases.
STRIPS = [
    ((1, 39, 39, 3), 11, 16, 4, 2, 4, 11, False, True, "relu"),   # alex 0
    ((2, 13, 13, 16), 5, 16, 1, 2, 5, 2, False, True, "relu"),    # alex 2
    ((1, 13, 13, 16), 3, 12, 1, 1, 4, 2, False, True, "relu"),    # alex 4
    ((1, 13, 13, 12), 3, 8, 1, 1, 1, 1, False, True, "relu"),     # alex 5
    ((1, 13, 13, 8), 3, 8, 1, 1, 2, 1, False, True, "relu"),      # alex 6
    ((1, 32, 32, 3), 7, 16, 2, 3, 9, 16, False, True, "relu"),    # r18 0
    ((2, 14, 14, 16), 3, 16, 1, 1, 2, 7, True, True, "relu"),     # r18 3
    ((1, 14, 14, 8), 1, 16, 2, 0, 2, 64, False, True, None),      # r18 6
    ((1, 14, 14, 8), 3, 16, 2, 1, 1, 7, False, True, "relu"),     # r18 7
    ((1, 7, 7, 16), 3, 16, 1, 1, 1, 1, True, True, "relu"),       # r18 18
    ((1, 11, 9, 5), 3, 13, 1, 1, 4, 5, True, False, "gelu"),      # prime
    ((2, 10, 10, 4), 5, 6, 2, 0, 3, 6, False, True, "tanh"),      # pad 0
]


def _strips_case(case):
    xs, k, cout, stride, pad, rows, kpt, has_byp, first, act = STRIPS[case]
    rng = np.random.default_rng(case)
    x = rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal((k, k, xs[3], cout)) * 0.3).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    g = strips_geometry(xs, w.shape, stride=stride, pad=pad, out_rows=rows,
                        kpt=kpt)
    byp = (rng.standard_normal((xs[0], g.OH, g.OW, cout)).astype(np.float32)
           if has_byp else None)
    return x, w, b, byp, g, first, act


@pytest.mark.parametrize("case", range(len(STRIPS)))
def test_materialize_strips_matches_reference_bit_for_bit(case):
    x, _, _, _, g, _, _ = _strips_case(case)
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (g.pad, g.bottom_pad),
                                  (g.pad, g.pad), (0, 0)))
    ref = jax_conv_ops._materialize_strips(xp, g.n_strips, g.out_rows,
                                           g.in_rows, g.stride)
    src = torch.from_numpy(x)
    got = materialize_strips(src, g)
    assert got.is_contiguous() and got.untyped_storage().data_ptr() != \
        src.untyped_storage().data_ptr()
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("df", [Dataflow.MAPS_RESIDENT,
                                Dataflow.WEIGHTS_RESIDENT])
@pytest.mark.parametrize("case", range(len(STRIPS)))
def test_strips_plain_matches_pallas_interpret(case, df):
    x, w, b, byp, g, first, act = _strips_case(case)
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (g.pad, g.bottom_pad),
                                  (g.pad, g.pad), (0, 0)))
    strips = jax_conv_ops._materialize_strips(xp, g.n_strips, g.out_rows,
                                              g.in_rows, g.stride)
    sbyp = None
    if byp is not None:
        sbyp = strip_bypass(torch.from_numpy(byp), g)
    ref = conv2d_strips_pallas(
        strips, jnp.asarray(w), out_rows=g.out_rows, OW=g.OW,
        stride=g.stride, kpt=g.kpt, bias=jnp.asarray(b), activation=act,
        bypass=None if sbyp is None else jnp.asarray(sbyp.numpy()),
        bypass_first=first, dataflow=JaxDataflow(df.value), interpret=True)
    got = conv2d_strips_plain(torch.from_numpy(np.array(strips)),
                              torch.from_numpy(w), g, bias=torch.from_numpy(b),
                              activation=act, bypass=sbyp,
                              bypass_first=first)
    assert tuple(got.shape) == (g.NS, g.out_rows, g.OW, g.Cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("case", range(len(STRIPS)))
def test_strip_copy_conv_and_unstrip_equal_the_conv_oracle(case):
    """The wrapper's composition on the plain version: copy, strip conv,
    trim equals the unstripped conv (the last strip's extra rows are
    computed on the bottom pad and dropped)."""
    x, w, b, byp, g, first, act = _strips_case(case)
    x, w, b = (torch.from_numpy(a) for a in (x, w, b))
    byp = None if byp is None else torch.from_numpy(byp)
    kw = dict(bias=b, activation=act, bypass_first=first)
    got = unstrip(conv2d_strips_plain(
        materialize_strips(x, g), w, g,
        bypass=None if byp is None else strip_bypass(byp, g), **kw), g)
    want = conv2d_ref(x, w, stride=g.stride, pad=g.pad, bypass=byp, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_strips_geometry_pads_the_bottom_by_at_least_pad():
    # One strip covers the whole output: the zero-copy rule would pad the
    # bottom by max(0, needed) = 0 rows, the materialized one by pad.
    g = strips_geometry((1, 8, 8, 2), (3, 3, 2, 4), stride=1, pad=1,
                        out_rows=8, kpt=4)
    assert (g.n_strips, g.in_rows, g.bottom_pad, g.Hp) == (1, 10, 1, 10)
    v = virtual_geometry((1, 8, 8, 2), (3, 3, 2, 4), stride=1, pad=1,
                         out_rows=8, kpt=4)
    assert v.Hp == 10
    g = strips_geometry((1, 9, 9, 2), (3, 3, 2, 6), stride=2, pad=1,
                        out_rows=2, kpt=4)
    assert (g.OH, g.n_strips, g.in_rows, g.kpt) == (5, 3, 5, 3)
    assert g.bottom_pad == max(1, (3 - 1) * 2 * 2 + 5 - 9 - 1)


def test_cuda_strips_wrapper_raises_on_a_cpu_tensor():
    x, w, _, _, g, _, _ = _strips_case(1)
    strips = materialize_strips(torch.from_numpy(x), g)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        conv2d_strips_cuda(strips, torch.from_numpy(w), g)
    with pytest.raises(RuntimeError, match="impl='cuda'"):
        conv2d(torch.from_numpy(x), torch.from_numpy(w), pad=2,
               strip_storage="materialized", impl="cuda")


def test_strips_launch_args_check_the_operands():
    """The arguments the C launcher takes, in its order, and the checks
    that run before any pointer reaches it."""
    x, w, b, byp, g, _, _ = _strips_case(6)          # a bypass case
    strips = materialize_strips(torch.from_numpy(x), g)
    w, b = torch.from_numpy(w), torch.from_numpy(b)
    out = torch.empty((g.NS, g.out_rows, g.OW, g.Cout))
    sbyp = strip_bypass(torch.from_numpy(byp), g)
    args = strips_launch_args(strips, w, g, out, bias=b, activation="relu",
                              bypass=sbyp, bypass_first=True,
                              dataflow=Dataflow.WEIGHTS_RESIDENT)
    assert args == [g.NS, g.in_rows, g.Wp, g.Cin, g.kh, g.kw, g.Cout,
                    g.stride, g.out_rows, g.OW, 1, 1, 1] + plan_args(
        conv_plan(g))
    with pytest.raises(TypeError, match="bypass must be float32"):
        strips_launch_args(strips, w, g, out, bypass=sbyp[:, :1])
    with pytest.raises(TypeError, match="strips must be float32"):
        strips_launch_args(strips.double(), w, g, out)
    with pytest.raises(ValueError, match="w must be contiguous"):
        strips_launch_args(strips, w.transpose(0, 1).contiguous()
                           .transpose(0, 1), g, out)


def test_virtual_launch_args_check_the_row_starts_table():
    xs, ws = (1, 9, 9, 3), (3, 3, 3, 10)
    g = virtual_geometry(xs, ws, stride=1, pad=1, out_rows=4, kpt=5)
    x, w = torch.zeros(xs), torch.zeros(ws)
    out = torch.empty((g.B, g.OHo, g.OWo, g.Cout))
    table = prefetch_row_starts(g, "cpu")
    assert launch_args(x, w, g, out, row_starts=table) == launch_args(
        x, w, g, out)
    for bad in (table.long(), table[:-1]):
        with pytest.raises(TypeError, match="row_starts"):
            launch_args(x, w, g, out, row_starts=bad)


def test_conv2d_validates_strip_offsets():
    x = torch.zeros((1, 4, 4, 2))
    w = torch.zeros((3, 3, 2, 2))
    with pytest.raises(ValueError, match="strip_offsets"):
        conv2d(x, w, strip_offsets="table")
    assert conv2d(x, w, pad=1, strip_offsets="prefetch").shape == (
        1, 4, 4, 2)


@pytest.mark.parametrize("case", range(len(_spy_cases())))
def test_prefetch_row_starts_match_reference_table(case, monkeypatch):
    xs, ws, stride, pad, out_rows, kpt, fuse_pool, bypass = \
        _spy_cases()[case]
    seen = {}

    def spy(xp, w, **kw):
        seen.update(kw)
        SR = kw["out_rows"] // (kw["pool"][1] if kw["pool"] else 1)
        from repro.core.ir import pool_out
        OWo = (pool_out(kw["OW"], *kw["pool"][:3]) if kw["pool"]
               else kw["OW"])
        return jnp.zeros((xp.shape[0], kw["n_strips"] * SR, OWo,
                          w.shape[-1]), xp.dtype)

    monkeypatch.setattr(jax_conv_ops, "conv2d_virtual_pallas", spy)
    tiling = JaxConvTiling(out_rows=out_rows, in_rows=0,
                           kernels_per_tile=kpt, vmem_bytes=0,
                           n_map_tiles=1, n_kernel_tiles=1, overlap_frac=0.0,
                           strip_storage="virtual")
    oh = (xs[1] + 2 * pad - ws[0]) // stride + 1
    ow = (xs[2] + 2 * pad - ws[1]) // stride + 1
    byp = jnp.zeros((xs[0], oh, ow, ws[3])) if bypass else None
    jax_conv_ops.conv2d(jnp.zeros(xs, jnp.float32),
                        jnp.zeros(ws, jnp.float32), stride=stride, pad=pad,
                        bypass=byp, fuse_pool=fuse_pool, impl="pallas",
                        tiling=tiling, strip_storage="virtual",
                        strip_offsets="prefetch")
    pool = norm_pool(fuse_pool)
    if pool is not None and bypass:
        pool = None
    g = virtual_geometry(xs, ws, stride=stride, pad=pad, out_rows=out_rows,
                         kpt=kpt, pool=pool)
    got = prefetch_row_starts(g, "cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(seen["row_starts"]))
    # Every strip's window lies inside the padded maps the table indexes.
    assert int(got[-1]) + g.in_rows <= g.Hp
    assert math.ceil(g.OHo / g.SR) == g.n_strips
