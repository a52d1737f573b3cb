"""The port's compiler against ``repro``'s: byte-equal Program listings
and RegionPlans, and the zero-copy conv's strip geometry as ``repro``'s
conv2d hands it to its Pallas kernel."""
import dataclasses
import importlib

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import CNN_REGISTRY as JAX_CNNS  # noqa: E402
from repro.configs.base import CNNConfig as JaxCNNConfig  # noqa: E402
from repro.configs.base import CNNLayer as JaxLayer  # noqa: E402
from repro.core import SNOWFLAKE as JAX_SNOWFLAKE  # noqa: E402
from repro.core import TPU_V5E as JAX_TPU_V5E  # noqa: E402
from repro.models import cnn as jax_cnn  # noqa: E402

from repro_torch.configs import CNN_REGISTRY  # noqa: E402
from repro_torch.configs.base import CNNConfig, CNNLayer  # noqa: E402
from repro_torch.core import SNOWFLAKE, TPU_V5E  # noqa: E402
from repro_torch.kernels.conv2d.kernel import (  # noqa: E402
    conv_plan, virtual_geometry)
from repro_torch.kernels.conv2d.ops import norm_pool  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

# The package re-exports the function ``conv2d`` over its module name.
jax_conv_ops = importlib.import_module("repro.kernels.conv2d.ops")

# tests/test_program_exec.py's TINY, in both packages' config types.
_TINY_LAYERS = (
    ("conv", dict(c_out=8, k=3, stride=1, pad=1)),
    ("maxpool", dict(k=2, stride=2)),
    ("conv", dict(c_out=8, k=3, stride=1, pad=1)),
    ("conv", dict(c_out=8, k=3, stride=1, pad=1, activation="relu",
                  bypass_of=1)),
    ("fc", dict(c_out=10, activation=None)),
)
TINY = CNNConfig(name="tiny-prog", input_hw=16, input_ch=4, n_classes=10,
                 layers=tuple(CNNLayer(k, **kw) for k, kw in _TINY_LAYERS))
JAX_TINY = JaxCNNConfig(
    name="tiny-prog", input_hw=16, input_ch=4, n_classes=10,
    layers=tuple(JaxLayer(k, **kw) for k, kw in _TINY_LAYERS))


def _configs(name):
    if name == "tiny-prog":
        return TINY, JAX_TINY
    return CNN_REGISTRY[name], JAX_CNNS[name]


def _plain(obj):
    """A dataclass tree as plain values (enums by value), so plans from
    the two packages' classes compare field by field."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return getattr(obj, "value", obj)


HW = {"tpu_v5e": (TPU_V5E, JAX_TPU_V5E, False),
      "snowflake_paper": (SNOWFLAKE, JAX_SNOWFLAKE, True)}


@pytest.mark.parametrize("hw", sorted(HW))
@pytest.mark.parametrize("name", ["alexnet-owt", "resnet18", "resnet50",
                                  "tiny-prog"])
def test_program_listing_and_plan_match_reference(name, hw):
    cfg, jcfg = _configs(name)
    port_hw, jax_hw, faithful = HW[hw]
    ours = cnn.compile_program(cfg, batch=2, hw=port_hw,
                               paper_faithful=faithful)
    ref = jax_cnn.compile_program(jcfg, batch=2, hw=jax_hw,
                                  paper_faithful=faithful)
    assert ours.listing() == ref.listing()
    assert _plain(ours.plan) == _plain(ref.plan)
    assert [_plain(op) for op in ours.ops] == [_plain(op) for op in ref.ops]


def test_compile_program_is_memoized():
    p = cnn.compile_program(TINY, batch=2)
    assert cnn.compile_program(TINY, 2) is p
    assert cnn.compile_program(TINY, batch=4) is not p
    assert cnn.compile_program(TINY, batch=2, hw=SNOWFLAKE) is not p


def _spy_cases():
    """(x shape, w shape, stride, pad, tiling, pool, bypass) of every
    conv op on the slice's Programs, plus synthetic pool corners."""
    cases = []
    for name in ("alexnet-owt", "resnet18", "tiny-prog"):
        cfg, _ = _configs(name)
        shapes = cnn.trace_shapes(cfg)
        prog = cnn.compile_program(cfg, batch=1)
        for op in prog.ops:
            if op.kernel != "conv2d":
                continue
            i = int(op.param_key.split("_")[1])
            layer = cfg.layers[i]
            h, w, c = shapes[i]
            cases.append(((1, h, w, c), (layer.k, layer.k, c, layer.c_out),
                          op.stride, op.pad, op.conv_tiling.out_rows,
                          op.conv_tiling.kernels_per_tile, op.fuse_pool,
                          op.fuse_bypass))
    cases += [((2, 13, 11, 3), (3, 3, 3, 12), 1, 1, 5, 8, (3, 2, 1, "avg"),
               False),
              ((1, 20, 20, 2), (5, 5, 2, 6), 2, 2, 3, 6, (2, 2), False),
              ((1, 14, 14, 4), (1, 1, 4, 4), 1, 0, 14, 4, (7, 7, 0, "avg"),
               False),
              ((1, 9, 9, 3), (3, 3, 3, 10), 1, 1, 4, 4, None, True)]
    return cases


@pytest.mark.parametrize("case", range(len(_spy_cases())))
def test_virtual_geometry_matches_reference_kernel_args(case, monkeypatch):
    xs, ws, stride, pad, out_rows, kpt, fuse_pool, bypass = \
        _spy_cases()[case]
    from repro.core.tiling import ConvTiling
    seen = {}

    def spy(xp, w, **kw):
        seen.update(kw, xp_shape=xp.shape)
        _, ps = (kw["pool"][0], kw["pool"][1]) if kw["pool"] else (1, 1)
        SR = kw["out_rows"] // ps
        from repro.core.ir import pool_out
        OWo = (pool_out(kw["OW"], *kw["pool"][:3]) if kw["pool"]
               else kw["OW"])
        return jnp.zeros((xp.shape[0], kw["n_strips"] * SR, OWo,
                          w.shape[-1]), xp.dtype)

    monkeypatch.setattr(jax_conv_ops, "conv2d_virtual_pallas", spy)
    tiling = ConvTiling(out_rows=out_rows, in_rows=0,
                        kernels_per_tile=kpt, vmem_bytes=0, n_map_tiles=1,
                        n_kernel_tiles=1, overlap_frac=0.0,
                        strip_storage="virtual")
    x = jnp.zeros(xs, jnp.float32)
    w = jnp.zeros(ws, jnp.float32)
    oh = (xs[1] + 2 * pad - ws[0]) // stride + 1
    ow = (xs[2] + 2 * pad - ws[1]) // stride + 1
    byp = jnp.zeros((xs[0], oh, ow, ws[3])) if bypass else None
    out = jax_conv_ops.conv2d(x, w, stride=stride, pad=pad, bypass=byp,
                              fuse_pool=fuse_pool, impl="pallas",
                              tiling=tiling, strip_storage="virtual")
    pool = norm_pool(fuse_pool)
    if pool is not None and bypass:       # the kernel runs without the pool
        pool = None
    g = virtual_geometry(xs, ws, stride=stride, pad=pad, out_rows=out_rows,
                         kpt=kpt, pool=pool)
    assert (g.out_rows, g.OH, g.OW, g.kpt, g.n_strips, g.pool) == (
        seen["out_rows"], seen["OH"], seen["OW"], seen["kpt"],
        seen["n_strips"], seen["pool"])
    assert (xs[0], g.Hp, g.Wp, g.Cin) == tuple(seen["xp_shape"])
    assert g.stride == seen["stride"]
    if fuse_pool is None or not bypass:
        assert (g.OHo, g.OWo) == tuple(out.shape[1:3])
    # The strip table reaches exactly the rows the padded maps hold.
    assert (g.n_strips - 1) * g.out_rows * g.stride + g.in_rows <= g.Hp
    if g.pool is not None:
        plan = conv_plan(g)
        pw, ps = g.pool[:2]
        assert (plan.conv_r, plan.conv_c) == ((plan.tile_r - 1) * ps + pw,
                                              (plan.tile_c - 1) * ps + pw)
        assert plan.conv_r * plan.conv_c <= plan.bm <= 256
