"""Why ``tests/test_torch_sharded.py`` holds zamba2-7b's train case at
2 x 16 rows a block and not 2 x 32: at 2 x 32, on that test's own
inputs, the f32 gradient of the first block is ill-conditioned, so two
f32 computations of it differ by more than the 1e-5 bar while neither is
at fault (ROADMAP C.4).

Each block's loss gradient is computed three ways: ``repro``'s (jit,
f32), the port's ``loss_and_grads`` (``impl="reference"``, f32) and the
port's in float64 (every ``Tensor.float()`` made ``double()``, the
params and the scan state in float64).  Distances are each leaf's
largest difference over the float64 gradient's largest magnitude."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_sharded as T  # noqa: E402
import repro_torch.kernels.mamba2.ref as mamba_ref  # noqa: E402
from repro_torch.configs import base, get_config  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402

ARCH = "zamba2-7b"


def _float64_grads(cfg, arrs, batch, monkeypatch):
    """The port's gradient with every f32 step taken in float64."""
    monkeypatch.setitem(base._DTYPES, "float64", torch.float64)
    monkeypatch.setattr(torch.Tensor, "float",
                        lambda self, *a, **k: self.double())
    monkeypatch.setattr(
        mamba_ref, "_h_init", lambda h0, Bt, H, N, P, device: torch.zeros(
            (Bt, H, N, P), dtype=torch.float64, device=device))
    flat = T._flat(params_from_numpy(T._unflat(arrs, "p/")))
    p64 = T._unflat({"p/" + k: v.double() for k, v in flat.items()}, "p/")
    torch.set_default_dtype(torch.float64)
    try:
        _, g = loss_and_grads(dataclasses.replace(cfg, dtype="float64"),
                              p64, batch, impl="reference")
    finally:
        torch.set_default_dtype(torch.float32)
        monkeypatch.undo()
    return {k: v.numpy() for k, v in T._flat(g).items()}


def _distances(seq, monkeypatch):
    """{leaf: (repro to float64, port to float64, repro to port)}, each
    the larger of the case's two blocks."""
    case = ("zamba2-auto-2x2", "train", ARCH, "2x2", "auto", 32, 4, seq)
    arrs = T._inputs(case)
    jfn = T._jloss(T.JREGISTRY[ARCH].smoke())
    jparams = T._params_of(arrs)
    cfg = get_config(ARCH).smoke()
    batch = {k[2:]: v for k, v in arrs.items() if k.startswith("b/")}
    out = {}
    for i in range(2):
        blk = {k: v[2 * i:2 * i + 2] for k, v in batch.items()}
        _, g = jfn(jparams, {k: jnp.asarray(v) for k, v in blk.items()})
        gj = T._flat(jax.tree.map(np.asarray, g))
        tb = {k: torch.from_numpy(v) for k, v in blk.items()}
        _, g32 = loss_and_grads(cfg, params_from_numpy(
            T._unflat(arrs, "p/")), tb, impl="reference")
        g32 = {k: v.numpy() for k, v in T._flat(g32).items()}
        g64 = _float64_grads(cfg, arrs, tb, monkeypatch)
        for k in gj:
            scale = np.abs(g64[k]).max()
            d = [float(np.abs(a - b).max() / scale)
                 for a, b in ((gj[k], g64[k]), (g32[k], g64[k]),
                              (gj[k], g32[k]))]
            out[k] = tuple(map(max, zip(out.get(k, d), d)))
    return out


def test_zamba2_conv_w_gap_at_2x32_is_f32_round_off(monkeypatch):
    """At 2 x 32 the two packages' f32 ``conv_w`` gradients lie more than
    the bar apart, but ``repro``'s own lies that far from the float64
    gradient, and the port's lies nearer it than ``repro``'s does."""
    to64, port64, gap = _distances(32, monkeypatch)["blocks/conv_w"]
    assert gap > T.TOL, gap
    assert to64 > T.TOL, to64
    assert port64 < to64, (port64, to64)


def test_zamba2_gradients_agree_at_2x16(monkeypatch):
    """At 2 x 16, the rows the sharded case runs, every leaf of the two
    packages' f32 gradients agrees within the bar."""
    d = _distances(16, monkeypatch)
    worst = max(d, key=lambda k: d[k][2])
    assert d[worst][2] <= T.TOL, (worst, d[worst])
