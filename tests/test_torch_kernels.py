"""The port's plain conv2d / matmul against ``repro``'s Pallas kernels
in interpret mode, at small shapes, on the same numpy inputs; and the
CUDA dispatch refusing CPU tensors with no fallback."""
import importlib

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.dataflow import Dataflow as JaxDataflow  # noqa: E402
from repro.core.tiling import ConvTiling as JaxConvTiling  # noqa: E402
from repro.kernels import conv2d as jax_conv2d  # noqa: E402
from repro.kernels import matmul as jax_matmul  # noqa: E402

from repro_torch.core.dataflow import Dataflow  # noqa: E402
from repro_torch.kernels import conv2d, matmul  # noqa: E402
from repro_torch.kernels.conv2d.kernel import (  # noqa: E402
    conv2d_virtual_cuda, virtual_geometry)
from repro_torch.kernels.matmul.kernel import matmul_cuda  # noqa: E402

TOL = 1e-5          # f32, same math; sums in another order

conv_ops = importlib.import_module("repro_torch.kernels.conv2d.ops")
matmul_ops = importlib.import_module("repro_torch.kernels.matmul.ops")

# (name, x shape, kh, Cout, stride, pad, out_rows, kpt, fuse_pool,
#  bypass, bypass_first, activation)
CONV_CASES = [
    ("s1_relu", (2, 9, 9, 5), 3, 12, 1, 1, 4, 8, None, False, True, "relu"),
    ("s2_gelu", (1, 11, 10, 3), 3, 8, 2, 1, 3, 8, None, False, True, "gelu"),
    ("proj1x1_silu", (2, 8, 8, 6), 1, 10, 2, 0, 4, 10, None, False, True,
     "silu"),
    ("none_act", (1, 8, 8, 4), 3, 8, 1, 1, 8, 8, None, False, True, None),
    ("maxpool", (2, 16, 16, 4), 3, 8, 1, 1, 5, 8, (3, 2), False, True,
     "relu"),
    ("maxpool_pad", (1, 13, 13, 3), 3, 8, 1, 1, 5, 8, (3, 2, 1, "max"),
     False, True, "relu"),
    ("avgpool", (1, 12, 12, 3), 3, 8, 1, 1, 4, 8, (2, 2, 0, "avg"), False,
     True, "tanh"),
    ("avgpool_pad", (1, 13, 13, 3), 3, 8, 1, 1, 5, 4, (3, 2, 1, "avg"),
     False, True, "relu"),
    ("bypass_first", (1, 8, 8, 4), 3, 8, 1, 1, 3, 4, None, True, True,
     "relu"),
    ("bypass_last", (2, 8, 8, 4), 3, 8, 1, 1, 3, 8, None, True, False,
     "silu"),
    ("pool_and_bypass", (1, 14, 14, 4), 3, 8, 1, 1, 14, 8,
     (7, 7, 0, "avg"), True, True, "relu"),
]


@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_conv2d_plain_matches_pallas_interpret(case):
    (_, xs, k, cout, stride, pad, out_rows, kpt, pool, has_byp, bf,
     act) = case
    rng = np.random.default_rng(0)
    x = rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal((k, k, xs[3], cout)) * 0.3).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    oh = (xs[1] + 2 * pad - k) // stride + 1
    ow = (xs[2] + 2 * pad - k) // stride + 1
    byp = (rng.standard_normal((xs[0], oh, ow, cout)).astype(np.float32)
           if has_byp else None)
    tiling = JaxConvTiling(out_rows=out_rows, in_rows=0,
                           kernels_per_tile=kpt, vmem_bytes=0,
                           n_map_tiles=1, n_kernel_tiles=1,
                           overlap_frac=0.0, strip_storage="virtual")
    ref = jax_conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride,
                     pad=pad, bias=jnp.asarray(b), activation=act,
                     bypass=None if byp is None else jnp.asarray(byp),
                     bypass_first=bf, fuse_pool=pool, impl="pallas",
                     interpret=True, tiling=tiling,
                     dataflow=JaxDataflow.WEIGHTS_RESIDENT)
    t = torch.from_numpy
    out = conv2d(t(x), t(w), stride=stride, pad=pad, bias=t(b),
                 activation=act, bypass=None if byp is None else t(byp),
                 bypass_first=bf, fuse_pool=pool)
    assert out.shape == tuple(ref.shape)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("dataflow", ["kloop", "mloop",
                                      "output_stationary"])
@pytest.mark.parametrize("shape", [(5, 70, 45), (130, 96, 200)])
def test_matmul_plain_matches_pallas_interpret(dataflow, shape):
    M, K, N = shape
    rng = np.random.default_rng(1)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = (rng.standard_normal((K, N)) * 0.2).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32)
    byp = rng.standard_normal((M, N)).astype(np.float32)
    ref = jax_matmul(jnp.asarray(a), jnp.asarray(b), bias=jnp.asarray(bias),
                     activation="gelu", bypass=jnp.asarray(byp),
                     dataflow=JaxDataflow(dataflow), block=(128, 128, 128),
                     impl="pallas", interpret=True)
    t = torch.from_numpy
    out = matmul(t(a), t(b), bias=t(bias), activation="gelu", bypass=t(byp),
                 dataflow=Dataflow(dataflow), block=(128, 128, 128))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL)


def test_matmul_folds_leading_dims_and_broadcasts_bypass():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((2, 3, 16)).astype(np.float32)
    b = rng.standard_normal((16, 8)).astype(np.float32)
    byp = rng.standard_normal(8).astype(np.float32)
    ref = jax_matmul(jnp.asarray(a), jnp.asarray(b), bypass=jnp.asarray(byp),
                     activation="relu", impl="reference")
    out = matmul(torch.from_numpy(a), torch.from_numpy(b), activation="relu",
                 bypass=torch.from_numpy(byp))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL)


def _no_plain(*a, **k):
    raise AssertionError("the plain version ran for impl='cuda'")


def test_cuda_impl_raises_on_cpu_without_fallback(monkeypatch):
    monkeypatch.setattr(conv_ops, "conv2d_ref", _no_plain)
    monkeypatch.setattr(matmul_ops, "matmul_ref", _no_plain)
    x, w = torch.zeros(1, 8, 8, 4), torch.zeros(3, 3, 4, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        conv2d(x, w, pad=1, impl="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        matmul(torch.zeros(4, 8), torch.zeros(8, 4), impl="cuda")
    g = virtual_geometry(tuple(x.shape), tuple(w.shape), stride=1, pad=1,
                         out_rows=8, kpt=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        conv2d_virtual_cuda(x, w, g)
    with pytest.raises(RuntimeError, match="CUDA"):
        matmul_cuda(torch.zeros(4, 8), torch.zeros(8, 4))
    assert conv2d_virtual_cuda.launches == 0 or torch.cuda.is_available()


def test_auto_on_cpu_runs_the_plain_version():
    x, w = torch.ones(1, 6, 6, 2), torch.ones(3, 3, 2, 4)
    out = conv2d(x, w, pad=1, impl="auto")
    np.testing.assert_allclose(out[0, 2, 2].numpy(), 18.0)
    with pytest.raises(ValueError, match="impl"):
        conv2d(x, w, impl="pallas")


def test_pad_to_unpad_and_activations_match_reference():
    from repro.kernels.common import ACTIVATIONS as JAX_ACTS
    from repro.kernels.common import pad_to as jax_pad_to
    from repro.kernels.common import unpad as jax_unpad

    from repro_torch.kernels.common import ACTIVATIONS, pad_to, unpad
    x = np.random.default_rng(3).standard_normal((3, 5, 7)).astype(
        np.float32)
    ours = pad_to(torch.from_numpy(x), (4, 8))
    ref = jax_pad_to(jnp.asarray(x), (4, 8))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(unpad(ours, x.shape).numpy(),
                                  np.asarray(jax_unpad(ref, x.shape)))
    assert pad_to(torch.from_numpy(x), (5, 7)).shape == x.shape
    assert set(ACTIVATIONS) == set(JAX_ACTS)
    for name in ACTIVATIONS:
        np.testing.assert_allclose(
            ACTIVATIONS[name](torch.from_numpy(x)).numpy(),
            np.asarray(JAX_ACTS[name](jnp.asarray(x))), rtol=0, atol=1e-6)
