"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips where no CUDA card is present.  The
file imports no jax, so it runs on a machine with the card alone:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.dataflow import Dataflow  # noqa: E402
from repro_torch.kernels import conv2d, matmul  # noqa: E402
from repro_torch.kernels.conv2d.kernel import (  # noqa: E402
    conv2d_virtual_cuda, conv2d_virtual_plain, virtual_geometry)
from repro_torch.kernels.matmul.kernel import (  # noqa: E402
    matmul_cuda, matmul_plain)

pytestmark = pytest.mark.cuda
TOL = 1e-4          # f32 sums in another order


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
