"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips where no CUDA card is present.  The
file imports no jax, so it runs on a machine with the card alone:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.configs import SMOLLM_360M  # noqa: E402
from repro_torch.core.dataflow import Dataflow  # noqa: E402
from repro_torch.kernels import (conv2d, decode_attention,  # noqa: E402
                                 flash_attention, matmul)
from repro_torch.kernels.conv2d.kernel import (  # noqa: E402
    conv2d_virtual_cuda, conv2d_virtual_plain, virtual_geometry)
from repro_torch.kernels.decode_attention.kernel import (  # noqa: E402
    decode_attention_cuda, decode_attention_plain)
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_cuda, flash_attention_plain)
from repro_torch.kernels.matmul.kernel import (  # noqa: E402
    matmul_cuda, matmul_plain)
from repro_torch.models import init_params, transformer  # noqa: E402
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
    out, lse = flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == n0 + 1
    ref, ref_lse = flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=TOL, atol=TOL)


# (B, Hq, Hkv, S, D, kv_len per sequence)
DECODE = [(8, 15, 5, 512, 64, [1, 37, 128, 200, 333, 448, 511, 512]),
          (8, 15, 5, 128, 64, [1, 5, 64, 127, 128, 128, 128, 100]),
          (3, 32, 8, 64, 128, [64, 1, 30]),
          (2, 4, 4, 16, 32, [3, 16])]


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
