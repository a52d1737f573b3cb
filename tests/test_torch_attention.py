"""The port's attention (flash prefill, ring-cache decode) and bf16
matmul against ``repro``'s, on the same numpy inputs: the plain versions
within 1e-5 of ``flash_ref`` / ``decode_attention_ref`` and of the
Pallas kernels in interpret mode, the shared ring rules, the wrapper's
padding rule, and the CUDA dispatch refusing CPU tensors."""
import importlib

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import decode_attention as jax_decode  # noqa: E402
from repro.kernels import flash_attention as jax_flash  # noqa: E402
from repro.kernels import matmul as jax_matmul  # noqa: E402
from repro.kernels.decode_attention import (  # noqa: E402
    decode_attention_pallas, decode_attention_ref, ring_kv_len,
    ring_positions)
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention_pallas, flash_ref)

from repro_torch.core.dataflow import Dataflow  # noqa: E402
from repro_torch.kernels import (decode_attention, flash_attention,  # noqa
                                 matmul)
from repro_torch.kernels import ring_kv_len as t_ring_kv_len  # noqa: E402
from repro_torch.kernels import ring_positions as t_ring_positions  # noqa
from repro_torch.kernels.decode_attention.kernel import (  # noqa: E402
    decode_attention_cuda, decode_attention_plain)
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_cuda, flash_attention_plain)
from repro_torch.kernels.matmul.kernel import launch_args  # noqa: E402

TOL = 1e-5          # f32, same math; sums in another order
flash_ops = importlib.import_module("repro_torch.kernels.flash_attention.ops")
decode_ops = importlib.import_module(
    "repro_torch.kernels.decode_attention.ops")

# (name, B, Hq, Hkv, Sq, Skv, D, causal, window, kv_len, block_q, block_kv)
FLASH = [
    ("causal", 1, 2, 2, 64, 64, 16, True, None, None, 32, 32),
    ("gqa", 2, 6, 2, 48, 48, 16, True, None, None, 16, 16),
    ("window", 1, 4, 2, 64, 64, 32, True, 9, None, 32, 16),
    ("kv_len", 1, 2, 1, 32, 64, 16, False, None, 40, 32, 32),
    ("ragged_sq", 1, 4, 2, 200, 200, 16, True, None, None, 64, 64),
    ("window_kv_len", 2, 4, 4, 40, 64, 16, False, 12, 50, 8, 16),
]


def _qkv(B, Hq, Hkv, Sq, Skv, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, Sq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32))


@pytest.mark.parametrize("case", FLASH, ids=[c[0] for c in FLASH])
def test_flash_plain_matches_reference_and_pallas_interpret(case):
    _, B, Hq, Hkv, Sq, Skv, D, causal, window, kv_len, bq, bkv = case
    q, k, v = _qkv(B, Hq, Hkv, Sq, Skv, D, seed=Sq + D)
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref = flash_ref(jq, jk, jv, **kw)
    pallas = jax_flash(jq, jk, jv, impl="pallas", interpret=True,
                       block_q=bq, block_kv=bkv, **kw)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    ours = flash_attention(tq, tk, tv, **kw)
    out, lse = flash_attention_plain(tq, tk, tv, scale=D ** -0.5, **kw)
    for got in (ours, out):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=0,
                                   atol=TOL)
    if Sq % bq == 0 and Skv % bkv == 0:      # the kernel's own lse
        _, jlse = flash_attention_pallas(
            jq, jk, jv, scale=D ** -0.5, causal=causal, window=window,
            kv_len=kv_len, block_q=bq, block_kv=bkv, interpret=True,
            return_lse=True)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=0,
                                   atol=TOL)


def test_flash_wrapper_pads_as_the_reference_does(monkeypatch):
    """The kernel path's padding rule, through a CPU stand-in for the
    kernel: block_q falls back to 128 when it does not divide Sq, q and
    kv are zero-padded to block multiples, and the padded keys are
    masked through kv_len."""
    seen = {}

    def stand_in(q, k, v, **kw):
        seen.update(q=tuple(q.shape), k=tuple(k.shape), **kw)
        return flash_attention_plain(q, k, v, **kw)
    monkeypatch.setattr(flash_ops, "use_kernel", lambda impl, x: True)
    monkeypatch.setattr(flash_ops, "flash_attention_cuda", stand_in)
    q, k, v = map(torch.from_numpy, _qkv(1, 4, 2, 200, 200, 16, seed=1))
    out = flash_attention(q, k, v, causal=True, block_q=96, block_kv=64)
    assert seen["q"] == (1, 4, 256, 16) and seen["k"] == (1, 2, 256, 16)
    assert seen["kv_len"] == 200 and seen["causal"]
    ref = flash_ref(*map(jnp.asarray, (q.numpy(), k.numpy(), v.numpy())),
                    causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("case", [(4, 6, 2, 32, 16, [1, 9, 32, 20]),
                                  (3, 4, 4, 16, 32, [16, 16, 2]),
                                  (2, 8, 1, 24, 16, [5, 24])])
def test_decode_plain_matches_reference_and_pallas_interpret(case):
    B, Hq, Hkv, S, D, lens = case
    rng = np.random.default_rng(S)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    kv_len = np.asarray(lens, np.int32)
    jargs = tuple(map(jnp.asarray, (q, k, v)))
    ref = decode_attention_ref(*jargs, kv_len=jnp.asarray(kv_len))
    pallas = decode_attention_pallas(*jargs, jnp.asarray(kv_len),
                                     scale=D ** -0.5, block_kv=8,
                                     interpret=True)
    targs = tuple(map(torch.from_numpy, (q, k, v)))
    tl = torch.from_numpy(kv_len)
    for got in (decode_attention(*targs, kv_len=tl),
                decode_attention_plain(*targs, tl, scale=D ** -0.5)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=0,
                                   atol=TOL)
    full = decode_attention(*targs)                 # kv_len None: all rows
    np.testing.assert_allclose(
        full.numpy(), np.asarray(jax_decode(*jargs, impl="reference")),
        rtol=0, atol=TOL)


@pytest.mark.parametrize("cache_len", [1, 4, 7, 16])
def test_ring_rules_match_reference(cache_len):
    seq_len = 16
    for length in range(1, seq_len + 1):
        np.testing.assert_array_equal(
            t_ring_positions(length, cache_len, seq_len).numpy(),
            np.asarray(ring_positions(length, cache_len, seq_len)))
    pos = np.arange(0, 40, dtype=np.int32)
    np.testing.assert_array_equal(
        t_ring_kv_len(torch.from_numpy(pos), cache_len).numpy(),
        np.asarray(ring_kv_len(jnp.asarray(pos), cache_len)))


def test_bf16_matmul_plain_matches_reference_and_takes_the_kernel_args():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((8, 96)).astype(ml_dtypes.bfloat16)
    b = (rng.standard_normal((96, 40)) * 0.1).astype(ml_dtypes.bfloat16)
    byp = rng.standard_normal((8, 40)).astype(ml_dtypes.bfloat16)
    ref = jax_matmul(jnp.asarray(a), jnp.asarray(b), bypass=jnp.asarray(byp),
                     activation="silu", impl="reference")
    t = lambda x: torch.from_numpy(x.astype(np.float32)).bfloat16()  # noqa
    out = matmul(t(a), t(b), bypass=t(byp), activation="silu")
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    # one bf16 rounding of the same f32 sum, in another order: one ulp
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref).astype(np.float32),
                               rtol=2.0 ** -7, atol=1e-6)
    args = launch_args(t(a), t(b), torch.empty(8, 40, dtype=torch.bfloat16),
                       dataflow=Dataflow.OUTPUT_STATIONARY,
                       block=(128, 128, 128), bypass=t(byp),
                       activation="silu")
    assert args[:3] == [8, 96, 40]
    with pytest.raises(TypeError, match="bfloat16"):
        launch_args(t(a), t(b), torch.empty(8, 40), block=(128, 128, 128),
                    dataflow=Dataflow.OUTPUT_STATIONARY)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        launch_args(t(a).half(), t(b).half(), torch.empty(8, 40).half(),
                    block=(128, 128, 128),
                    dataflow=Dataflow.OUTPUT_STATIONARY)


def _no_plain(*a, **k):
    raise AssertionError("the plain version ran for impl='cuda'")


def test_attention_cuda_impl_raises_on_cpu_without_fallback(monkeypatch):
    monkeypatch.setattr(flash_ops, "flash_ref", _no_plain)
    monkeypatch.setattr(decode_ops, "decode_attention_ref", _no_plain)
    q, k = torch.zeros(1, 2, 8, 64), torch.zeros(1, 2, 8, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        flash_attention(q, k, k, impl="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_attention(q[:, :, 0], k, k, impl="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        flash_attention_cuda(q, k, k, scale=1.0, causal=True, window=None,
                             kv_len=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_attention_cuda(q[:, :, 0], k, k, torch.ones(1, dtype=torch.int32),
                              scale=1.0)
    with pytest.raises(ValueError, match="impl"):
        decode_attention(q[:, :, 0], k, k, impl="pallas")
