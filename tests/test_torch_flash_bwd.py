"""The port's flash-attention backward against ``repro``'s, on the same
numpy inputs: the plain backward (``flash_attention_bwd_plain``, which the
CUDA kernel is held against on the card) and the autograd of
``flash_ref`` within 1e-4 of ``jax.grad`` through the Pallas two-pass
backward in interpret mode (the bar ``repro`` holds its own Pallas
backward to), at the cases of ``tests/test_kernels.py``'s
``test_flash_pallas_backward_kernels`` plus a kv_len-padded one; and the
trainable wrapper's padding and autograd plumbing through CPU stand-ins
for the kernels."""
import functools
import importlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa

from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.bwd_kernel import (  # noqa: E402
    flash_attention_bwd_cuda, flash_attention_bwd_plain)
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_plain)
from repro_torch.kernels.flash_attention.ref import flash_ref  # noqa: E402

TOL = 1e-4
flash_ops = importlib.import_module("repro_torch.kernels.flash_attention.ops")

# (name, Hq, Hkv, causal, window, Sq, Skv): B = 2, D = 32, blocks of 32.
CASES = [("mha", 4, 4, True, None, 128, 128),
         ("gqa", 4, 2, True, None, 128, 128),
         ("non_causal", 4, 2, False, None, 128, 128),
         ("window", 6, 2, True, 48, 128, 128),
         ("kv_len_padded", 4, 2, False, None, 64, 100)]
B, D = 2, 32


@functools.lru_cache(maxsize=None)
def _case(name):
    """Inputs and ``repro``'s gradients for one case (computed once)."""
    _, Hq, Hkv, causal, window, Sq, Skv = next(c for c in CASES
                                               if c[0] == name)
    rng = np.random.default_rng(Hq * 100 + Sq + Skv + (window or 0))
    q = (rng.standard_normal((B, Hq, Sq, D)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, Hkv, Skv, D)) * 0.5).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32)
    do = rng.standard_normal((B, Hq, Sq, D)).astype(np.float32)

    def loss(q, k, v):
        o = jax_flash(q, k, v, causal=causal, window=window,
                      impl="pallas_trainable", block_q=32, block_kv=32,
                      interpret=True)
        return jnp.sum(o * jnp.asarray(do))
    grads = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    kw = dict(causal=causal, window=window)
    return (q, k, v, do), tuple(np.asarray(g) for g in grads), kw


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_plain_backward_matches_pallas_backward(name):
    (q, k, v, do), want, kw = _case(name)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = flash_attention_plain(tq, tk, tv, scale=D ** -0.5,
                                     kv_len=None, **kw)
    _close(flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo,
                                     scale=D ** -0.5, kv_len=None, **kw),
           want)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_flash_ref_autograd_matches_pallas_backward(name):
    (q, k, v, do), want, kw = _case(name)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*leaves, impl="reference", **kw)
    _close(torch.autograd.grad(out, leaves, torch.from_numpy(do)), want)


def test_plain_backward_masks_padded_keys_through_kv_len():
    """The kernel's view of a padded call: keys zero-padded to 128 and
    masked at kv_len = 100 give the unpadded gradients, zero past 100."""
    (q, k, v, do), want, kw = _case("kv_len_padded")
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 28))  # noqa: E731
    kp, vp = pad(tk), pad(tv)
    out, lse = flash_attention_plain(tq, kp, vp, scale=D ** -0.5,
                                     kv_len=100, **kw)
    dq, dk, dv = flash_attention_bwd_plain(tq, kp, vp, out, lse, tdo,
                                           scale=D ** -0.5, kv_len=100, **kw)
    _close((dq, dk[:, :, :100], dv[:, :, :100]), want)
    assert not dk[:, :, 100:].any() and not dv[:, :, 100:].any()


def test_trainable_wrapper_pads_and_differentiates(monkeypatch):
    """The kernel path's autograd Function through CPU stand-ins for both
    kernels: the forward gets q and kv padded to block multiples with
    the padded keys masked through kv_len, the backward gets the same
    operands with the saved out and lse, and ``F.pad`` carries the
    gradients back to the unpadded inputs (``repro``'s values)."""
    seen = {}

    def fwd(q, k, v, **kw):
        seen["fwd"] = (tuple(q.shape), tuple(k.shape), kw["kv_len"])
        return flash_attention_plain(q, k, v, **kw)

    def bwd(q, k, v, out, lse, do, **kw):
        seen["bwd"] = (tuple(do.shape), tuple(k.shape), kw["kv_len"])
        return flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    monkeypatch.setattr(flash_ops, "use_kernel", lambda impl, x: True)
    monkeypatch.setattr(flash_ops, "flash_attention_cuda", fwd)
    monkeypatch.setattr(flash_ops, "flash_attention_bwd_cuda", bwd)
    (q, k, v, do), want, kw = _case("kv_len_padded")
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*leaves, block_q=48, block_kv=32, **kw)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    # block_q 48 does not divide 64, so it falls back to 128.
    assert seen["fwd"] == ((B, 4, 128, D), (B, 2, 128, D), 100)
    assert seen["bwd"] == ((B, 4, 128, D), (B, 2, 128, D), 100)
    assert out.shape == (B, 4, 64, D)
    _close(grads, want)


def test_no_grad_forward_saves_nothing_and_runs_no_backward(monkeypatch):
    """Serving calls the trainable path under ``torch.no_grad()``: one
    forward, the same values, no backward."""
    calls = []
    monkeypatch.setattr(flash_ops, "use_kernel", lambda impl, x: True)
    monkeypatch.setattr(
        flash_ops, "flash_attention_cuda",
        lambda *a, **kw: calls.append("fwd") or flash_attention_plain(
            *a, **kw))
    (q, k, v, _), _, kw = _case("gqa")
    with torch.no_grad():
        out = flash_attention(*map(torch.from_numpy, (q, k, v)),
                              block_q=32, block_kv=32, **kw)
    assert calls == ["fwd"] and not out.requires_grad
    np.testing.assert_allclose(
        out.numpy(), flash_ref(*map(torch.from_numpy, (q, k, v)),
                               **kw).numpy(), rtol=0, atol=1e-6)


def test_backward_kernel_refuses_cpu_tensors():
    q = torch.zeros((1, 2, 8, 32))
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(RuntimeError, match="CUDA"):
        flash_attention_bwd_cuda(q, q, q, q, lse, q, scale=1.0, causal=True,
                                 window=None, kv_len=None)
