"""The port's recurrent kernels (Mamba2 SSD scan, RWKV6 WKV) against
``repro``'s, on the same numpy inputs: the sequential oracles, the
block-parallel chunked forms, the plain versions of the CUDA kernels
against the Pallas kernels in interpret mode (with an initial state and
more than one chunk), the decode steps, the ops dispatch, and the CUDA
wrappers refusing CPU tensors.  f32 throughout: the same math summed in
another order, held to 1e-5."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import mamba2 as jax_mamba2  # noqa: E402
from repro.kernels import rwkv6 as jax_rwkv6  # noqa: E402

from repro_torch.kernels import mamba2, rwkv6  # noqa: E402
from repro_torch.kernels.mamba2.kernel import (  # noqa: E402
    mamba2_scan_cuda, mamba2_scan_plain)
from repro_torch.kernels.rwkv6.kernel import wkv6_cuda, wkv6_plain  # noqa

TOL = 1e-5


def close(ours, ref, tol=TOL):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


def ssd_inputs(Bt, L, H, P, N, seed, h0=False):
    """x, dt, A, B, C, D_skip (and h0) as numpy, the shapes ref.py names."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    out = [f(Bt, L, H, P) * 0.5,
           np.log1p(np.exp(f(Bt, L, H))) * 0.1,
           -np.exp(f(H)),
           f(Bt, L, N) * 0.5, f(Bt, L, N) * 0.5, f(H) * 0.1]
    out.append(f(Bt, H, N, P) * 0.5 if h0 else None)
    return out


def wkv_inputs(B, L, H, D, seed, s0=False):
    """r, k, v, w, u (and s0) as numpy; w = exp(-exp(.)) in (0, 1)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    out = [f(B, L, H, D) * 0.5, f(B, L, H, D) * 0.5, f(B, L, H, D),
           np.exp(-np.exp(f(B, L, H, D) * 0.5)), f(H, D) * 0.3]
    out.append(f(B, H, D, D) * 0.5 if s0 else None)
    return out


def both(arrays):
    """The same numpy arrays as torch tensors and jax arrays (None kept)."""
    t = [None if a is None else torch.from_numpy(a) for a in arrays]
    j = [None if a is None else jnp.asarray(a) for a in arrays]
    return t, j


# --- mamba2 -------------------------------------------------------------------------
@pytest.mark.parametrize("h0", [False, True])
def test_mamba2_scan_ref_matches_reference(h0):
    (x, dt, A, B, C, D, hh), (jx, jdt, jA, jB, jC, jD, jh) = both(
        ssd_inputs(2, 19, 3, 8, 4, seed=0, h0=h0))
    y, h = mamba2.mamba2_scan_ref(x, dt, A, B, C, D_skip=D, h0=hh,
                                  return_state=True)
    jy, jhf = jax_mamba2.mamba2_scan_ref(jx, jdt, jA, jB, jC, D_skip=jD,
                                         h0=jh, return_state=True)
    close(y, jy)
    close(h, jhf)


@pytest.mark.parametrize("L,chunk,h0", [(32, 8, True), (24, 64, False),
                                        (40, 16, True)])
def test_mamba2_scan_chunked_matches_reference(L, chunk, h0):
    """The block-parallel form, chunk cut as the reference cuts it (40
    rows at chunk 16 run as five chunks of 8)."""
    (x, dt, A, B, C, D, hh), (jx, jdt, jA, jB, jC, jD, jh) = both(
        ssd_inputs(2, L, 3, 8, 4, seed=1, h0=h0))
    y, h = mamba2.mamba2_scan_chunked(x, dt, A, B, C, D_skip=D, h0=hh,
                                      return_state=True, chunk=chunk)
    jy, jhf = jax_mamba2.mamba2_scan_chunked(jx, jdt, jA, jB, jC, D_skip=jD,
                                             h0=jh, return_state=True,
                                             chunk=chunk)
    close(y, jy)
    close(h, jhf)


@pytest.mark.parametrize("L,chunk,h0", [(32, 8, True), (16, 16, False),
                                        (1, 8, True)])
def test_mamba2_plain_matches_pallas_interpret(L, chunk, h0):
    """The CUDA kernel's plain version against ``mamba2_scan_pallas`` in
    interpret mode: several chunks carrying the state, an initial
    state, and the one-row decode shape."""
    (x, dt, A, B, C, _, hh), (jx, jdt, jA, jB, jC, _, jh) = both(
        ssd_inputs(2, L, 3, 8, 4, seed=2, h0=h0))
    y, h = mamba2_scan_plain(x, dt, A, B, C, h0=hh)
    jy, jhf = jax_mamba2.mamba2_scan_pallas(jx, jdt, jA, jB, jC, h0=jh,
                                            chunk=chunk, interpret=True)
    close(y, jy)
    close(h, jhf)


def test_mamba2_decode_step_matches_reference():
    (x, dt, A, B, C, D, hh), (jx, jdt, jA, jB, jC, jD, jh) = both(
        ssd_inputs(3, 1, 2, 8, 4, seed=3, h0=True))
    y, h = mamba2.mamba2_decode_step(hh, x[:, 0], dt[:, 0], A, B[:, 0],
                                     C[:, 0], D_skip=D)
    jy, jhn = jax_mamba2.mamba2_decode_step(jh, jx[:, 0], jdt[:, 0], jA,
                                            jB[:, 0], jC[:, 0], D_skip=jD)
    close(y, jy)
    close(h, jhn)


def test_mamba2_scan_dispatch():
    """"reference" is the chunked form and "sequential" the oracle, on
    strided operands (the model's column slices); "auto" on a CPU tensor
    takes the chunked form; the kernel refuses CPU tensors."""
    x, dt, A, B, C, D, hh = both(ssd_inputs(2, 12, 3, 8, 4, seed=4,
                                            h0=True))[0]
    xbc = torch.cat([x.reshape(2, 12, 24), B, C], dim=-1)
    xs, Bs, Cs = xbc[..., :24].reshape(2, 12, 3, 8), xbc[..., 24:28], \
        xbc[..., 28:]
    assert not xs.is_contiguous()
    kw = dict(D_skip=D, h0=hh, return_state=True)
    for impl, fn in (("reference", mamba2.mamba2_scan_chunked),
                     ("sequential", mamba2.mamba2_scan_ref),
                     ("auto", mamba2.mamba2_scan_chunked)):
        got = mamba2.mamba2_scan(xs, dt, A, Bs, Cs, impl=impl, **kw)
        want = fn(xs, dt, A, Bs, Cs, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    close(mamba2.mamba2_scan(xs, dt, A, Bs, Cs, **kw)[0],
          mamba2.mamba2_scan_chunked(x, dt, A, B, C, **kw)[0].numpy())
    with pytest.raises(RuntimeError, match="CUDA"):
        mamba2.mamba2_scan(x, dt, A, B, C, impl="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        mamba2_scan_cuda(x, dt, A, B, C)


# --- rwkv6 --------------------------------------------------------------------------
@pytest.mark.parametrize("s0", [False, True])
def test_wkv6_ref_matches_reference(s0):
    (r, k, v, w, u, ss), (jr, jk, jv, jw, ju, js) = both(
        wkv_inputs(2, 13, 3, 8, seed=5, s0=s0))
    y, S = rwkv6.wkv6_ref(r, k, v, w, u, s0=ss, return_state=True)
    jy, jS = jax_rwkv6.wkv6_ref(jr, jk, jv, jw, ju, s0=js, return_state=True)
    close(y, jy)
    close(S, jS)


@pytest.mark.parametrize("L,chunk,s0", [(48, 16, True), (40, 16, False),
                                        (12, 16, True)])
def test_wkv6_chunked_matches_reference(L, chunk, s0):
    """The chunked form (its pair decays against the reference's
    mid-chunk centring; 40 rows run as five chunks of 8, 12 rows as one
    chunk of 12)."""
    (r, k, v, w, u, ss), (jr, jk, jv, jw, ju, js) = both(
        wkv_inputs(2, L, 3, 8, seed=6, s0=s0))
    y, S = rwkv6.wkv6_chunked(r, k, v, w, u, s0=ss, return_state=True,
                              chunk=chunk)
    jy, jS = jax_rwkv6.wkv6_chunked(jr, jk, jv, jw, ju, s0=js,
                                    return_state=True, chunk=chunk)
    close(y, jy)
    close(S, jS)


@pytest.mark.parametrize("L,chunk,s0", [(24, 8, True), (16, 16, False),
                                        (1, 8, True)])
def test_wkv6_plain_matches_pallas_interpret(L, chunk, s0):
    """The CUDA kernel's plain version against ``wkv6_pallas`` in
    interpret mode, over several chunks, with and without s0."""
    (r, k, v, w, u, ss), (jr, jk, jv, jw, ju, js) = both(
        wkv_inputs(2, L, 2, 16, seed=7, s0=s0))
    y, S = wkv6_plain(r, k, v, w, u, s0=ss)
    jy, jS = jax_rwkv6.wkv6_pallas(jr, jk, jv, jw, ju, s0=js, chunk=chunk,
                                   interpret=True)
    close(y, jy)
    close(S, jS)


def test_wkv6_decode_step_matches_reference():
    (r, k, v, w, u, ss), (jr, jk, jv, jw, ju, js) = both(
        wkv_inputs(3, 1, 2, 8, seed=8, s0=True))
    y, S = rwkv6.wkv6_decode_step(ss, r[:, 0], k[:, 0], v[:, 0], w[:, 0], u)
    jy, jS = jax_rwkv6.wkv6_decode_step(js, jr[:, 0], jk[:, 0], jv[:, 0],
                                        jw[:, 0], ju)
    close(y, jy)
    close(S, jS)


def test_wkv6_dispatch():
    r, k, v, w, u, ss = both(wkv_inputs(1, 10, 2, 8, seed=9, s0=True))[0]
    for impl, fn in (("reference", rwkv6.wkv6_chunked),
                     ("sequential", rwkv6.wkv6_ref),
                     ("auto", rwkv6.wkv6_chunked)):
        got = rwkv6.wkv6(r, k, v, w, u, s0=ss, return_state=True, impl=impl)
        want = fn(r, k, v, w, u, s0=ss, return_state=True)
        for g, t in zip(got, want):
            assert torch.equal(g, t)
    with pytest.raises(RuntimeError, match="CUDA"):
        rwkv6.wkv6(r, k, v, w, u, impl="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        wkv6_cuda(r, k, v, w, u)
