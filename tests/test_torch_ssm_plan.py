"""The recurrent kernels' launch plans and the arithmetic of their chunked
designs, on the CPU; and the plain versions behind the kernels that take
new operand types (bf16 convs, a float8 decode cache) against ``repro``.

``ssd_plan`` (``repro_torch/kernels/mamba2/kernel.py``) and ``wkv_plan``
(``repro_torch/kernels/rwkv6/kernel.py``) are plain Python: from shapes
alone they pick the path, the chunk, the grids and the kernels a call
launches (``csrc/mamba2_scan.cu``, ``csrc/wkv6.cu``).  Here they are held
to the served shapes and their corners, and the wrappers refuse what the
kernels do not take.  A torch emulation of each kernel's arithmetic, in
the order the kernels sum -- the chunk-local pass (each chunk from a zero
state), the state pass in chunk order, then the output pass (for wkv6
with the prefix products of w, never a division) -- is held at 1e-5 in
f32 to ``repro``'s Pallas kernels in interpret mode on the same numpy
inputs, over several chunks with a short last one and an initial state.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import mamba2 as jax_mamba2  # noqa: E402
from repro.kernels import rwkv6 as jax_rwkv6  # noqa: E402
from repro.kernels.conv2d import conv2d as jax_conv2d  # noqa: E402
from repro.kernels.decode_attention import (  # noqa: E402
    decode_attention as jax_decode_attention)

from repro_torch.kernels.conv2d.kernel import (  # noqa: E402
    conv2d_strips_plain, conv2d_virtual_plain, launch_args,
    materialize_strips, strip_bypass, strips_geometry, strips_launch_args,
    unstrip, virtual_geometry)
from repro_torch.kernels.decode_attention.kernel import (  # noqa: E402
    decode_attention_plain, decode_plan)
from repro_torch.kernels.mamba2.kernel import (  # noqa: E402
    CHUNK as SSD_CHUNK, STEP_MAX, mamba2_scan_plain, ssd_plan)
from repro_torch.kernels.rwkv6.kernel import (  # noqa: E402
    CHUNK as WKV_CHUNK, wkv6_plain, wkv_plan)

TOL = 1e-5            # f32, the same sums in another order
BF16_TOL = 2.0 ** -7  # one bf16 ulp: both sides sum in f32, round once
SMEM_LIMIT = 232448   # bytes of shared memory an H100 block may use
F32, BF16 = torch.float32, torch.bfloat16


def close(ours, ref, tol=TOL):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


# --- ssd_plan -------------------------------------------------------------------
# (Bt, L, H, P, N, path, chunks, kernels, grid): zamba2-7b's admission,
# tick and a 2048-row prompt, mamba2's N = 128, the step path's longest
# L and the chunked path's shortest, widths off the 16-grid.
SSD_PLANS = [
    ((1, 512, 112, 64, 64), "chunked", 8, 3, (8, 112, 1)),
    ((8, 1, 112, 64, 64), "step", 1, 1, (112, 8)),
    ((1, 2048, 112, 64, 64), "chunked", 32, 3, (32, 112, 1)),
    ((2, 300, 40, 64, 128), "chunked", 5, 3, (5, 40, 2)),
    ((3, STEP_MAX, 8, 64, 64), "step", 1, 1, (8, 3)),
    ((3, STEP_MAX + 1, 8, 64, 64), "chunked", 1, 3, (1, 8, 3)),
    ((2, 100, 5, 24, 40), "chunked", 2, 3, (2, 5, 2)),
]


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", SSD_PLANS, ids=lambda c: str(c[0]))
def test_ssd_plan_paths_grids_and_shared_memory(case, dtype):
    (Bt, L, H, P, N), path, nc, kernels, grid = case
    plan = ssd_plan(Bt, L, H, P, N, dtype)
    assert (plan.path, plan.n_chunks, plan.kernels, plan.grid) == (
        path, nc, kernels, grid)
    assert plan.cluster == 1
    assert plan.Pp % 16 == 0 and P <= plan.Pp < P + 16
    assert plan.Np % 16 == 0 and N <= plan.Np < N + 16
    assert all(0 <= b <= SMEM_LIMIT for b in plan.smem)
    if path == "chunked":
        assert plan.chunk == SSD_CHUNK
        # the chunks cover L once, the last one short where L is ragged
        bounds = [(c * plan.chunk, min(L, (c + 1) * plan.chunk))
                  for c in range(nc)]
        assert bounds[0][0] == 0 and bounds[-1][1] == L
        assert all(hi > lo for lo, hi in bounds)
        assert plan.pass_grid == (-(-N * P // 256), Bt * H)
    else:
        assert plan.chunk == L and plan.pass_grid == ()


SSD_REFUSED = [
    (dict(dtype=torch.float16), TypeError, "x must be float32 or bfloat16"),
    (dict(P=129), ValueError, "must be 1..128"),
    (dict(N=200), ValueError, "must be 1..128"),
    (dict(L=0), ValueError, "empty scan"),
]


@pytest.mark.parametrize("case", SSD_REFUSED, ids=lambda c: c[2])
def test_ssd_plan_refuses_what_the_kernels_do_not_take(case):
    kw, exc, msg = case
    args = dict(Bt=1, L=64, H=2, P=64, N=64, dtype=F32)
    args.update(kw)
    with pytest.raises(exc, match=msg):
        ssd_plan(**args)


# --- wkv_plan -------------------------------------------------------------------
# (B, L, H, D, rows a thread, blocks of 64 value columns, chunks)
WKV_PLANS = [((1, 512, 64, 64), 8, 1, 8), ((8, 1, 64, 64), 8, 1, 1),
             ((1, 2048, 64, 64), 8, 1, 32), ((2, 130, 4, 48), 8, 1, 3),
             ((1, 70, 3, 96), 16, 2, 2), ((2, 20, 2, 1), 2, 1, 1),
             ((1, 40, 2, 128), 16, 2, 1), ((3, 7, 5, 16), 2, 1, 1),
             ((3, 7, 5, 65), 16, 2, 1)]


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", WKV_PLANS, ids=lambda c: str(c[0]))
def test_wkv_plan_grids_rows_and_shared_memory(case, dtype):
    (B, L, H, D), rows, n_cb, nc = case
    plan = wkv_plan(B, L, H, D, dtype)
    assert plan.rows == rows and 8 * plan.rows >= D
    assert plan.local_grid == (n_cb, nc, B * H)
    assert plan.out_grid == (nc, H, B)
    assert plan.pass_grid == (-(-D * D // 256), B * H)
    assert (plan.chunk, plan.n_chunks, plan.kernels, plan.cluster) == (
        WKV_CHUNK, nc, 3, 1)
    assert all(0 < b <= SMEM_LIMIT for b in plan.smem)


def test_wkv_plan_refuses_past_128_naming_c2():
    with pytest.raises(ValueError, match="C.2"):
        wkv_plan(1, 64, 2, 129, F32)
    with pytest.raises(TypeError, match="r must be float32 or bfloat16"):
        wkv_plan(1, 64, 2, 64, torch.float16)
    with pytest.raises(ValueError, match="empty recurrence"):
        wkv_plan(1, 0, 2, 64, F32)


# --- the SSD kernels' arithmetic, emulated ----------------------------------------
def ssd_emulation(x, dt, A, B, C, h0, plan):
    """``csrc/mamba2_scan.cu``'s chunked path in torch: (a) per chunk, its
    cumsum of A dt (each A dt rounded to f32, the sum carried in f64) and
    its local state (B o w)^T x, w = exp(total - cum) dt; (b) S_c =
    exp(total_c) S_{c-1} + dS_c in chunk order, keeping the state entering
    each chunk; (c) per chunk, y = G x + exp(cum) o (C S_{c-1}) with G =
    C B^T o exp(cum_t - cum_s) dt_s on s <= t.  Products in f32."""
    Bt, L, H, P = x.shape
    N = B.shape[-1]
    xf, Bf, Cf, dtf, Af = (t.float() for t in (x, B, C, dt, A))
    Q, nc = plan.chunk, plan.n_chunks
    spans = [slice(c * Q, min(L, (c + 1) * Q)) for c in range(nc)]
    cums, local, totals = [], [], []
    for sl in spans:                                       # (a)
        cum = torch.cumsum((Af[None, None] * dtf[:, sl]).double(),
                           dim=1)                          # (Bt,q,H) f64
        total = cum[:, -1]
        w = torch.exp((total[:, None] - cum).float()) * dtf[:, sl]
        local.append(torch.einsum("bsh,bsn,bshp->bhnp", w, Bf[:, sl],
                                  xf[:, sl]))
        cums.append(cum)
        totals.append(total)
    S = (h0.float() if h0 is not None
         else torch.zeros((Bt, H, N, P)))
    entering = []
    for c in range(nc):                                    # (b)
        entering.append(S)
        S = S * torch.exp(totals[c].float())[..., None, None] + local[c]
    ys = []
    for c, sl in enumerate(spans):                         # (c)
        cum = cums[c]
        q = cum.shape[1]
        CB = torch.einsum("btn,bsn->bts", Cf[:, sl], Bf[:, sl])
        mask = torch.tril(torch.ones((q, q), dtype=torch.bool))
        decay = torch.exp((cum[:, :, None] - cum[:, None]).float())
        G = torch.where(mask[None, :, :, None],
                        CB[..., None] * decay * dtf[:, sl][:, None],
                        0.0)                               # (Bt,t,s,H)
        y = torch.einsum("btsh,bshp->bthp", G, xf[:, sl])
        y = y + torch.exp(cum.float())[..., None] * torch.einsum(
            "btn,bhnp->bthp", Cf[:, sl], entering[c])
        ys.append(y)
    return torch.cat(ys, 1).to(x.dtype), S


def step_emulation(x, dt, A, B, C, h0):
    """The step path (L <= STEP_MAX): the recurrence over the state, one
    step at a time, y_t = C_t h_t."""
    Bt, L, H, P = x.shape
    N = B.shape[-1]
    h = h0.float() if h0 is not None else torch.zeros((Bt, H, N, P))
    ys = []
    for t in range(L):
        dtt = dt[:, t].float()
        decay = torch.exp(A.float()[None] * dtt)
        h = h * decay[..., None, None] + B[:, t].float()[:, None, :, None] * (
            x[:, t].float() * dtt[..., None])[:, :, None, :]
        ys.append(torch.einsum("bn,bhnp->bhp", C[:, t].float(), h))
    return torch.stack(ys, 1).to(x.dtype), h


def ssd_numpy(Bt, L, H, P, N, seed, h0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return [f(Bt, L, H, P) * 0.5, np.log1p(np.exp(f(Bt, L, H))) * 0.5,
            -np.exp(f(H) * 0.5), f(Bt, L, N) * 0.5, f(Bt, L, N) * 0.5,
            f(Bt, H, N, P) * 0.5 if h0 else None]


# (Bt, L, H, P, N, h0, Pallas chunk): three chunks of 64, 64 and 22 rows;
# one short chunk; two whole chunks; the step path.
SSD_EMULATED = [(2, 150, 2, 16, 16, True, 50), (1, 40, 3, 8, 24, True, 40),
                (1, 128, 2, 16, 8, False, 64), (2, 150, 1, 12, 16, False, 75),
                (2, 9, 2, 16, 16, True, 9), (1, STEP_MAX, 3, 8, 8, False, 8)]


@pytest.mark.parametrize("case", SSD_EMULATED, ids=lambda c: str(c[:6]))
def test_emulated_ssd_kernels_match_pallas_interpret(case):
    Bt, L, H, P, N, with_h0, pchunk = case
    arrays = ssd_numpy(Bt, L, H, P, N, seed=L + P, h0=with_h0)
    x, dt, A, B, C, h0 = (None if a is None else torch.from_numpy(a)
                          for a in arrays)
    jx, jdt, jA, jB, jC, jh0 = (None if a is None else jnp.asarray(a)
                                for a in arrays)
    plan = ssd_plan(Bt, L, H, P, N, F32)
    if plan.path == "step":
        y, h = step_emulation(x, dt, A, B, C, h0)
    else:
        assert plan.n_chunks * plan.chunk >= L
        y, h = ssd_emulation(x, dt, A, B, C, h0, plan)
    jy, jh = jax_mamba2.mamba2_scan_pallas(jx, jdt, jA, jB, jC, h0=jh0,
                                           chunk=pchunk, interpret=True)
    close(y, jy)
    close(h, jh)
    py, ph = mamba2_scan_plain(x, dt, A, B, C, h0=h0)
    close(y, py.numpy())
    close(h, ph.numpy())


# --- the WKV kernels' arithmetic, emulated ----------------------------------------
def wkv_emulation(r, k, v, w, u, s0, plan):
    """``csrc/wkv6.cu`` in f32 torch: (a) each chunk's recurrence from a
    zero state (local y = r^T S + v (r . u k), local state, W_c = prod
    w); (b) S_c = diag(W_c) S_{c-1} + dS_c in chunk order, keeping the
    state entering each chunk; (c) y_t += (r_t o a_t)^T S_{c-1} with the
    prefix products a_t = prod_{s<t} w_s, taken in four segments of 16
    steps, each scaled by the segments before it.  Products of w only:
    nothing is divided."""
    B, L, H, D = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()
    Q, nc = plan.chunk, plan.n_chunks
    spans = [range(c * Q, min(L, (c + 1) * Q)) for c in range(nc)]
    y_local = torch.zeros((B, L, H, D))
    local, decays = [], []
    for span in spans:                                     # (a)
        S = torch.zeros((B, H, D, D))
        W = torch.ones((B, H, D))
        for t in span:
            kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
            ruk = (rf[:, t] * uf[None] * kf[:, t]).sum(-1)   # (B, H)
            y_local[:, t] = (torch.einsum("bhi,bhij->bhj", rf[:, t], S)
                             + vf[:, t] * ruk[..., None])
            S = wf[:, t][..., None] * S + kv
            W = W * wf[:, t]
        local.append(S)
        decays.append(W)
    S = s0.float() if s0 is not None else torch.zeros((B, H, D, D))
    entering = []
    for c in range(nc):                                    # (b)
        entering.append(S)
        S = decays[c][..., None] * S + local[c]
    y = y_local.clone()
    seg = Q // 4
    for c, span in enumerate(spans):                       # (c)
        before = torch.ones((B, H, D))
        for s0 in range(span.start, span.start + Q, seg):
            a = torch.ones((B, H, D))
            for t in range(s0, min(s0 + seg, span.stop)):
                y[:, t] += torch.einsum("bhi,bhij->bhj",
                                        rf[:, t] * a * before, entering[c])
                a = a * wf[:, t]
            before = before * a
    return y.to(r.dtype), S


def wkv_numpy(B, L, H, D, seed, s0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return [f(B, L, H, D) * 0.5, f(B, L, H, D) * 0.5, f(B, L, H, D),
            np.exp(-np.exp(f(B, L, H, D) * 0.5)), f(H, D) * 0.3,
            f(B, H, D, D) * 0.5 if s0 else None]


# (B, L, H, D, s0, Pallas chunk): three chunks (64, 64, 22), one short
# chunk, head dims that are not powers of two.
WKV_EMULATED = [(2, 150, 2, 16, True, 50), (1, 40, 3, 12, True, 40),
                (1, 130, 2, 6, False, 65), (2, 64, 1, 20, True, 32),
                (1, 1, 2, 8, True, 1)]


@pytest.mark.parametrize("case", WKV_EMULATED, ids=lambda c: str(c[:5]))
def test_emulated_wkv_kernels_match_pallas_interpret(case):
    B, L, H, D, with_s0, pchunk = case
    arrays = wkv_numpy(B, L, H, D, seed=L + D, s0=with_s0)
    r, k, v, w, u, s0 = (None if a is None else torch.from_numpy(a)
                         for a in arrays)
    jr, jk, jv, jw, ju, js0 = (None if a is None else jnp.asarray(a)
                               for a in arrays)
    plan = wkv_plan(B, L, H, D, F32)
    y, S = wkv_emulation(r, k, v, w, u, s0, plan)
    jy, jS = jax_rwkv6.wkv6_pallas(jr, jk, jv, jw, ju, s0=js0, chunk=pchunk,
                                   interpret=True)
    close(y, jy)
    close(S, jS)
    py, pS = wkv6_plain(r, k, v, w, u, s0=s0)
    close(y, py.numpy())
    close(S, pS.numpy())


def test_wkv_prefix_products_stay_finite_where_w_nears_zero():
    """w = exp(-exp(5)) ~ 1e-65 underflows to 0 in f32: the prefix
    products reach 0 and stay finite, where a form dividing by them
    would not."""
    B, L, H, D = 1, 100, 1, 4
    rng = np.random.default_rng(3)
    r, k, v = (torch.from_numpy(rng.standard_normal((B, L, H, D))
                                .astype(np.float32)) for _ in range(3))
    w = torch.exp(-torch.exp(torch.full((B, L, H, D), 5.0)))
    u = torch.zeros((H, D))
    y, S = wkv_emulation(r, k, v, w, u, None, wkv_plan(B, L, H, D, F32))
    assert torch.isfinite(y).all() and torch.isfinite(S).all()
    py, pS = wkv6_plain(r, k, v, w, u)
    close(y, py.numpy())
    close(S, pS.numpy())


# --- C.3: bf16 convs and a float8 decode cache, plain versions vs repro -----------
# (x shape, k, Cout, stride, pad, out_rows, pool, bypass, act)
BF16_CONVS = [((1, 9, 9, 4), 3, 8, 1, 1, 3, None, True, "relu"),
              ((2, 8, 8, 5), 3, 12, 1, 1, 4, (2, 2, 0, "max"), False,
               "relu"),
              ((1, 13, 13, 3), 3, 8, 1, 1, 5, (3, 2, 1, "avg"), False,
               "tanh"),
              ((1, 11, 10, 6), 3, 8, 2, 1, 3, None, False, "gelu")]


def _conv_numpy(case, seed):
    xs, k, cout, *_ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal((k, k, xs[3], cout)) * 0.3).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    byp = rng.standard_normal((xs[0], 32, 32, cout)).astype(np.float32)
    # values exact in bf16, so both sides start from the same numbers
    bf = lambda a: torch.from_numpy(a).to(BF16)  # noqa: E731
    return bf(x), bf(w), bf(b), bf(byp)


def _jax(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("case", range(len(BF16_CONVS)))
def test_bf16_virtual_plain_matches_reference_pallas(case):
    xs, k, cout, stride, pad, rows, pool, has_byp, act = BF16_CONVS[case]
    x, w, b, byp = _conv_numpy(BF16_CONVS[case], seed=case)
    g = virtual_geometry(xs, tuple(w.shape), stride=stride, pad=pad,
                         out_rows=rows, kpt=cout, pool=pool)
    byp = byp[:, :g.OH, :g.OW].contiguous() if has_byp else None
    kw = dict(bias=b, activation=act, bypass=byp, bypass_first=False)
    out = conv2d_virtual_plain(x, w, g, **kw)
    assert out.dtype == BF16
    ref = jax_conv2d(_jax(x), _jax(w), stride=stride, pad=pad, bias=_jax(b),
                     activation=act,
                     bypass=None if byp is None else _jax(byp),
                     impl="pallas", interpret=True, strip_storage="virtual",
                     fuse_pool=pool)
    assert ref.dtype == jnp.bfloat16
    close(out, np.asarray(ref.astype(jnp.float32)), BF16_TOL)
    # the wrapper's checks take bf16 operands of one type (the launch ints
    # are the f32 ones)
    dummy = torch.empty((g.B, g.OHo, g.OWo, g.Cout), dtype=BF16)
    assert launch_args(x, w, g, dummy, bias=b, bypass=byp) == launch_args(
        x.float(), w.float(), g, dummy.float(), bias=b.float(),
        bypass=None if byp is None else byp.float())
    with pytest.raises(TypeError, match="w must be float32 or bfloat16"):
        launch_args(x, w.float(), g, dummy)


@pytest.mark.parametrize("case", [0, 3])
def test_bf16_strips_plain_matches_reference_pallas(case):
    xs, k, cout, stride, pad, rows, _, has_byp, act = BF16_CONVS[case]
    x, w, b, byp = _conv_numpy(BF16_CONVS[case], seed=10 + case)
    g = strips_geometry(xs, tuple(w.shape), stride=stride, pad=pad,
                        out_rows=rows, kpt=cout)
    byp = byp[:, :g.OH, :g.OW].contiguous() if has_byp else None
    sbyp = None if byp is None else strip_bypass(byp, g)
    strips = materialize_strips(x, g)
    kw = dict(bias=b, activation=act, bypass_first=False)
    out = unstrip(conv2d_strips_plain(strips, w, g, bypass=sbyp, **kw), g)
    assert out.dtype == BF16
    ref = jax_conv2d(_jax(x), _jax(w), stride=stride, pad=pad, bias=_jax(b),
                     activation=act,
                     bypass=None if byp is None else _jax(byp),
                     impl="pallas", interpret=True,
                     strip_storage="materialized")
    close(out, np.asarray(ref.astype(jnp.float32)), BF16_TOL)
    sout = torch.empty((g.NS, g.out_rows, g.OW, g.Cout), dtype=BF16)
    assert strips_launch_args(strips, w, g, sout, bias=b, bypass=sbyp)[:13] \
        == [g.NS, g.in_rows, g.Wp, g.Cin, g.kh, g.kw, g.Cout, g.stride,
            g.out_rows, g.OW, 0, 0, 0]
    with pytest.raises(TypeError, match="out must be float32 or bfloat16"):
        strips_launch_args(strips, w, g, sout.float())


# (B, Hq, Hkv, S, D, kv_len per sequence)
FP8_DECODES = [(2, 4, 2, 128, 32, [128, 37]), (3, 15, 5, 64, 64, [1, 64, 30]),
               (2, 8, 8, 40, 112, [40, 17])]


@pytest.mark.parametrize("qdt", ["f32", "bf16"])
@pytest.mark.parametrize("case", range(len(FP8_DECODES)))
def test_float8_decode_plain_matches_reference(case, qdt):
    """A float8 e4m3 cache (``kv_dtype="float8"``): the plain version on
    the float8 tensors against ``repro``'s reference on the same float8
    values."""
    B, Hq, Hkv, S, D, lens = FP8_DECODES[case]
    rng = np.random.default_rng(case)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = (rng.standard_normal((B, Hkv, S, D)) * 0.3).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    k8, v8 = (torch.from_numpy(a).to(torch.float8_e4m3fn) for a in (k, v))
    qt = torch.from_numpy(q).to(F32 if qdt == "f32" else BF16)
    kv_len = torch.tensor(lens, dtype=torch.int32)
    out = decode_attention_plain(qt, k8, v8, kv_len, scale=D ** -0.5)
    assert out.dtype == qt.dtype
    jq = jnp.asarray(qt.float().numpy()).astype(
        jnp.float32 if qdt == "f32" else jnp.bfloat16)
    jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.float8_e4m3fn)
              for t in (k8, v8))
    ref = jax_decode_attention(jq, jk, jv, kv_len=jnp.asarray(lens,
                                                              jnp.int32),
                               scale=D ** -0.5, impl="reference")
    close(out, np.asarray(ref.astype(jnp.float32)),
          TOL if qdt == "f32" else BF16_TOL)
    plan = decode_plan(B, Hq, Hkv, S, D, qt.dtype, kv_dtype=k8.dtype)
    assert plan.grid[0] == B * Hkv


def test_decode_plan_takes_float8_caches_at_16_a_chunk():
    E4M3 = torch.float8_e4m3fn
    assert decode_plan(8, 15, 5, 512, 64, BF16, kv_dtype=E4M3).splits > 1
    decode_plan(8, 15, 5, 512, 512, F32, kv_dtype=E4M3)
    with pytest.raises(ValueError, match="multiple of 16 up to 512"):
        decode_plan(8, 15, 5, 512, 40, BF16, kv_dtype=E4M3)
    with pytest.raises(TypeError, match="k and v must be"):
        decode_plan(8, 15, 5, 512, 64, BF16, kv_dtype=torch.int8)
