"""The scan kernels' autograd Functions (``kernels/mamba2/ops.py::
_ScanTrainable``, ``kernels/rwkv6/ops.py::_WkvTrainable``) on the CPU,
the plain (sequential f32) forward standing in for each CUDA launcher:
under grad mode the kernel path goes through the Function, whose
gradients equal autograd through the chunked form (the reference's own
gradient), with and without an initial state and with the final state
unread; and the graphed training step of zamba2 and rwkv6 through the
CUDA-graph stand-in, its launch counts exact and its steps bitwise
those of eager ones."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels.flash_attention import bwd_kernel as bwd_k  # noqa
from repro_torch.kernels.flash_attention import kernel as fwd_k  # noqa: E402
from repro_torch.kernels.mamba2 import kernel as scan_k  # noqa: E402
from repro_torch.kernels.mamba2 import ops as scan_ops  # noqa: E402
from repro_torch.kernels.mamba2.ref import mamba2_scan_chunked  # noqa: E402
from repro_torch.kernels.rwkv6 import kernel as wkv_k  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6.ref import wkv6_chunked  # noqa: E402
from repro_torch.launch.steps import build_train_step  # noqa: E402
from repro_torch.models import get_model, params_from_numpy  # noqa: E402
from repro_torch.optim import AdamW, cosine_schedule  # noqa: E402
from repro_torch.runtime import executor  # noqa: E402

from test_torch_cnn import numpy_params  # noqa: E402
from test_torch_graphs import graphs  # noqa: E402,F401
from test_torch_train_graph import flash_counting  # noqa: E402,F401


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


# --- the scan kernels' autograd Functions -----------------------------------------
@pytest.fixture
def scans_on_kernel_path(monkeypatch):
    """Both scan ops down their kernel path on CPU tensors, each CUDA
    launcher's plain (sequential f32) version in its place, counting in
    the real wrappers' ``launches``."""
    def scan(x, dt, A, B, C, *, h0=None):
        scan_k.mamba2_scan_cuda.launches += 1
        return scan_k.mamba2_scan_plain(x, dt, A, B, C, h0=h0)

    def wkv(r, k, v, w, u, *, s0=None):
        wkv_k.wkv6_cuda.launches += 1
        return wkv_k.wkv6_plain(r, k, v, w, u, s0=s0)
    for ops, name, fn in ((scan_ops, "mamba2_scan_cuda", scan),
                          (wkv_ops, "wkv6_cuda", wkv)):
        monkeypatch.setattr(ops, "use_kernel", lambda impl, x: True)
        monkeypatch.setattr(ops, name, fn)
    for fn in (scan_k.mamba2_scan_cuda, wkv_k.wkv6_cuda):
        monkeypatch.setattr(fn, "launches", 0)


def _ssd_inputs(with_h0, seed=3):
    g = torch.Generator().manual_seed(seed)
    Bt, L, H, P, N = 2, 40, 3, 8, 6
    x = torch.randn(Bt, L, H, P, generator=g)
    dt = torch.rand(Bt, L, H, generator=g) * 0.5
    A = -torch.rand(H, generator=g) - 0.2
    B, C = (torch.randn(Bt, L, N, generator=g) for _ in range(2))
    h0 = torch.randn(Bt, H, N, P, generator=g) if with_h0 else None
    return [x, dt, A, B, C, h0]


def _wkv_inputs(with_s0, seed=4):
    g = torch.Generator().manual_seed(seed)
    B, L, H, D = 2, 40, 3, 8
    r, k, v = (torch.randn(B, L, H, D, generator=g) for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(B, L, H, D, generator=g) * 0.5))
    u = torch.randn(H, D, generator=g)
    s0 = torch.randn(B, H, D, D, generator=g) if with_s0 else None
    return [r, k, v, w, u, s0]


def _leaves(xs):
    return [None if t is None else t.clone().requires_grad_() for t in xs]


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("kind", ["mamba2_scan", "wkv6"])
def test_trainable_scan_grads_equal_chunked_autograd(scans_on_kernel_path,
                                                     kind, with_state):
    """Under grad mode the kernel path goes through the Function (its
    forward the launcher, counted once), and its gradients in every
    input equal autograd through the chunked form on the same inputs and
    upstream gradients (y and the final state both read); under
    ``no_grad`` the launcher is called directly."""
    if kind == "mamba2_scan":
        inputs = _ssd_inputs(with_state)
        D_skip = torch.rand(inputs[0].shape[2]) + 0.5

        def kernel_path(x, dt, A, B, C, h0):
            return scan_ops.mamba2_scan(x, dt, A, B, C, D_skip=D_skip, h0=h0,
                                        return_state=True, impl="cuda")

        def chunked(x, dt, A, B, C, h0):
            return mamba2_scan_chunked(x, dt, A, B, C, D_skip=D_skip, h0=h0,
                                       return_state=True, chunk=256)
        launcher, fn_name = scan_k.mamba2_scan_cuda, "_ScanTrainable"
    else:
        inputs = _wkv_inputs(with_state)

        def kernel_path(r, k, v, w, u, s0):
            return wkv_ops.wkv6(r, k, v, w, u, s0=s0, return_state=True,
                                impl="cuda")

        def chunked(r, k, v, w, u, s0):
            return wkv6_chunked(r, k, v, w, u, s0=s0, return_state=True)
        launcher, fn_name = wkv_k.wkv6_cuda, "_WkvTrainable"
    got_in, want_in = _leaves(inputs), _leaves(inputs)
    y, s = kernel_path(*got_in)
    assert launcher.launches == 1
    assert fn_name in type(s.grad_fn).__name__
    y_want, s_want = chunked(*want_in)
    torch.testing.assert_close(y, y_want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s, s_want, rtol=1e-4, atol=1e-4)
    g = torch.Generator().manual_seed(9)
    dy, ds = torch.randn(y.shape, generator=g), torch.randn(s.shape,
                                                           generator=g)
    ((y * dy).sum() + (s * ds).sum()).backward()
    ((y_want * dy).sum() + (s_want * ds).sum()).backward()
    assert launcher.launches == 1          # the backward launches nothing
    for i, (a, b) in enumerate(zip(got_in, want_in)):
        if a is not None:
            torch.testing.assert_close(a.grad, b.grad, rtol=1e-5,
                                       atol=1e-5 * b.grad.abs().max().item(),
                                       msg=f"input {i}")
    with torch.no_grad():
        y2, _ = kernel_path(*inputs)
    assert launcher.launches == 2 and y2.grad_fn is None


@pytest.mark.parametrize("kind", ["mamba2_scan", "wkv6"])
def test_trainable_scan_without_the_final_state(scans_on_kernel_path, kind):
    """Training reads only y: the Function's backward gets no gradient
    for the final state and still matches the chunked form's for the
    same upstream gradient."""
    if kind == "mamba2_scan":
        inputs = _ssd_inputs(False)
        got_in, want_in = _leaves(inputs), _leaves(inputs)
        y = scan_ops.mamba2_scan(*got_in[:5], impl="cuda")
        y_want = mamba2_scan_chunked(*want_in[:5], chunk=256)
    else:
        inputs = _wkv_inputs(False)
        got_in, want_in = _leaves(inputs), _leaves(inputs)
        y = wkv_ops.wkv6(*got_in[:5], impl="cuda")
        y_want = wkv6_chunked(*want_in[:5])
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(8))
    (y * dy).sum().backward()
    (y_want * dy).sum().backward()
    for a, b in zip(got_in[:5], want_in[:5]):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5,
                                   atol=1e-5 * b.grad.abs().max().item())


@pytest.mark.parametrize("arch,remat", [("zamba2-7b", True),
                                        ("rwkv6-7b", False)])
def test_graphed_step_launch_counts(graphs, scans_on_kernel_path,
                                    flash_counting, arch, remat):
    """Through the CUDA-graph stand-in, with every kernel's plain version
    counting as its launch: n steps make n x (L scans, 2L under remat;
    zamba2's shared attention one flash forward per application, two
    under remat, and one backward), the capture's bumps rolled back;
    the graphed steps bitwise equal to eager ones."""
    cfg = REGISTRY[arch].smoke()
    tree = numpy_params(get_model(cfg).param_defs(cfg), 0)
    opt = AdamW(lr=cosine_schedule(3e-3, warmup=1, total=4))
    data = SyntheticLM(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=7)
    batches = [{k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}
               for i in range(3)]
    params = params_from_numpy(tree)
    state = opt.init(params)
    step = build_train_step(cfg, opt, remat=remat)
    L = cfg.n_layers
    apps = -(-L // cfg.shared_attn_every) if cfg.shared_attn_every else 0
    scan = scan_k.mamba2_scan_cuda if arch == "zamba2-7b" else wkv_k.wkv6_cuda
    per = 2 if remat else 1
    got = []
    for n, batch in enumerate(batches, start=1):
        got.append(step(params, state, batch)[2])
        assert scan.launches == n * per * L
        assert fwd_k.flash_attention_cuda.launches == n * per * apps
        assert bwd_k.flash_attention_bwd_cuda.launches == n * apps
    assert len(graphs) == 1 and graphs[0].replays == 2
    eparams = params_from_numpy(tree)
    estate = opt.init(eparams)
    with executor.disable_graphs():
        estep = build_train_step(cfg, opt, remat=remat)
        want = [estep(eparams, estate, b)[2] for b in batches]
    for g, w in zip(got, want):
        assert all(torch.equal(g[k], w[k]) for k in w), (g, w)
    for a, b in zip(_flat(params).values(), _flat(eparams).values()):
        assert torch.equal(a, b)


def test_chunked_scan_gradient_stays_finite_past_the_decay_range():
    """A chunk whose decay spans more than e^88 (A dt ~ 1 over 128
    steps, as zamba2-7b's random init gives at L = 512): the reference's
    chunked form exponentiates the masked upper triangle and its gradient
    is NaN there; the port's zeroes that exponent, so its gradient is
    finite and equals autograd through the sequential oracle."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.kernels.mamba2.ref import mamba2_scan_chunked as jchunked
    from repro_torch.kernels.mamba2.ref import mamba2_scan_ref
    L = 128
    g = torch.Generator().manual_seed(6)
    inputs = [torch.randn((2, L, 3, 8), generator=g),
              torch.rand((2, L, 3), generator=g) + 0.5,
              -torch.rand(3, generator=g) - 1.0,
              torch.randn((2, L, 6), generator=g),
              torch.randn((2, L, 6), generator=g)]
    dy = torch.randn((2, L, 3, 8), generator=g)
    got_in, want_in = _leaves(inputs), _leaves(inputs)
    (mamba2_scan_chunked(*got_in, chunk=128) * dy).sum().backward()
    (mamba2_scan_ref(*want_in) * dy).sum().backward()
    for a, b in zip(got_in, want_in):
        assert torch.isfinite(a.grad).all()
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4,
                                   atol=1e-4 * b.grad.abs().max().item())

    def jloss(x, dt, A, B, C):
        return (jchunked(x, dt, A, B, C, chunk=128)
                * jnp.asarray(dy.numpy())).sum()
    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(t.numpy()) for t in inputs))
    assert not np.isfinite(np.asarray(jgrads[1])).all()


def test_chunked_wkv_gradient_stays_finite_past_the_decay_range():
    """Decays w = exp(-exp(x)) down to ~1e-9 (|log w| ~ 20, as rwkv6-7b's
    reach after a step from random init), differentiated in x as the
    model does: the reference's mid-chunk factors pass e^88 and its
    gradient is NaN; the port's pair decays keep every exponent <= 0, so
    its gradient is finite and equals autograd through the sequential
    oracle."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.kernels.rwkv6.ref import wkv6_chunked as jchunked
    from repro_torch.kernels.rwkv6.ref import wkv6_ref
    g = torch.Generator().manual_seed(7)
    B, L, H, D = 2, 32, 2, 8
    inputs = [torch.randn((B, L, H, D), generator=g) for _ in range(3)] + [
        torch.rand((B, L, H, D), generator=g) * 3.0,
        torch.randn((H, D), generator=g)]
    dy = torch.randn((B, L, H, D), generator=g)

    def decayed(fn, r, k, v, x, u):
        return fn(r, k, v, torch.exp(-torch.exp(x)), u)
    got_in, want_in = _leaves(inputs), _leaves(inputs)
    (decayed(wkv6_chunked, *got_in) * dy).sum().backward()
    (decayed(wkv6_ref, *want_in) * dy).sum().backward()
    for a, b in zip(got_in, want_in):
        assert torch.isfinite(a.grad).all()
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4,
                                   atol=1e-4 * b.grad.abs().max().item())

    def jloss(r, k, v, x, u):
        return (jchunked(r, k, v, jnp.exp(-jnp.exp(x)), u)
                * jnp.asarray(dy.numpy())).sum()
    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(t.numpy()) for t in inputs))
    assert not all(np.isfinite(np.asarray(j)).all() for j in jgrads)
