"""The flash-attention kernels' path plan and the numerics of their
tensor-core path, on the CPU.

``flash_plan`` (``repro_torch/kernels/flash_attention/kernel.py``) is
plain Python: it maps every served shape of the forward and the backward
to the bf16 mma path and f32, the smoke configs' f32 head dim 16 and
unaligned bf16 views to simt.  The mma path feeds the f32 operands of
its second products to bf16 tensor cores split into bf16 parts: the
forward's P (in P V) into hi = bf16(x) and lo = bf16(x - hi), the
backward's P and dS (in P^T dO, dS K and dS^T Q) into three parts that
sum to x exactly; a torch emulation of each product is held here to its
error bound at the smollm-360m admission shape, and the backward's
bf16 gate to passing the three-part split and refusing one rounding.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.bwd_kernel import (  # noqa: E402
    flash_attention_bwd_cuda)
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    HEAD_DIMS, aligned16, flash_attention_cuda, flash_plan)

BF16, F32 = torch.bfloat16, torch.float32

# (label, q shape, kv shape, backward, want d_tile, grid, kv_grid): the
# served flash calls.  smollm-360m: 15 q / 5 kv heads of 64, max_len
# 512 (an admission, a 128-row chunk against its 512-row ring, the
# training step at batch 8); zamba2-7b's shared block: 32 / 32 heads
# of 112.
SERVED = [
    ("smollm admission", (1, 15, 512, 64), (1, 5, 512, 64), False, 64,
     (15, 8), None),
    ("smollm chunk", (1, 15, 128, 64), (1, 5, 512, 64), False, 64,
     (15, 2), None),
    ("zamba2 admission", (1, 32, 512, 112), (1, 32, 512, 112), False, 112,
     (32, 8), None),
    ("training forward", (8, 15, 512, 64), (8, 5, 512, 64), False, 64,
     (120, 8), None),
    ("training backward", (8, 15, 512, 64), (8, 5, 512, 64), True, 64,
     (120, 8), (40, 8)),
]


@pytest.mark.parametrize("case", SERVED, ids=[c[0] for c in SERVED])
def test_served_bf16_shapes_plan_the_mma_path(case):
    _, qs, kvs, backward, d_tile, grid, kv_grid = case
    plan = flash_plan(qs, kvs, BF16, backward=backward)
    assert plan.path == "mma"
    assert (plan.d_tile, plan.grid, plan.kv_grid) == (d_tile, grid, kv_grid)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("D", [16, 64, 112])
def test_f32_plans_simt(D, backward):
    plan = flash_plan((2, 4, 70, D), (2, 2, 130, D), F32, backward=backward)
    assert plan.path == "simt"
    assert plan.d_tile == 32 * -(-D // 32)
    assert plan.grid == (2, 8)
    assert plan.kv_grid == ((3, 4) if backward else None)


def test_the_smoke_step_plans_simt():
    """The smoke config trains in f32 at head dim 16 (4 q / 2 kv heads in
    the smoke smollm, batch 2 x 64): forward and backward on simt."""
    for backward in (False, True):
        plan = flash_plan((2, 4, 64, 16), (2, 2, 64, 16), F32,
                          backward=backward)
        assert (plan.path, plan.d_tile) == ("simt", 32)


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_every_head_dim_plans_mma_on_tiles_of_16(D):
    plan = flash_plan((1, 2, 64, D), (1, 1, 64, D), BF16)
    assert (plan.path, plan.d_tile) == ("mma", 16 * -(-D // 16))


def _views():
    """(label, q) bf16 views the mma path cannot load in 16-byte vectors."""
    flat = torch.zeros(2 * 16 * 64 + 8, dtype=BF16)
    base_off = flat[1:1 + 2 * 16 * 64].view(1, 2, 16, 64)
    rows = torch.zeros((1, 16, 1, 68), dtype=BF16)[..., :64].transpose(1, 2)
    return [("base off 16 bytes", base_off), ("row stride 136 bytes", rows)]


@pytest.mark.parametrize("i", range(2), ids=[v[0] for v in _views()])
def test_unaligned_bf16_views_plan_simt(i):
    _, q = _views()[i]
    k = torch.zeros((1, 1, 16, 64), dtype=BF16)
    assert not aligned16(q, k, k)
    assert aligned16(q.clone(), k, k)
    plan = flash_plan(q.shape, k.shape, BF16, aligned=aligned16(q, k, k))
    assert plan.path == "simt"


def test_executor_views_are_aligned():
    """The executor's transposed (B, S, H, D) head views of a contiguous
    buffer keep 16-byte vectors: they plan mma."""
    q = torch.zeros((1, 512, 15, 64), dtype=BF16).transpose(1, 2)
    k = torch.zeros((1, 512, 5, 64), dtype=BF16).transpose(1, 2)
    assert aligned16(q, k, k)
    assert flash_plan(q.shape, k.shape, BF16,
                      aligned=aligned16(q, k, k)).path == "mma"


@pytest.mark.parametrize("D", [0, 4, 12, 130, 136])
def test_forward_head_dims_outside_the_kernels_raise(D):
    with pytest.raises(ValueError, match="head dim"):
        flash_plan((1, 2, 64, D), (1, 1, 64, D), BF16)


def test_backward_takes_any_head_dim_up_to_128():
    assert flash_plan((1, 2, 64, 12), (1, 1, 64, 12), BF16,
                      backward=True).path == "simt"
    with pytest.raises(ValueError, match="128"):
        flash_plan((1, 2, 64, 136), (1, 1, 64, 136), BF16, backward=True)


def test_other_types_raise():
    with pytest.raises(TypeError):
        flash_plan((1, 2, 64, 64), (1, 1, 64, 64), torch.float16)


def test_cuda_entry_points_raise_on_cpu_tensors():
    q = torch.zeros((1, 2, 16, 64), dtype=BF16)
    k = torch.zeros((1, 1, 16, 64), dtype=BF16)
    with pytest.raises(RuntimeError, match="CUDA"):
        flash_attention(q, k, k, causal=True, impl="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        flash_attention_cuda(q, k, k, scale=1.0, causal=True, window=None,
                             kv_len=None)
    lse = torch.zeros((1, 2, 16))
    with pytest.raises(RuntimeError, match="CUDA"):
        flash_attention_bwd_cuda(q, k, k, q, lse, q, scale=1.0, causal=True,
                                 window=None, kv_len=None)


def test_path_counters_start_per_path():
    assert set(flash_attention_cuda.path_launches) == {"mma", "simt"}
    assert set(flash_attention_bwd_cuda.path_launches) == {"mma", "simt"}


# --- the split-bf16 product -------------------------------------------------
def _split(x, parts=2):
    """x as ``parts`` bf16-valued f32 tensors: each the bf16 rounding of
    what the earlier ones leave."""
    out = []
    for _ in range(parts):
        out.append(x.to(BF16).float())
        x = x - out[-1]
    return out


def _operands(kind: str):
    """(A f32, B bf16-valued f32) of one smollm-360m admission product,
    (15 heads, 512 rows): P V with P a causal softmax of random scores,
    or dS K with dS = P (dP - delta) / 8 of random dP, as the backward
    forms it."""
    rng = np.random.default_rng(0)
    H, S, D = 15, 512, 64
    q, k = (torch.from_numpy(rng.standard_normal((H, S, D))).to(BF16).float()
            for _ in range(2))
    b = torch.from_numpy(rng.standard_normal((H, S, D))).to(BF16).float()
    s = (q @ k.transpose(1, 2)) * D ** -0.5
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -1e30)
    p = torch.softmax(s, dim=-1)
    if kind == "P V":
        return p, b
    dp = torch.from_numpy(rng.standard_normal((H, S, S))).float()
    delta = (p * dp).sum(-1, keepdim=True)
    return p * (dp - delta) * D ** -0.5, b


# (operands, parts): the forward's P V in two parts, the backward's
# dS K and P^T dO (as P V) in three.
SPLITS = {"P V": ("P V", 2), "dS K": ("dS K", 3), "P dO": ("P V", 3)}


@pytest.mark.parametrize("case", SPLITS)
def test_split_bf16_product_within_its_bound(case):
    """The parts' products B summed in f32 stay within 2^-15 (|A| @ |B|)
    of the f32 product A B, elementwise (a bound on the sum of absolute
    terms: P V and dS K cancel); one bf16 rounding of A does not."""
    kind, parts = SPLITS[case]
    a, b = _operands(kind)
    exact = a.double() @ b.double()
    split = sum(part @ b for part in _split(a, parts))
    hi = _split(a, 1)[0]
    bound = 2.0 ** -15 * (a.abs().double() @ b.abs().double())
    f32 = a @ b
    assert bool(((split.double() - f32.double()).abs() <= bound).all())
    assert bool(((split.double() - exact).abs() <= bound).all())
    assert not bool(((hi.double() @ b.double() - exact).abs()
                     <= bound).all())


@pytest.mark.parametrize("kind", ["P V", "dS K"])
def test_three_bf16_parts_sum_to_the_f32_operand(kind):
    """The backward's split: hi + mi + lo == x for every P and dS
    element (each part takes the next 8 bits of the 24-bit mantissa,
    and every difference is exact in f32), while two parts are not."""
    a, _ = _operands(kind)
    hi, mi, lo = _split(a, 3)
    assert torch.equal((hi + mi) + lo, a)
    assert torch.equal(lo, lo.to(BF16).float())
    assert not torch.equal(sum(_split(a, 2)), a)


# --- the backward's bf16 gate (chip_smoke.py::check_flash_bwd) ---------------
def _emulated_bwd(q, k, v, out, lse, do, scale, rounding):
    """(dq, dk, dv) in bf16 from f32 products in 64-key tiles, as the
    kernels order them, with P and dS fed to the second products split
    into three bf16 parts ("split", the mma path) or rounded once to bf16
    ("once")."""
    B, Hq, S, D = q.shape
    G = Hq // k.shape[1]
    f = lambda t: t.float()
    kk, vv = f(k).repeat_interleave(G, 1), f(v).repeat_interleave(G, 1)
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    s = (f(q) @ kk.transpose(-1, -2)) * scale
    p = torch.exp(s.masked_fill(~causal, -1e30) - lse[..., None])
    dp = f(do) @ vv.transpose(-1, -2)
    ds = p * (dp - (f(do) * f(out)).sum(-1, keepdim=True)) * scale

    def r(x):
        return sum(_split(x, 3 if rounding == "split" else 1))
    dq = sum(r(ds[..., t:t + 64]) @ kk[:, :, t:t + 64]
             for t in range(0, S, 64))
    dk = (r(ds).transpose(-1, -2) @ f(q)).reshape(B, -1, G, S, D).sum(2)
    dv = (r(p).transpose(-1, -2) @ f(do)).reshape(B, -1, G, S, D).sum(2)
    return dq.to(BF16), dk.to(BF16), dv.to(BF16)


def test_backward_gate_takes_the_split_and_refuses_one_rounding():
    """chip_smoke's bf16 backward gate (one ulp of the plain result plus
    the f32 rounding bound of its sums) passes the three-part split-bf16
    products and the plain version with its sums reordered (64-key
    chunks), and fails P and dS rounded once to bf16."""
    from repro_torch.kernels.flash_attention.ref import (flash_bwd_ref,
                                                         flash_ref)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    rng = np.random.default_rng(1)
    B, Hq, Hkv, S, D = 1, 6, 2, 256, 64
    q, do = (torch.from_numpy(rng.standard_normal((B, Hq, S, D))).to(BF16)
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, Hkv, S, D))).to(BF16)
            for _ in range(2))
    kw = dict(scale=D ** -0.5, causal=True, window=None, kv_len=None)
    out, lse = flash_ref(q, k, v, causal=True, return_lse=True)
    want = flash_bwd_ref(q, k, v, out, lse, do, **kw)
    mags = chip_smoke.bwd_magnitudes(q, k, v, out, lse, do, **kw)
    slack = chip_smoke.bwd_slack(S, D)
    reorder = flash_bwd_ref(q, k, v, out, lse, do, chunk=64, **kw)
    split = _emulated_bwd(q, k, v, out, lse, do, D ** -0.5, "split")
    for got in (reorder, split):
        for g, w, m in zip(got, want, mags):
            chip_smoke.max_err_ulp(g, w, slack * m)
    once = _emulated_bwd(q, k, v, out, lse, do, D ** -0.5, "once")
    with pytest.raises(SystemExit, match="tolerance"):
        for g, w, m in zip(once, want, mags):
            chip_smoke.max_err_ulp(g, w, slack * m)
