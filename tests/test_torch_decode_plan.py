"""The decode-attention kernels' split plan and the arithmetic of their
split-and-merge, on the CPU.

``decode_plan`` (``repro_torch/kernels/decode_attention/kernel.py``) is
plain Python: from shapes alone it cuts each (sequence, kv head) pair's
cache rows into spans that one CTA each walks in row tiles, the splits of
a pair one cluster that merges their partials in split order
(``csrc/decode_split.cuh``).  Here it is held to every served decode
shape and to the refusals of the wrappers; and a torch emulation of the
kernels' arithmetic -- per split, row tiles with the softmax taken once
per tile in log2 units, an f32 partial (m, l, acc), then the merge in
split order -- is held at 1e-5 in f32 to the port's plain versions and
to ``repro``'s reference, on the cases that reach the plan's corners.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import decode_attention as jax_decode  # noqa: E402
from repro.kernels.decode_attention import (  # noqa: E402
    decode_attention_ref as jax_decode_ref)
from repro.kernels.decode_attention import (  # noqa: E402
    paged_decode_attention as jax_paged)

from repro_torch.kernels.decode_attention.kernel import (  # noqa: E402
    MAX_SPLITS, TARGET_CTAS, decode_plan)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref, gather_pages, paged_decode_attention_ref)

BF16, F32, I8 = torch.bfloat16, torch.float32, torch.int8
TOL = 1e-5          # f32, the same function summed in another order
NEG_INF = -1e30
LOG2E = 1.4426950408889634

# (label, B, Hq, Hkv, cache_len, D, dtype, pool dtype, page_size,
#  want tile_rows, split_rows, splits): every served decode call and the
# card tests' corners.  smollm-360m: 8 slots, 15 q / 5 kv heads of 64,
# max_len 512 (window 128: a 128-row ring), paged 32 pages of 16 in bf16
# or int8; zamba2-7b's shared block: 32 / 32 heads of 112; the smoke
# configs (f32, head dim 16, max_len 64, pages of 8).
SERVED = [
    ("smollm decode", 8, 15, 5, 512, 64, BF16, None, None, 64, 64, 8),
    ("smollm window 128", 8, 15, 5, 128, 64, BF16, None, None, 32, 32, 4),
    ("smollm paged bf16", 8, 15, 5, 512, 64, BF16, BF16, 16, 64, 64, 8),
    ("smollm paged int8", 8, 15, 5, 512, 64, BF16, I8, 16, 64, 64, 8),
    ("zamba2 decode", 8, 32, 32, 512, 112, BF16, None, None, 32, 192, 3),
    ("smollm smoke", 8, 4, 2, 64, 16, F32, None, None, 32, 32, 2),
    ("smollm smoke paged", 8, 4, 2, 64, 16, F32, F32, 8, 32, 32, 2),
    ("zamba2 smoke", 8, 4, 4, 64, 16, F32, None, None, 32, 32, 2),
    ("card: ends mid-split", 4, 8, 2, 256, 64, BF16, None, None, 32, 32, 8),
    ("card: one split", 66, 8, 8, 96, 64, BF16, None, None, 32, 96, 1),
    ("card: paged mid-split", 4, 8, 2, 128, 64, BF16, BF16, 8, 32, 32, 4),
    ("card: paged one split", 66, 16, 8, 64, 64, BF16, BF16, 16, 32, 64, 1),
    ("card: paged D 112", 8, 15, 5, 512, 112, BF16, I8, 16, 64, 64, 8),
    ("card: paged D 96", 3, 6, 2, 128, 96, BF16, BF16, 16, 32, 32, 4),
]


@pytest.mark.parametrize("case", SERVED, ids=[c[0] for c in SERVED])
def test_served_decode_shapes_plan(case):
    _, B, Hq, Hkv, S, D, dt, pool, pg, tile, rows, splits = case
    plan = decode_plan(B, Hq, Hkv, S, D, dt, kv_dtype=pool, page_size=pg)
    assert (plan.tile_rows, plan.split_rows, plan.splits) == (tile, rows,
                                                              splits)
    assert plan.grid == (B * Hkv, splits)
    assert plan.splits <= MAX_SPLITS and plan.split_rows % plan.tile_rows == 0
    assert (plan.splits - 1) * plan.split_rows < S <= plan.splits * rows
    if pg is not None:
        assert plan.split_rows % pg == 0
        assert pg % plan.tile_rows == 0 or plan.tile_rows % pg == 0


def test_the_smollm_tick_fills_the_card():
    """At least one CTA per SM (132 on an H100) for the 8-slot tick, each
    kernel; zamba2's 256 pairs are not split past TARGET_CTAS."""
    for pg, pool in ((None, None), (16, BF16), (16, I8)):
        plan = decode_plan(8, 15, 5, 512, 64, BF16, kv_dtype=pool,
                           page_size=pg)
        assert plan.grid[0] * plan.grid[1] >= 132
    z = decode_plan(8, 32, 32, 512, 112, BF16)
    assert z.splits == math.ceil(TARGET_CTAS / 256)


@pytest.mark.parametrize("pool", [BF16, I8, F32])
@pytest.mark.parametrize("D", [96, 112])
def test_paged_head_dims_without_a_power_of_two(D, pool):
    plan = decode_plan(8, 15, 5, 512, D, BF16, kv_dtype=pool, page_size=16)
    assert plan.splits >= 1


@pytest.mark.parametrize("page_size", [4, 12, 48, 128])
def test_paged_tiles_and_splits_are_whole_pages(page_size):
    plan = decode_plan(2, 6, 2, 1536, 64, BF16, page_size=page_size)
    assert plan.split_rows % page_size == 0
    if page_size <= plan.tile_rows:
        assert plan.tile_rows % page_size == 0
    else:
        assert page_size % plan.tile_rows == 0


# (kwargs, exception, message): what the kernels refuse, with the
# wrappers' messages.
REFUSED = [
    (dict(dtype=torch.float16), TypeError,
     "decode_attention_cuda: q must be float32 or bfloat16, got"),
    (dict(dtype=torch.float16, page_size=16), TypeError,
     "paged_decode_attention_cuda: q must be float32 or bfloat16 with its "
     "head dim contiguous"),
    (dict(Hq=18, Hkv=2), ValueError, "the group must divide and be <= 8"),
    (dict(Hq=16, Hkv=3), ValueError, "the group must divide"),
    (dict(D=100), ValueError, "head dim 100 must be a multiple of 8 up to "
     "256"),
    (dict(D=264), ValueError, "head dim 264 must be a multiple of 8"),
    (dict(D=130, dtype=F32), ValueError, "multiple of 4 up to 128"),
    (dict(D=520, kv_dtype=I8, page_size=16), ValueError,
     "head dim 520 must be a multiple of 16 up to 512 for torch.int8 pools"),
    (dict(D=40, kv_dtype=I8, page_size=16), ValueError,
     "multiple of 16 up to 512"),
    (dict(kv_dtype=torch.float16, page_size=16), TypeError,
     "pools must be float32, bfloat16 or int8"),
]


@pytest.mark.parametrize("case", REFUSED, ids=lambda c: c[2][:40])
def test_plan_refuses_what_the_kernels_do_not_take(case):
    kw, exc, msg = case
    args = dict(B=8, Hq=15, Hkv=5, cache_len=512, D=64, dtype=BF16)
    args.update(kw)
    with pytest.raises(exc, match=msg):
        decode_plan(args.pop("B"), args.pop("Hq"), args.pop("Hkv"),
                    args.pop("cache_len"), args.pop("D"), args.pop("dtype"),
                    **args)


# --- the split-and-merge, emulated ------------------------------------------
def split_emulation(q, rows_of, kv_len, plan, scale):
    """The kernels' arithmetic in f32 torch: for each (b, kv head) pair and
    each split of ``plan``, row tiles with the softmax once per tile (log2
    units), the partial (m, l, acc) of each of the pair's G heads; then
    the merge in split order.  ``rows_of(b, hk, lo, hi)`` gives (K, V)
    rows [lo, hi) of the pair as (n, D) f32."""
    B, Hq, D = q.shape
    Hkv = plan.grid[0] // B
    G = Hq // Hkv
    out = torch.empty((B, Hq, D))
    T = plan.tile_rows
    for b in range(B):
        length = int(kv_len[b])
        for hk in range(Hkv):
            qg = q[b, hk * G:(hk + 1) * G].float()           # (G, D)
            parts = []
            for s in range(plan.splits):
                lo = s * plan.split_rows
                hi = min(length, lo + plan.split_rows)
                m = torch.full((G,), NEG_INF)
                l = torch.zeros(G)
                acc = torch.zeros(G, D)
                for r0 in range(lo, hi, T):                   # no tile if
                    k, v = rows_of(b, hk, r0, min(hi, r0 + T))  # lo >= hi
                    sc = (qg @ k.T) * (scale * LOG2E)         # (G, rows)
                    m_new = torch.maximum(m, sc.max(dim=1).values)
                    p = torch.exp2(sc - m_new[:, None])
                    alpha = torch.exp2(m - m_new)
                    l = l * alpha + p.sum(dim=1)
                    acc = acc * alpha[:, None] + p @ v
                    m = m_new
                parts.append((m, l, acc))
            M = torch.stack([m for m, _, _ in parts]).max(dim=0).values
            L = torch.zeros(G)
            a = torch.zeros(G, D)
            for m, l, acc in parts:                           # split order
                w = torch.exp2(m - M)
                L = L + l * w
                a = a + acc * w[:, None]
            out[b, hk * G:(hk + 1) * G] = a / L.clamp_min(1e-30)[:, None]
    return out


# (label, B, Hq, Hkv, S, D, kv_len): 8 splits of 32 rows at 8 pairs.
RING = [
    ("kv_len 1 and a boundary", 4, 6, 2, 256, 16, [1, 64, 96, 255]),
    ("all dead but the first", 4, 6, 2, 256, 16, [20, 3, 32, 31]),
    ("full wrapped rings", 4, 6, 2, 256, 16, [256, 256, 200, 1]),
    ("one split", 66, 8, 8, 40, 16, [1 + (7 * i) % 40 for i in range(66)]),
]


@pytest.mark.parametrize("case", RING, ids=[c[0] for c in RING])
def test_split_merge_matches_the_references(case):
    _, B, Hq, Hkv, S, D, lens = case
    rng = np.random.default_rng(S + B)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    kv_len = np.asarray(lens, np.int32)
    plan = decode_plan(B, Hq, Hkv, S, D, F32)
    if case[0] == "one split":
        assert plan.splits == 1
    else:
        assert (plan.splits, plan.split_rows) == (8, 32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = split_emulation(tq, lambda b, h, lo, hi: (tk[b, h, lo:hi],
                                                   tv[b, h, lo:hi]),
                          kv_len, plan, D ** -0.5)
    ref = decode_attention_ref(tq, tk, tv, kv_len=torch.from_numpy(kv_len))
    jref = jax_decode_ref(*map(jnp.asarray, (q, k, v)),
                          kv_len=jnp.asarray(kv_len))
    torch.testing.assert_close(got, ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_decode(*map(jnp.asarray, (q, k, v)),
                                           kv_len=jnp.asarray(kv_len),
                                           impl="reference")),
        rtol=0, atol=TOL)


@pytest.mark.parametrize("pool", ["f32", "int8"])
def test_paged_split_merge_matches_the_references(pool):
    """Pages of 8 rows, 32 per sequence (8 splits of 4 pages); sequences
    1 and 3 share sequence 0's first pages, as prefix sharing leaves
    them; kv_len 1, a split boundary (64), and a full ring."""
    B, Hq, Hkv, D, pg, pps = 4, 8, 2, 16, 8, 32
    rng = np.random.default_rng(7)
    n_pages = B * pps + 1
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((n_pages, pg, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages, pg, Hkv, D)).astype(np.float32)
    table = (rng.permutation(n_pages - 1)[:B * pps] + 1).reshape(B, pps)
    table[1, :5] = table[0, :5]
    table[3, :12] = table[0, :12]
    table = table.astype(np.int32)
    kv_len = np.asarray([256, 40, 1, 64], np.int32)
    scales = {}
    if pool == "int8":
        ks = (np.abs(kp).max(axis=(1, 2, 3)) / 127).astype(np.float32)
        vs = (np.abs(vp).max(axis=(1, 2, 3)) / 127).astype(np.float32)
        kp = np.round(kp / ks[:, None, None, None]).astype(np.int8)
        vp = np.round(vp / vs[:, None, None, None]).astype(np.int8)
        scales = {"k_scale": ks, "v_scale": vs}
    plan = decode_plan(B, Hq, Hkv, pg * pps, D, F32,
                       kv_dtype=I8 if pool == "int8" else F32, page_size=pg)
    assert (plan.splits, plan.split_rows, plan.tile_rows) == (8, 32, 32)
    tq, tkp, tvp, tt = map(torch.from_numpy, (q, kp, vp, table))
    tsc = {n: torch.from_numpy(x) for n, x in scales.items()}

    def rows_of(b, hk, lo, hi):
        out = []
        for pool_, sc in ((tkp, tsc.get("k_scale")),
                          (tvp, tsc.get("v_scale"))):
            r = torch.arange(lo, hi)
            page = tt[b, r // pg].long()
            x = pool_[page, r % pg, hk].float()
            if sc is not None:
                x = x * sc[page][:, None]
            out.append(x)
        return out
    got = split_emulation(tq, rows_of, kv_len, plan, D ** -0.5)
    tl = torch.from_numpy(kv_len)
    ref = paged_decode_attention_ref(tq, tkp, tvp, tt, kv_len=tl, **tsc)
    jref = jax_paged(*map(jnp.asarray, (q, kp, vp, table)),
                     kv_len=jnp.asarray(kv_len), impl="reference",
                     **{n: jnp.asarray(x) for n, x in scales.items()})
    torch.testing.assert_close(got, ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), rtol=0,
                               atol=TOL)
    # the plain gather reads through the table as the kernel does
    k_view = gather_pages(tkp, tt, tsc.get("k_scale"))
    torch.testing.assert_close(k_view[0, 1, :8].float(),
                               rows_of(0, 1, 0, 8)[0], rtol=0, atol=0)
