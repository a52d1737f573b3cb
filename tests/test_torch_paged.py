"""The port's paged KV plan against ``repro``'s, on the same numpy inputs:
the int8 page functions, ``gather_pages`` and ``paged_decode_attention``
(float and int8 pools, shuffled and shared page ids, a wrapped ring),
the paged Program pair's listings and region plans, the host
``PagePool``, paged prefill + decode with a copy-on-write fork, and the
serving engine's paged, int8, shared-prefix and pool-exhaustion streams
with their counters.  Inside the port: paged logits equal the contiguous
plan's."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import quant as jax_quant  # noqa: E402
from repro.core.regions import paged_kv_specs as jax_paged_kv_specs  # noqa: E402,E501
from repro.kernels.decode_attention import ops as jax_da_ops  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.runtime import executor as jax_executor  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402

from repro_torch.core import quant  # noqa: E402
from repro_torch.core.regions import paged_kv_specs  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    gather_pages, paged_decode_attention)
from repro_torch.models import transformer  # noqa: E402
from repro_torch.runtime import executor  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

from test_torch_compiler import _plain  # noqa: E402
from test_torch_lm import _pair_cfgs, _params, _prefill_args  # noqa: E402

TOL = 1e-5          # f32, same math; sums in another order


def _t(x):
    return torch.from_numpy(np.array(x))


# --- int8 page functions ----------------------------------------------------------
def _page_batch(seed, shape=(6, 8, 2, 16)):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[2] = 0.0                           # an untouched (zero) page
    x[4] *= 40.0                         # a page of large magnitude
    return x


def _equal_scales(ours, ref):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-7,
                               atol=0)


def test_int8_quantize_and_dequantize_pages_match_reference():
    x = _page_batch(0)
    q, sc = quant.int8_quantize_pages(_t(x))
    jq, jsc = jax_quant.int8_quantize_pages(jnp.asarray(x))
    assert q.dtype == torch.int8 and sc.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    _equal_scales(sc, jsc)
    assert float(sc[2]) == 1.0
    back = quant.int8_dequantize_pages(q, sc)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jax_quant.int8_dequantize_pages(jq, jsc)),
        rtol=1e-7, atol=0)
    bf = quant.int8_quantize_pages(_t(x).to(torch.bfloat16))
    jbf = jax_quant.int8_quantize_pages(jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_array_equal(bf[0].numpy(), np.asarray(jbf[0]))
    _equal_scales(bf[1], jbf[1])


@pytest.mark.parametrize("grow", [1.0, 2.0, 3.7])
def test_int8_requantize_page_matches_reference(grow):
    """Unchanged scale is exact; a grown scale rounds like the
    reference's (half to even, after the divide)."""
    x = _page_batch(1)
    q, sc = quant.int8_quantize_pages(_t(x))
    new = sc * grow
    ours = quant.int8_requantize_page(q, sc, new)
    ref = jax_quant.int8_requantize_page(jnp.asarray(q.numpy()),
                                         jnp.asarray(sc.numpy()),
                                         jnp.asarray(new.numpy()))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    if grow == 1.0:
        assert torch.equal(ours, q)
    # the executor's broadcast form, (n, 1, 1, 1) scales
    col = (-1, 1, 1, 1)
    assert torch.equal(quant.int8_requantize_page(
        q, sc.reshape(col), new.reshape(col)), ours)


def test_int8_per_channel_matches_reference():
    w = np.random.default_rng(2).standard_normal((32, 16)).astype(np.float32)
    w[:, 3] = 0.0
    for axis in (0, 1):
        q, sc = quant.int8_quantize_per_channel(_t(w), axis=axis)
        jq, jsc = jax_quant.int8_quantize_per_channel(jnp.asarray(w),
                                                      axis=axis)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        _equal_scales(sc, jsc)


# --- paged decode attention -------------------------------------------------------
# (B, Hq, Hkv, D, page_size, pages_per_slot, n_pages, kv_len, table rows)
# Tables: shuffled ids, a page shared by two sequences, a full (wrapped)
# ring; entries past kv_len may be the null page 0.
PAGED = {
    "shuffled": (2, 4, 2, 16, 4, 4, 9, [13, 7],
                 [[5, 2, 8, 1], [3, 6, 0, 0]]),
    "shared-wrapped": (3, 6, 2, 16, 4, 4, 10, [16, 1, 9],
                       [[4, 9, 2, 7], [4, 0, 0, 0], [4, 9, 3, 0]]),
    "gqa3-page8": (2, 15, 5, 64, 8, 4, 7, [32, 17],
                   [[6, 1, 5, 2], [3, 4, 1, 0]]),
}


def _paged_inputs(case, seed):
    B, Hq, Hkv, D, pg, pps, n_pages, lens, table = PAGED[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((n_pages, pg, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages, pg, Hkv, D)).astype(np.float32)
    return (q, kp, vp, np.asarray(table, np.int32),
            np.asarray(lens, np.int32))


@pytest.mark.parametrize("pools", ["float", "int8"])
@pytest.mark.parametrize("case", sorted(PAGED))
def test_paged_decode_attention_matches_reference(case, pools):
    """Against ``repro``'s ``impl="reference"`` path (gather_pages +
    decode_attention_ref) -- its Pallas kernel does not run on this
    JAX."""
    q, kp, vp, table, lens = _paged_inputs(case, seed=len(case))
    ks = vs = None
    if pools == "int8":
        (kp, ks), (vp, vs) = (map(np.asarray, jax_quant.int8_quantize_pages(
            jnp.asarray(p))) for p in (kp, vp))
    D = q.shape[-1]
    ref = jax_da_ops.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        kv_len=jnp.asarray(lens), scale=D ** -0.5,
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs), impl="reference")
    out = paged_decode_attention(
        _t(q), _t(kp), _t(vp), _t(table), kv_len=_t(lens),
        k_scale=None if ks is None else _t(ks),
        v_scale=None if vs is None else _t(vs))
    assert out.shape == q.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL)
    view = gather_pages(_t(kp), _t(table), None if ks is None else _t(ks))
    jview = jax_da_ops.gather_pages(jnp.asarray(kp), jnp.asarray(table),
                                    None if ks is None else jnp.asarray(ks))
    np.testing.assert_array_equal(view.numpy(), np.asarray(jview))


def test_paged_decode_cuda_impl_on_cpu_raises():
    q, kp, vp, table, lens = _paged_inputs("shuffled", seed=0)
    with pytest.raises(RuntimeError, match="impl='cuda' needs CUDA"):
        paged_decode_attention(_t(q), _t(kp), _t(vp), _t(table),
                               kv_len=_t(lens), impl="cuda")


# --- compiler: the paged Program pair --------------------------------------------
PAIRS = {"smollm-360m-full": ("smollm-360m:full", 8, 512, 16),
         "smollm-360m-smoke": ("smollm-360m", 2, 16, 4),
         "llama3-8b-smoke": ("llama3-8b", 2, 16, 4),
         "olmo-1b-smoke": ("olmo-1b", 2, 16, 8)}


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["float", "int8"])
@pytest.mark.parametrize("case", sorted(PAIRS))
def test_paged_program_pair_listing_and_plans_match_reference(case,
                                                              kv_quant):
    name, slots, max_len, pg = PAIRS[case]
    cfg, jcfg = _pair_cfgs(name)
    kw = dict(slots=slots, max_len=max_len, paged=True, page_size=pg,
              kv_quant=kv_quant)
    ours = transformer.compile_program_pair(cfg, **kw)
    ref = jax_tf.compile_program_pair(jcfg, **kw)
    assert ours.listing() == ref.listing()
    for prog, jprog in ((ours.prefill, ref.prefill),
                        (ours.decode, ref.decode)):
        assert _plain(prog.plan) == _plain(jprog.plan)
        assert [_plain(op) for op in prog.ops] == [_plain(op)
                                                   for op in jprog.ops]
    assert _plain(ours.paged) == _plain(ref.paged)
    assert ours.page_table_region == ref.page_table_region
    assert ours.chunk_blocker == ref.chunk_blocker
    assert (ours.chunk_blocker is not None) == (kv_quant == "int8")
    if case == "smollm-360m-full":      # 32 pages/slot, 257 pages/pool
        assert (ours.paged.pages_per_slot, ours.paged.n_pages) == (32, 257)


def test_paged_pair_refuses_a_window_and_pool_validation_matches():
    cfg, jcfg = _pair_cfgs("smollm-360m", attn_window=8)
    with pytest.raises(NotImplementedError, match="mutually exclusive"):
        transformer.compile_program_pair(cfg, paged=True, page_size=4,
                                         max_len=16)
    for kw in (dict(max_len=30, page_size=8), dict(max_len=16, page_size=8,
                                                   n_pages=2)):
        with pytest.raises(ValueError):
            paged_kv_specs(n_layers=1, kv_heads=1, head_dim=4, slots=2, **kw)
        with pytest.raises(ValueError):
            jax_paged_kv_specs(n_layers=1, kv_heads=1, head_dim=4, slots=2,
                               **kw)


# --- the host PagePool ------------------------------------------------------------
def _pools(slots, max_len, page_size, n_pages=None):
    kw = dict(n_layers=1, kv_heads=1, head_dim=4, slots=slots,
              max_len=max_len, page_size=page_size, n_pages=n_pages)
    _, plan = paged_kv_specs(**kw)
    _, jplan = jax_paged_kv_specs(**kw)
    return executor.PagePool(plan, slots), jax_executor.PagePool(jplan, slots)


def _same_pool(a, b):
    np.testing.assert_array_equal(a.table, b.table)
    np.testing.assert_array_equal(a.refcount, b.refcount)
    assert a.free == b.free and a.dirty == b.dirty
    assert (a.used_pages, a.free_pages) == (b.used_pages, b.free_pages)


def test_page_pool_call_sequence_matches_reference():
    """Admission, prefix sharing, on-demand pages, COW forks, release
    and exhaustion, step by step on both pools."""
    pools = _pools(slots=3, max_len=16, page_size=4, n_pages=10)
    donor, other = tuple(range(10)), tuple(range(9)) + (99,)
    outs = []
    for pool in pools:
        out = [pool.admit(0, len(donor))]
        shared = pool.shared_prefix_pages(0, donor, other)
        out += [shared, pool.admit(1, len(other), shared)]
        out += [pool.prepare_decode(0, 10), pool.prepare_decode(1, 12),
                pool.prepare_decode(1, 16)]          # ring wrap: COW fork
        out += [pool.can_admit(16), pool.can_admit(16, 2)]
        pool.release(0)
        out += [pool.slot_pages(1, 16), pool.admit(2, 13, shared[1:])]
        out += [pool.can_admit(16)]
        with pytest.raises(RuntimeError, match="page pool exhausted"):
            pool.admit(0, 16)
        outs.append(out)
    assert outs[0] == outs[1]
    assert outs[0][5] is not None           # the wrap forked a shared page
    _same_pool(*pools)


# --- paged prefill + decode through the executor ---------------------------------
def _paged_setup(cfg, jcfg, slots, max_len, pg, kv_quant=None):
    kw = dict(slots=slots, max_len=max_len, paged=True, page_size=pg,
              kv_quant=kv_quant)
    pair = transformer.compile_program_pair(cfg, **kw)
    jpair = jax_tf.compile_program_pair(jcfg, **kw)
    return (pair, executor.init_program_state(pair, "cpu"),
            executor.PagePool(pair.paged, slots), jpair,
            jax_executor.init_program_state(jpair),
            jax_executor.PagePool(jpair.paged, slots))


def _assert_pools_close(pair, state, jstate):
    """Every persistent buffer against the reference's, the null page 0
    (the sink of masked writes, its content don't-care) left out: int8
    pools and tables equal, float pools and scales within 1e-5."""
    assert sorted(state.caches) == sorted(jstate.caches)
    n = pair.paged.n_pages
    for rid, buf in state.caches.items():
        ours, ref = buf.numpy(), np.asarray(jstate.caches[rid])
        if ours.shape[0] == n:
            ours, ref = ours[1:], ref[1:]
        if ours.dtype in (np.int8, np.int32):
            np.testing.assert_array_equal(ours, ref)
        else:
            np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["float", "int8"])
def test_paged_prefill_and_decode_with_cow_fork_match_reference(kv_quant):
    """A donor and a sharer of its first two pages (page_size 4, 9
    common rows), then 14 decode ticks: across page boundaries, past
    max_len 16 (the ring wraps through the table onto the shared pages,
    which fork).  Logits within 1e-5 of ``repro``'s executor at every
    step; pools, scales and tables against its state at the end."""
    cfg, jcfg = _pair_cfgs("smollm-360m", n_layers=2)
    params, jparams = _params(jcfg, seed=11)
    slots, max_len, pg = 2, 16, 4
    pair, state, pool, jpair, jstate, jpool = _paged_setup(
        cfg, jcfg, slots, max_len, pg, kv_quant)
    rng = np.random.default_rng(12)
    base = rng.integers(0, cfg.vocab, size=9).astype(np.int32)
    prompts = [np.append(base, [7, 3]).astype(np.int32),
               np.append(base, 11).astype(np.int32)]
    last, lens = np.zeros((slots,), np.int32), []
    for slot, prompt in enumerate(prompts):
        shared = (pool.shared_prefix_pages(0, tuple(prompts[0]),
                                           tuple(prompt)) if slot else ())
        wf = pool.admit(slot, len(prompt), shared)
        assert jpool.admit(slot, len(prompt), shared) == wf
        executor.sync_page_table(state, pair, pool)
        jax_executor.sync_page_table(jstate, jpair, jpool)
        padded, length = _prefill_args(prompt, max_len)
        ours = executor.run_prefill(pair.prefill, params, _t(padded), state,
                                    slot, length, wf)
        ref, jstate = jax_executor.run_prefill(
            jpair.prefill, jparams, jnp.asarray(padded), jstate, slot,
            length, wf, impl="reference")
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                                   atol=TOL)
        last[slot] = int(np.argmax(np.asarray(ref)[0, length - 1]))
        lens.append(length)
    assert wf == 8 and pool.refcount[shared[0]] == 2
    forks = 0
    for _ in range(14):
        copies = [c for s in range(slots)
                  if (c := pool.prepare_decode(s, lens[s])) is not None]
        jcopies = [c for s in range(slots)
                   if (c := jpool.prepare_decode(s, lens[s])) is not None]
        assert copies == jcopies
        forks += len(copies)
        for st, p, pl, ex in ((state, pair, pool, executor),
                              (jstate, jpair, jpool, jax_executor)):
            ex.sync_page_table(st, p, pl)
            ex.apply_page_copies(st, p, copies)
        ours = executor.run_decode(pair.decode, params, _t(last), state)
        ref, jstate = jax_executor.run_decode(
            jpair.decode, jparams, jnp.asarray(last), jstate,
            impl="reference")
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                                   atol=TOL)
        last = np.argmax(np.asarray(ref), axis=-1).astype(np.int32)
        lens = [n + 1 for n in lens]
    assert forks > 0 and min(lens) > max_len
    _same_pool(pool, jpool)
    np.testing.assert_array_equal(state.lengths.numpy(),
                                  np.asarray(jstate.lengths))
    _assert_pools_close(pair, state, jstate)


def test_paged_logits_equal_the_contiguous_plans():
    """Inside the port: the same prompts and 14 ticks (a page boundary,
    the wrap past max_len) give the paged plan the contiguous plan's
    logits."""
    cfg, jcfg = _pair_cfgs("smollm-360m", n_layers=2)
    params, _ = _params(jcfg, seed=13)
    slots, max_len = 2, 16
    cpair = transformer.compile_program_pair(cfg, slots=slots,
                                             max_len=max_len)
    ppair = transformer.compile_program_pair(cfg, slots=slots,
                                             max_len=max_len, paged=True,
                                             page_size=4)
    cstate = executor.init_program_state(cpair, "cpu")
    pstate = executor.init_program_state(ppair, "cpu")
    pool = executor.PagePool(ppair.paged, slots)
    prompts = np.random.default_rng(14).integers(0, cfg.vocab, size=(2, 5))
    for slot in range(slots):
        padded, n = _prefill_args(prompts[slot], max_len)
        pool.admit(slot, n)
        executor.sync_page_table(pstate, ppair, pool)
        a = executor.run_prefill(cpair.prefill, params, _t(padded), cstate,
                                 slot, n)
        b = executor.run_prefill(ppair.prefill, params, _t(padded), pstate,
                                 slot, n)
        torch.testing.assert_close(b, a, rtol=0, atol=TOL)
    toks, lens = _t(prompts[:, -1].astype(np.int32)), [5, 5]
    for _ in range(14):
        for s in range(slots):
            assert pool.prepare_decode(s, lens[s]) is None
        executor.sync_page_table(pstate, ppair, pool)
        a = executor.run_decode(cpair.decode, params, toks, cstate)
        b = executor.run_decode(ppair.decode, params, toks, pstate)
        torch.testing.assert_close(b, a, rtol=0, atol=TOL)
        toks = a.argmax(-1).to(torch.int32)
        lens = [n + 1 for n in lens]


# --- serving engine ----------------------------------------------------------------
def _serve(eng, req_cls, prompts, max_new, late_after=None):
    """Submit ``prompts`` (the ones past ``late_after`` two ticks in)
    and drain; returns the streams by uid."""
    cut = len(prompts) if late_after is None else late_after
    for i, p in enumerate(prompts[:cut]):
        assert eng.submit(req_cls(uid=i, prompt=p,
                                  max_new_tokens=max_new)).accepted
    done = []
    if late_after is not None:
        done += eng.step() + eng.step()
        for i, p in enumerate(prompts[cut:], start=cut):
            eng.submit(req_cls(uid=i, prompt=p, max_new_tokens=max_new))
    done += eng.run_until_drained()
    return {r.uid: r.out_tokens for r in done}


# (slots, max_len, page_size, page_pool, kv_quant, prefix, tails, max_new)
ENGINE = {
    "paged": (2, 32, 8, None, None, 16, (1, 2, 3, 1), 6),
    "int8": (2, 32, 8, None, "int8", 16, (1, 2, 3, 1), 6),
    # prompts that reach max_len: the rings wrap onto shared pages (forks)
    "shared-wrap": (3, 16, 4, None, None, 9, (3, 6, 5, 7), 8),
    # 5 usable pages for 4 slots of 2 pages: requests wait at the head
    "exhaustion": (4, 16, 8, 6, None, 0, (12, 12, 12, 12), 4),
}


@pytest.mark.parametrize("case", sorted(ENGINE))
def test_engine_paged_streams_and_counters_match_reference(case):
    slots, max_len, pg, pool_pages, kv_quant, prefix, tails, max_new = \
        ENGINE[case]
    cfg, jcfg = _pair_cfgs("smollm-360m", n_layers=2)
    params, jparams = _params(jcfg, seed=15)
    rng = np.random.default_rng(16)
    head = rng.integers(0, cfg.vocab, size=prefix).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(0, cfg.vocab, size=n)])
               .astype(np.int32) for n in tails]
    kw = dict(slots=slots, max_len=max_len, paged=True, page_size=pg,
              page_pool=pool_pages, kv_quant=kv_quant)
    ours = ServingEngine(cfg, params, device="cpu", **kw)
    ref = JaxEngine(jcfg, jparams, use_program=True, impl="reference", **kw)
    late = 1 if case == "shared-wrap" else None
    got = _serve(ours, Request, prompts, max_new, late)
    want = _serve(ref, JaxRequest, prompts, max_new, late)
    assert got == want and sorted(got) == list(range(len(prompts)))
    assert all(len(t) == max_new for t in got.values())
    for name in ("n_prefills", "n_decode_ticks", "n_shared_pages",
                 "n_cow_forks", "n_prefill_recomputes"):
        assert getattr(ours, name) == getattr(ref, name), name
    assert (ours.admission.n_requeued, dict(ours.admission.blocked)) == (
        ref.admission.n_requeued, dict(ref.admission.blocked))
    assert ours._pool.used_pages == 0 and not ours._prefilling
    if case == "exhaustion":
        assert ours.admission.n_requeued > 0
        assert ours.admission.blocked["pages_exhausted"] > 0
    else:
        assert ours.n_shared_pages > 0
    if case == "shared-wrap":
        assert ours.n_cow_forks > 0


def test_engine_refuses_a_pair_of_another_geometry():
    cfg, jcfg = _pair_cfgs("smollm-360m", n_layers=1)
    params, _ = _params(jcfg, seed=17)
    pair = transformer.compile_program_pair(cfg, slots=2, max_len=16,
                                            paged=True, page_size=4)
    eng = ServingEngine(cfg, params, slots=2, max_len=16, program=pair,
                        device="cpu")
    assert eng.program is pair and eng._pool is not None
    for slots, max_len in ((3, 16), (2, 32)):
        with pytest.raises(ValueError, match="compiled for slots/max_len"):
            ServingEngine(cfg, params, slots=slots, max_len=max_len,
                          program=pair, device="cpu")
    flat = transformer.compile_program_pair(cfg, slots=2, max_len=16)
    with pytest.raises(ValueError, match="compiled for slots/max_len"):
        ServingEngine(cfg, params, slots=4, max_len=16, program=flat,
                      device="cpu")


def test_serve_cli_paged_int8_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    res = serve.main(["--arch", "smollm-360m", "--smoke", "--device", "cpu",
                      "--slots", "2", "--requests", "3", "--max-new", "3",
                      "--max-len", "32", "--prompt-len", "2-6", "--paged",
                      "--page-size", "8", "--kv-quant", "int8",
                      "--shared-prefix", "16"])
    out = capsys.readouterr().out
    assert "served 3 requests, 9 tokens in" in out
    assert "prefills=3 prefill_recomputes=0" in out
    assert f"shared_pages={res['engine'].n_shared_pages} cow_forks=0" in out
    assert res["engine"].n_shared_pages > 0
    assert res["engine"].program.paged.kv_dtype == "int8"
    assert all(len(p) > 16 and np.array_equal(p[:16], res["prompts"][0][:16])
               for p in res["prompts"])
