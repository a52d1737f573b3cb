"""The port's chunked prefill against ``repro``'s, on the same numpy
weights and tokens: ``run_prefill_chunk`` over the contiguous, windowed
and paged (copy-on-write) plans, and the serving engine's chunked
streams and counters.  Inside the port: a chunked prefill is
bitwise-equal to a whole prefill, and the scheduler keeps its bounds
(no starved tick, each prefill done within ceil(length / chunk) ticks,
pages conserved)."""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import transformer as jax_tf  # noqa: E402
from repro.runtime import executor as jax_executor  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402

from repro_torch.models import transformer  # noqa: E402
from repro_torch.runtime import executor  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

from test_torch_lm import _pair_cfgs, _params, _prefill_args  # noqa: E402

TOL = 1e-5          # f32, same math; sums in another order
MAX_LEN = 16


def _t(x):
    return torch.from_numpy(np.array(x))


def _pair(cfg, paged):
    kw = dict(paged=True, page_size=4) if paged else {}
    return transformer.compile_program_pair(cfg, slots=2, max_len=MAX_LEN,
                                            **kw)


def _states_equal(pair, a, b):
    """Bitwise equality of two states; a paged plan's null page 0 (the
    sink of masked writes) is left out."""
    assert torch.equal(a.lengths, b.lengths)
    assert a.caches.keys() == b.caches.keys()
    n = pair.paged.n_pages if pair.paged is not None else None
    for rid in a.caches:
        x, y = a.caches[rid], b.caches[rid]
        if n is not None and x.ndim == 4 and x.shape[0] == n:
            x, y = x[1:], y[1:]
        assert torch.equal(x, y), f"region {rid} diverged"


def _shared_prefill(pair, params, state, pool, donor, P):
    """Paged setup of the COW cases: the donor prefilled whole in slot
    0, the sharer (slot 1) admitted on its first two pages; returns the
    sharer's write_from."""
    pool.admit(0, P)
    executor.sync_page_table(state, pair, pool)
    padded, _ = _prefill_args(donor, MAX_LEN)
    executor.run_prefill(pair.prefill, params, _t(padded), state, 0, P)
    sharer = donor.copy()
    sharer[9:] = (sharer[9:] + 1) % 256
    shared = pool.shared_prefix_pages(0, tuple(donor), tuple(sharer))
    wf = pool.admit(1, P, shared)
    executor.sync_page_table(state, pair, pool)
    return sharer, wf


def _chunks(P, chunk, first=0):
    return [(s, min(s + chunk, P)) for s in range(first, P, chunk)]


def _clone(state):
    return executor.ProgramState({r: b.clone()
                                  for r, b in state.caches.items()},
                                 state.lengths.clone())


# --- bitwise chunk parity inside the port -----------------------------------------
# (config, overrides, paged)
PLANS = {"smollm-360m": ("smollm-360m", {}, False),
         "llama3-8b": ("llama3-8b", {}, False),
         "windowed": ("smollm-360m", {"n_layers": 2, "attn_window": 8},
                      False),
         "paged-cow": ("smollm-360m", {"n_layers": 2}, True)}


@pytest.mark.parametrize("chunk", [1, 7, None])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_chunk_prefill_is_bitwise_whole_prefill(plan, chunk):
    """run_prefill_chunk over [0, c), [c, 2c), ... equals run_prefill in
    one shot: logits at every chunk row and every persistent buffer, bit
    for bit (same flash geometry, same reduction order), for chunks
    smaller than, straddling and covering the 13-row prompt.  The
    windowed prompt outgrows its 8-row ring; the paged sharer writes
    from past its two COW-mapped donor pages."""
    name, over, paged = PLANS[plan]
    cfg, jcfg = _pair_cfgs(name, **over)
    params, _ = _params(jcfg, seed=21)
    pair = _pair(cfg, paged)
    P, slot, wf = 13, 1, 0
    prompt = np.random.default_rng(22).integers(0, 256, size=P)
    whole = executor.init_program_state(pair, "cpu")
    if paged:
        pool = executor.PagePool(pair.paged, 2)
        prompt, wf = _shared_prefill(pair, params, whole, pool, prompt, P)
        assert wf == 8
    state = _clone(whole)
    padded, _ = _prefill_args(prompt, MAX_LEN)
    ref = executor.run_prefill(pair.prefill, params, _t(padded), whole,
                               slot, P, wf)
    for start, stop in _chunks(P, chunk or P, wf):
        logits = executor.run_prefill_chunk(pair.prefill, params, _t(padded),
                                            state, [slot], [start], [stop],
                                            [P], [wf])
        assert torch.equal(logits[0, start:stop], ref[0, start:stop])
    _states_equal(pair, state, whole)


def test_chunk_batch_of_two_is_bitwise_whole_prefill():
    """Two admissions chunked in one call (B = 2), as the engine batches
    them.  The projections then see 2 x max_len rows, not max_len; torch's
    CPU matmul gives every row the same bits either way, so B = 2 is held
    bitwise too."""
    cfg, jcfg = _pair_cfgs("smollm-360m")
    params, _ = _params(jcfg, seed=23)
    pair = _pair(cfg, False)
    rng = np.random.default_rng(24)
    prompts = [rng.integers(0, 256, size=n) for n in (13, 6)]
    whole = executor.init_program_state(pair, "cpu")
    state = executor.init_program_state(pair, "cpu")
    refs = []
    for slot, prompt in enumerate(prompts):
        padded, n = _prefill_args(prompt, MAX_LEN)
        refs.append(executor.run_prefill(pair.prefill, params, _t(padded),
                                         whole, slot, n)[0])
    toks = _t(np.concatenate([_prefill_args(p, MAX_LEN)[0]
                              for p in prompts]))
    lens = [len(p) for p in prompts]
    done = [0, 0]
    while done != lens:
        stops = [min(d + 5, n) for d, n in zip(done, lens)]
        logits = executor.run_prefill_chunk(pair.prefill, params, toks,
                                            state, [0, 1], done, stops, lens)
        for i in range(2):
            rows = slice(done[i], stops[i])
            assert torch.equal(logits[i, rows], refs[i][rows])
        done = stops
    _states_equal(pair, state, whole)


# --- against repro's executor -------------------------------------------------------
@pytest.mark.parametrize("plan", ["smollm-360m", "windowed", "paged-cow"])
def test_run_prefill_chunk_matches_reference(plan):
    """The same 5-row chunks through both executors: chunk logits and,
    at the end, every persistent buffer within 1e-5 of ``repro``'s."""
    name, over, paged = PLANS[plan]
    cfg, jcfg = _pair_cfgs(name, **over)
    params, jparams = _params(jcfg, seed=25)
    pair = _pair(cfg, paged)
    kw = dict(paged=True, page_size=4) if paged else {}
    jpair = jax_tf.compile_program_pair(jcfg, slots=2, max_len=MAX_LEN, **kw)
    state = executor.init_program_state(pair, "cpu")
    jstate = jax_executor.init_program_state(jpair)
    P, slot, wf = 13, 1, 0
    prompt = np.random.default_rng(26).integers(0, 256, size=P)
    if paged:
        donor, _ = _prefill_args(prompt, MAX_LEN)
        jpool = jax_executor.PagePool(jpair.paged, 2)
        jpool.admit(0, P)
        jax_executor.sync_page_table(jstate, jpair, jpool)
        _, jstate = jax_executor.run_prefill(
            jpair.prefill, jparams, jnp.asarray(donor), jstate, 0, P,
            impl="reference")
        pool = executor.PagePool(pair.paged, 2)
        prompt, wf = _shared_prefill(pair, params, state, pool, prompt, P)
        jpool.admit(1, P, pool.slot_pages(1, wf))
        jax_executor.sync_page_table(jstate, jpair, jpool)
        np.testing.assert_array_equal(pool.table, jpool.table)
    padded, _ = _prefill_args(prompt, MAX_LEN)
    for start, stop in _chunks(P, 5, wf):
        args = ([slot], [start], [stop], [P], [wf])
        ours = executor.run_prefill_chunk(pair.prefill, params, _t(padded),
                                          state, *args)
        ref, jstate = jax_executor.run_prefill_chunk(
            jpair.prefill, jparams, jnp.asarray(padded), jstate,
            *map(jnp.asarray, args), impl="reference")
        np.testing.assert_allclose(ours[0, start:stop].numpy(),
                                   np.asarray(ref)[0, start:stop], rtol=0,
                                   atol=TOL)
    np.testing.assert_array_equal(state.lengths.numpy(),
                                  np.asarray(jstate.lengths))
    n = pair.paged.n_pages if paged else None
    for rid, buf in state.caches.items():
        ours, ref = buf.numpy(), np.asarray(jstate.caches[rid])
        if n is not None and ours.shape[0] == n:
            ours, ref = ours[1:], ref[1:]
        np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL)


# --- serving engine -----------------------------------------------------------------
def _serve(eng, req_cls, prompts, max_new, first):
    """Submit the first ``first`` prompts, step until they are all live
    (whole prefills done), then submit the rest and drain."""
    for i, p in enumerate(prompts[:first]):
        assert eng.submit(req_cls(uid=i, prompt=p,
                                  max_new_tokens=max_new)).accepted
    done = []
    while eng._prefilling or len(eng.live) + len(done) < first:
        done += eng.step()
    for i, p in enumerate(prompts[first:], start=first):
        assert eng.submit(req_cls(uid=i, prompt=p,
                                  max_new_tokens=max_new)).accepted
    done += eng.run_until_drained()
    return {r.uid: r.out_tokens for r in done}


# (overrides, slots, paged, prefix, prompt lengths, chunk, first batch)
ENGINE = {
    "dense": ({}, 3, False, 0, (3, 9, 14, 30, 5), 7, 3),
    "windowed": ({"attn_window": 8}, 3, False, 0, (3, 9, 14, 30, 5), 4, 3),
    # the donor drains first, so the later prompts COW-share its prefix
    "paged-cow": ({}, 4, True, 8, (1, 2, 3, 4), 3, 1),
    # same-tick admissions: none may share a donor still mid-prefill
    "paged-inflight": ({}, 3, True, 8, (3, 3, 3), 4, 3),
}


@pytest.mark.parametrize("case", sorted(ENGINE))
def test_engine_chunked_streams_match_reference_engine(case):
    """Chunked serving gives ``repro``'s chunked engine's streams and
    counters, and (inside the port) the streams of whole-prefill
    serving; no live slot misses a tick and the pool drains."""
    over, slots, paged, prefix, lens, chunk, first = ENGINE[case]
    cfg, jcfg = _pair_cfgs("smollm-360m", n_layers=2, **over)
    params, jparams = _params(jcfg, seed=27)
    rng = np.random.default_rng(28)
    head = rng.integers(0, cfg.vocab, size=prefix)
    prompts = [np.concatenate([head, rng.integers(0, cfg.vocab, size=n)])
               .astype(np.int32) for n in lens]
    kw = dict(slots=slots, max_len=MAX_LEN)
    if paged:
        kw.update(paged=True, page_size=4)
    ours = ServingEngine(cfg, params, device="cpu", chunk_size=chunk, **kw)
    ref = JaxEngine(jcfg, jparams, use_program=True, impl="reference",
                    chunk_size=chunk, **kw)
    whole = ServingEngine(cfg, params, device="cpu", **kw)
    got = _serve(ours, Request, prompts, 6, first)
    assert got == _serve(ref, JaxRequest, prompts, 6, first)
    assert got == _serve(whole, Request, prompts, 6, first)
    for name in ("n_prefills", "n_decode_ticks", "n_prefill_chunks",
                 "n_starved_ticks", "n_shared_pages", "n_cow_forks"):
        assert getattr(ours, name) == getattr(ref, name), name
    assert ours.n_starved_ticks == 0 and ours.n_prefill_chunks > 0
    assert ours.n_prefill_recomputes == 0
    if paged:
        assert ours._pool.used_pages == 0
        assert (ours.n_shared_pages > 0) == (case == "paged-cow")
        assert whole.n_shared_pages > 0
    else:
        _states_equal(ours.program, ours.state, whole.state)


def test_engine_refuses_chunks_over_int8_pages():
    cfg, jcfg = _pair_cfgs("smollm-360m", n_layers=1)
    params, jparams = _params(jcfg, seed=29)
    kw = dict(slots=2, max_len=MAX_LEN, paged=True, page_size=4,
              kv_quant="int8", chunk_size=4)
    with pytest.raises(ValueError, match="not chunkable: int8 paged KV"):
        ServingEngine(cfg, params, device="cpu", **kw)
    with pytest.raises(ValueError, match="not chunkable: int8 paged KV"):
        JaxEngine(jcfg, jparams, use_program=True, impl="reference", **kw)
    with pytest.raises(ValueError, match="chunk_size must be >= 1"):
        ServingEngine(cfg, params, device="cpu", slots=2, max_len=MAX_LEN,
                      chunk_size=0)


@pytest.mark.parametrize("chunk,arrivals,gap,paged", [
    (1, (5, 12, 3), 0, False), (3, (12, 1, 7, 16, 4), 1, False),
    (5, (9, 9, 2, 11), 2, False), (2, (4, 6, 8, 3, 5), 1, True),
    (4, (10, 1, 13, 6), 0, True)])
def test_chunked_schedule_invariants(chunk, arrivals, gap, paged):
    """Observed every tick: a chunked prefill finishes within
    ceil(length / chunk) ticks of its slot assignment, no slot is both
    live and mid-prefill, no request holds two slots, live slots always
    advance, every request gets its full budget and a paged pool ends
    empty (refcounts 0, every page free, the table clean)."""
    cfg, jcfg = _pair_cfgs("smollm-360m", n_layers=1)
    params, _ = _params(jcfg, seed=30)
    kw = dict(paged=True, page_size=4) if paged else {}
    eng = ServingEngine(cfg, params, slots=3, max_len=MAX_LEN, device="cpu",
                        chunk_size=chunk, **kw)
    rng = np.random.default_rng(chunk * 101 + len(arrivals))
    head = rng.integers(0, cfg.vocab, size=8 if paged else 0)
    pending = [(i * gap, Request(uid=i, prompt=np.concatenate(
        [head, rng.integers(0, cfg.vocab, size=n)]).astype(np.int32),
        max_new_tokens=3)) for i, n in enumerate(arrivals)]
    done, tenure, step = [], {}, 0
    while pending or eng.live or eng._prefilling or eng.admission:
        for _, r in [p for p in pending if p[0] <= step]:
            assert eng.submit(r).accepted
        pending = [p for p in pending if p[0] > step]
        done += eng.step()
        step += 1
        assert step < 200, "scheduler wedged"
        live, pref = set(eng.live), set(eng._prefilling)
        assert not live & pref
        uids = [r.uid for r in eng.live.values()]
        uids += [p.req.uid for p in eng._prefilling.values()]
        assert len(uids) == len(set(uids))
        for slot, p in eng._prefilling.items():
            key = (slot, p.req.uid)
            tenure[key] = tenure.get(key, 0) + 1
            assert tenure[key] < math.ceil(p.length / chunk)
            assert eng.n_decode_ticks - p.admitted_tick <= tenure[key]
    assert eng.n_starved_ticks == 0
    assert sorted(r.uid for r in done) == list(range(len(arrivals)))
    assert all(len(r.out_tokens) == 3 for r in done)
    if paged:
        pool = eng._pool
        assert pool.used_pages == 0 and not pool.refcount.any()
        assert sorted(pool.free) == list(range(1, pool.plan.n_pages))
        assert not pool.table.any()


def test_serve_cli_chunked_paged_long_prompt_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    res = serve.main(["--arch", "smollm-360m", "--smoke", "--device", "cpu",
                      "--slots", "2", "--requests", "3", "--max-new", "3",
                      "--max-len", "32", "--prompt-len", "2-6", "--paged",
                      "--page-size", "8", "--shared-prefix", "16",
                      "--chunk-size", "8", "--long-prompt", "30"])
    out = capsys.readouterr().out
    eng = res["engine"]
    assert "served 4 requests, 12 tokens in" in out
    assert (f"prefill_chunks={eng.n_prefill_chunks} starved_ticks=0"
            in out)
    assert eng.n_prefill_chunks >= 4 + 3 and eng.n_prefills == 4
    assert len(res["prompts"][3]) == 30 and eng._pool.used_pages == 0
