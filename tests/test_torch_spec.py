"""The port's speculative decode against ``repro``'s, on the same numpy
weights: the four speculative cases of ``tests/test_serving_loop.py``
(self-draft at k of 1, 3 and 9; a disagreeing draft; composition with
chunked prefill; the gates, with the same exception types and
messages), each holding the port's greedy streams to its own
no-speculation streams and to the reference's speculative streams, and
``n_spec_*`` to the reference's counts; the verify's chunk call writing
no tail rows; rollback writing the two states' own ``lengths`` tensors
in place; and a speculative engine through the CUDA-graph stand-in
(the draft's graphs in its own store) equal to the eager one."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402

from repro_torch.configs import CNN_REGISTRY, REGISTRY  # noqa: E402
from repro_torch.models import (param_defs, params_from_numpy,  # noqa: E402
                                transformer)
from repro_torch.runtime import executor  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

from test_torch_cnn import _jax_tree, numpy_params  # noqa: E402
from test_torch_graphs import graphs  # noqa: E402,F401


def _cfgs(name="smollm-360m", **over):
    cfg, jcfg = REGISTRY[name].smoke(), JAX_REGISTRY[name].smoke()
    if over:
        cfg = dataclasses.replace(cfg, **over)
        jcfg = dataclasses.replace(jcfg, **over)
    return cfg, jcfg


def _params(jcfg, seed):
    tree = numpy_params(jax_tf.param_defs(jcfg), seed)
    return params_from_numpy(tree), _jax_tree(tree)


def _serve(cfg, jcfg, params, jparams, prompts, max_new, **kw):
    """Port with the options, port without speculation, and the
    reference with them: (streams, engine) each."""
    def run(eng, req_cls):
        for i, p in enumerate(prompts):
            n = max_new[i] if isinstance(max_new, tuple) else max_new
            assert eng.submit(req_cls(uid=i, prompt=p,
                                      max_new_tokens=n)).accepted
        return {r.uid: tuple(r.out_tokens) for r in eng.run_until_drained()}
    jkw = dict(kw)
    if "draft_params" in kw:
        jkw["draft_cfg"], jkw["draft_params"] = kw["draft_params"][1]
        kw["draft_cfg"], kw["draft_params"] = kw["draft_params"][0]
    ours = ServingEngine(cfg, params, slots=2, max_len=32, device="cpu",
                         **kw)
    plain_kw = {k: v for k, v in kw.items()
                if k not in ("spec_k", "draft_cfg", "draft_params")}
    plain = ServingEngine(cfg, params, slots=2, max_len=32, device="cpu",
                          **plain_kw)
    ref = JaxEngine(jcfg, jparams, slots=2, max_len=32, use_program=True,
                    impl="reference", **jkw)
    return ((run(ours, Request), ours), (run(plain, Request), plain),
            (run(ref, JaxRequest), ref))


def _same_spec_counts(ours, ref):
    assert (ours.n_spec_proposed, ours.n_spec_accepted,
            ours.n_spec_rollbacks) == (ref.n_spec_proposed,
                                       ref.n_spec_accepted,
                                       ref.n_spec_rollbacks)
    assert ours.n_decode_ticks == ref.n_decode_ticks
    assert ours.n_starved_ticks == ref.n_starved_ticks == 0


@pytest.mark.parametrize("k", [1, 3, 9])
def test_spec_decode_token_identical(k):
    """Self-draft speculation: the streams equal speculation off and the
    reference's, for k of 1, a mid burst, and a k past both the
    remaining budget and a request's whole stream."""
    cfg, jcfg = _cfgs(n_layers=2)
    params, jparams = _params(jcfg, seed=19)
    rng = np.random.default_rng(19)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in (4, 9)]
    (got, ours), (base, _), (want, ref) = _serve(
        cfg, jcfg, params, jparams, prompts, (10, 3), spec_k=k)
    assert got == base == want
    _same_spec_counts(ours, ref)
    assert ours.n_spec_proposed > 0 and ours.n_spec_accepted > 0


def test_spec_decode_disagreeing_draft_rolls_back():
    """A draft of the same arch with other weights disagrees: rollbacks
    fire, the streams stay the greedy ones."""
    cfg, jcfg = _cfgs(n_layers=2)
    params, jparams = _params(jcfg, seed=21)
    draft = _params(jcfg, seed=9)
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in (5, 7)]
    (got, ours), (base, _), (want, ref) = _serve(
        cfg, jcfg, params, jparams, prompts, 8, spec_k=4,
        draft_params=((cfg, draft[0]), (jcfg, draft[1])))
    assert got == base == want
    _same_spec_counts(ours, ref)
    assert ours.n_spec_rollbacks > 0
    assert ours.n_spec_proposed >= ours.n_spec_accepted


def test_spec_decode_composes_with_chunked_prefill():
    cfg, jcfg = _cfgs(n_layers=2)
    params, jparams = _params(jcfg, seed=29)
    rng = np.random.default_rng(29)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in (11, 3, 6)]
    (got, ours), (base, _), (want, ref) = _serve(
        cfg, jcfg, params, jparams, prompts, 6, chunk_size=4, spec_k=3)
    assert got == base == want
    _same_spec_counts(ours, ref)
    assert ours.n_prefill_chunks == ref.n_prefill_chunks > 0
    assert ours.n_spec_proposed > 0


def test_spec_decode_near_max_len_matches_reference():
    """Bursts cut at max_len, then the wrapped slots' plain decode
    steps: long prompts and budgets that run past the compiled
    max_len."""
    cfg, jcfg = _cfgs(n_layers=2)
    params, jparams = _params(jcfg, seed=33)
    rng = np.random.default_rng(33)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in (26, 29, 12)]
    (got, ours), (base, _), (want, ref) = _serve(
        cfg, jcfg, params, jparams, prompts, 12, spec_k=4)
    assert got == base == want
    _same_spec_counts(ours, ref)


def _gate_cases(cfg, params):
    """(exception, message, engine options) of every construction gate."""
    return [
        (NotImplementedError, "paged", dict(paged=True, page_size=4,
                                            spec_k=2)),
        (ValueError, "greedy", dict(greedy=False, spec_k=2)),
        (ValueError, "draft_params",
         dict(spec_k=2, draft_cfg=dataclasses.replace(cfg, n_layers=2))),
        (ValueError, "int8", dict(paged=True, page_size=4,
                                  kv_quant="int8", chunk_size=4)),
    ]


def test_spec_decode_gates():
    """Unsupported speculation fails at construction in both packages
    with the same exception type and message: paged KV, sampling, a
    separate draft without weights, int8 pages under chunking; the draft
    pair's vocab, window and family gates; a non-dense target; a CNN."""
    cfg, jcfg = _cfgs(n_layers=1)
    params, jparams = _params(jcfg, seed=3)
    for (exc, msg, kw), (_, _, jkw) in zip(_gate_cases(cfg, params),
                                          _gate_cases(jcfg, jparams)):
        with pytest.raises(exc, match=msg) as ours:
            ServingEngine(cfg, params, slots=2, max_len=16, device="cpu",
                          **kw)
        with pytest.raises(exc, match=msg) as ref:
            JaxEngine(jcfg, jparams, slots=2, max_len=16, use_program=True,
                      impl="reference", **jkw)
        assert str(ours.value) == str(ref.value)
    for make, exc, msg in (
            (lambda tf, c: dataclasses.replace(c, vocab=c.vocab * 2),
             ValueError, "vocab"),
            (lambda tf, c: None, NotImplementedError, "windowed")):
        for tf, c in ((transformer, cfg), (jax_tf, jcfg)):
            target, draft = ((dataclasses.replace(c, attn_window=8), c)
                             if msg == "windowed" else (c, make(tf, c)))
            with pytest.raises(exc, match=msg):
                tf.compile_draft_pair(target, draft, slots=2, max_len=16)
    mcfg, mjcfg = _cfgs("granite-moe-1b-a400m")      # family "moe"
    for tf, c, d in ((transformer, mcfg, cfg), (jax_tf, mjcfg, jcfg)):
        with pytest.raises(NotImplementedError, match="speculatable"):
            tf.compile_draft_pair(c, dataclasses.replace(d, vocab=c.vocab),
                                  slots=2, max_len=16)
    mparams = params_from_numpy(numpy_params(param_defs(mcfg), 5))
    with pytest.raises(NotImplementedError, match="speculatable"):
        ServingEngine(mcfg, mparams, slots=2, max_len=16, device="cpu",
                      spec_k=2)
    with pytest.raises(ValueError, match="stateful LM Program path"):
        ServingEngine(CNN_REGISTRY["alexnet-owt"], {}, device="cpu",
                      spec_k=2)
    with pytest.raises(ValueError, match="spec_k must be >= 1"):
        ServingEngine(cfg, params, slots=2, max_len=16, device="cpu",
                      spec_k=-1)


def test_verify_chunk_call_writes_no_tail_rows():
    """The verify's chunk call (the whole (B, max_len) buffer, length
    pinned at max_len + 1) writes rows [start, stop) of each slot and
    nothing past them: the last chunk's tail write never fires."""
    cfg, jcfg = _cfgs(n_layers=2)
    params, _ = _params(jcfg, seed=5)
    pair = transformer.compile_program_pair(cfg, slots=3, max_len=16)
    state = executor.init_program_state(pair, "cpu")
    for buf in state.caches.values():
        buf.normal_()
    before = {r: t.clone() for r, t in state.caches.items()}
    slots, starts, stops = [2, 0], np.array([5, 9]), np.array([8, 10])
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(2, 16)).astype(np.int32))
    executor.run_prefill_chunk(pair.prefill, params, tokens, state, slots,
                               starts, stops, np.full(2, 17), np.zeros(2))
    rows = torch.arange(16)
    for rid, buf in state.caches.items():
        for s, a, b in zip(slots, starts, stops):
            kept = (rows < a) | (rows >= b)
            assert torch.equal(buf[s][kept], before[rid][s][kept]), rid
            assert not torch.equal(buf[s][a:b], before[rid][s][a:b])
        assert torch.equal(buf[1], before[rid][1])
    assert state.lengths.tolist() == [10, 0, 8]


def test_rollback_writes_both_lengths_in_place(graphs):
    """Through the CUDA-graph stand-in: the speculative engine's streams
    equal the eager engine's and the reference's; the target's and the
    draft's ``lengths`` keep their tensors (captured graphs read them)
    and never share storage; the self-draft's graphs live in the draft
    state's own store, apart from the target's."""
    cfg, jcfg = _cfgs(n_layers=2)
    params, jparams = _params(jcfg, seed=37)
    rng = np.random.default_rng(37)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in (5, 9, 3)]
    kw = dict(slots=2, max_len=16, spec_k=3)

    def serve(eng, req_cls):
        for i, p in enumerate(prompts):
            eng.submit(req_cls(uid=i, prompt=p, max_new_tokens=6))
        return {r.uid: r.out_tokens for r in eng.run_until_drained()}
    eng = ServingEngine(cfg, params, device="cpu", **kw)
    ptrs = (eng.state.lengths.data_ptr(), eng._draft_state.lengths.data_ptr())
    assert ptrs[0] != ptrs[1]
    got = serve(eng, Request)
    assert (eng.state.lengths.data_ptr(),
            eng._draft_state.lengths.data_ptr()) == ptrs
    assert torch.equal(eng.state.lengths, eng._draft_state.lengths)
    with executor.disable_graphs():
        assert got == serve(ServingEngine(cfg, params, device="cpu", **kw),
                            Request)
    assert got == serve(JaxEngine(jcfg, jparams, use_program=True,
                                  impl="reference", **kw), JaxRequest)
    assert eng._draft_pair is eng.program        # self-draft: one pair
    target = {k for k, g in eng.state.graphs.graphs.items() if g is not None}
    draft = {k for k, g in eng._draft_state.graphs.graphs.items()
             if g is not None}
    assert any(k[2] == "decode" for k in draft)
    assert any(k[2] == "chunk" for k in target)
    assert eng.capture_seconds == (eng.state.graphs.capture_seconds
                                   + eng._draft_state.graphs.capture_seconds)
