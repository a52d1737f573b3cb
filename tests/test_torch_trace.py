"""The port's trace recorder (``executor.trace_program``, ``TraceRecord``,
``ExecutorTrace``) and sampled op timing (``OpTimingSampler``) against
``repro``'s: ``static_dict()`` of every record equal to the
reference's for the alexnet-owt Program and a smollm-360m smoke decode
Program with state; the JSONL readable by either package; repeated
timed calls leaving the state where one call leaves it (dense, zamba2
and rwkv6 smoke decodes: no cache row or recurrent state advanced
twice) and the caller's state untouched; and the sampler, in a plain
and a speculative engine, leaving the streams and the state's bytes as
an unsampled run leaves them."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import CNN_REGISTRY as JAX_CNNS  # noqa: E402
from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.models import cnn as jax_cnn  # noqa: E402
from repro.models import get_model  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.runtime import executor as jax_executor  # noqa: E402

from repro_torch.configs import CNN_REGISTRY, REGISTRY  # noqa: E402
from repro_torch.models import (cnn, param_defs, params_from_numpy,  # noqa: E402,E501
                                transformer)
from repro_torch.obs import FlightRecorder, Observability  # noqa: E402
from repro_torch.runtime import executor  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

from test_torch_cnn import _jax_tree, numpy_params  # noqa: E402

MAX_LEN = 16


def _static(trace):
    return [r.static_dict() for r in trace.records]


def _same_state(a, b):
    assert torch.equal(a.lengths, b.lengths)
    assert a.caches.keys() == b.caches.keys()
    for rid in a.caches:
        assert torch.equal(a.caches[rid], b.caches[rid]), rid


def _clone(state):
    return executor.ProgramState({r: t.clone() for r, t in
                                  state.caches.items()},
                                 state.lengths.clone())


def test_cnn_trace_records_match_reference():
    """alexnet-owt at batch 1: every record's static part equal to the
    reference's."""
    cfg, jcfg = CNN_REGISTRY["alexnet-owt"], JAX_CNNS["alexnet-owt"]
    tree = numpy_params(jax_cnn.param_defs(jcfg), seed=0)
    x = np.random.default_rng(1).standard_normal(
        (1, cfg.input_hw, cfg.input_hw, cfg.input_ch)).astype(np.float32)
    prog = cnn.compile_program(cfg, batch=1)
    ours = executor.trace_program(prog, params_from_numpy(tree),
                                  torch.from_numpy(x), impl="reference",
                                  repeats=1)
    ref = jax_executor.trace_program(
        jax_cnn.compile_program(jcfg, batch=1), _jax_tree(tree),
        jnp.asarray(x), impl="reference", measure=False)
    assert len(ours.records) == len(prog.ops) > 0
    assert _static(ours) == _static(ref)
    assert ours.state is None and ours.repeats == 1
    assert all(r.measured_time_s > 0 for r in ours.records)
    assert {r.operands["in"][1] for r in ours.records} == {"float32"}


def _decode_setup(name, seed, **over):
    """A smoke decode Program with a random state (2 of 3 slots live,
    mixed lengths), in both packages' types."""
    cfg, jcfg = REGISTRY[name].smoke(), JAX_REGISTRY[name].smoke()
    if over:
        cfg = dataclasses.replace(cfg, **over)
        jcfg = dataclasses.replace(jcfg, **over)
    tree = numpy_params(get_model(jcfg).param_defs(jcfg), seed)
    pair = transformer.compile_program_pair(cfg, slots=3, max_len=MAX_LEN)
    rng = np.random.default_rng(seed)
    state = executor.init_program_state(pair, "cpu")
    for rid, buf in state.caches.items():
        buf.copy_(torch.from_numpy(rng.standard_normal(buf.shape)
                                   .astype(np.float32) * 0.5))
    state.lengths.copy_(torch.tensor([5, 0, 9], dtype=torch.int32))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=3)
                              .astype(np.int32))
    mask = torch.tensor([True, False, True])
    return cfg, jcfg, tree, pair, state, tokens, mask


def test_decode_trace_records_match_reference():
    cfg, jcfg, tree, pair, state, tokens, mask = _decode_setup(
        "smollm-360m", 11, n_layers=2)
    ours = executor.trace_program(pair.decode, params_from_numpy(tree),
                                  tokens, impl="reference", repeats=1,
                                  state=state, mask=mask)
    jpair = jax_tf.compile_program_pair(jcfg, slots=3, max_len=MAX_LEN)
    jstate = jax_executor.ProgramState(
        {r: jnp.asarray(t.numpy()) for r, t in state.caches.items()},
        jnp.asarray(state.lengths.numpy()))
    ref = jax_executor.trace_program(
        jpair.decode, _jax_tree(tree), jnp.asarray(tokens.numpy()),
        impl="reference", measure=False, state=jstate,
        mask=jnp.asarray(mask.numpy()))
    assert _static(ours) == _static(ref)
    dec = [r for r in ours.records if r.kind == "decode_attention"]
    assert dec and dec[0].extras == {"pos": [5, 0, 9],
                                     "live": [True, False, True]}
    assert "k_cache" in dec[0].operands
    text = ours.to_jsonl()
    back = jax_executor.ExecutorTrace.from_jsonl(text)
    assert [r.to_dict() for r in back.records] == ours.record_dicts()
    again = executor.ExecutorTrace.from_jsonl(ref.to_jsonl())
    assert _static(again) == _static(ours)
    assert again.program == ours.program == pair.decode.name
    with pytest.raises(ValueError, match="state="):
        executor.trace_program(pair.decode, params_from_numpy(tree), tokens)


@pytest.mark.parametrize("name", ["smollm-360m", "zamba2-7b", "rwkv6-7b"])
def test_repeated_timed_calls_advance_the_state_once(name):
    """Three timed calls an op (four runs of each) leave the walk's state
    bitwise where one ``run_decode`` leaves it -- the cache rows written
    once, the recurrent states advanced once -- and the caller's state
    as it was; the outputs' records carry a measured time."""
    over = {"n_layers": 2} if name == "smollm-360m" else {}
    cfg, _, tree, pair, state, tokens, mask = _decode_setup(name, 13,
                                                            **over)
    params = params_from_numpy(tree)
    kept = _clone(state)
    want = _clone(state)
    executor.run_decode(pair.decode, params, tokens, want, mask)
    trace = executor.trace_program(pair.decode, params, tokens, repeats=3,
                                   state=state, mask=mask)
    _same_state(state, kept)
    _same_state(trace.state, want)
    assert trace.repeats == 3
    assert all(r.measured_time_s > 0 and r.repeats == 3
               for r in trace.records)
    written = {r.kind for r in trace.records} & {"decode_attention", "wkv",
                                                   "ssm_scan"}
    assert written


def _engine(spec_k=0, sample=0):
    cfg = dataclasses.replace(REGISTRY["smollm-360m"].smoke(), n_layers=2)
    tree = numpy_params(param_defs(cfg), 17)
    eng = ServingEngine(cfg, params_from_numpy(tree), slots=2,
                        max_len=MAX_LEN, device="cpu", spec_k=spec_k,
                        obs=Observability(sample_ops_every=sample,
                                          flight=FlightRecorder()))
    rng = np.random.default_rng(17)
    for i, n in enumerate((3, 7, 5)):
        eng.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab, size=n)
                           .astype(np.int32), max_new_tokens=6))
    done = eng.run_until_drained()
    return eng, {r.uid: r.out_tokens for r in done}


@pytest.mark.parametrize("spec_k", [0, 3])
def test_sampler_leaves_streams_and_state_bytes_unchanged(spec_k):
    """Every tick sampled (``sample_ops_every=1``), plain and speculative:
    the streams, the counters and every byte of the target's (and the
    draft's) state equal the unsampled run's; a speculative tick samples
    the draft round it runs, a plain tick the target's decode."""
    base, want = _engine(spec_k)
    eng, got = _engine(spec_k, sample=1)
    assert got == want
    assert eng._op_sampler.n_samples == eng.n_decode_ticks > 0
    assert eng.obs.registry.snapshot()["counters"] == \
        base.obs.registry.snapshot()["counters"]
    _same_state(eng.state, base.state)
    if spec_k:
        _same_state(eng._draft_state, base._draft_state)
    roles = {e["role"] for e in eng.obs.flight.events
             if e["ev"] == "op_sample"}
    assert roles == {"draft" if spec_k else "target"}
    hist = eng.obs.registry.snapshot()["histograms"]
    assert hist['op_time_us{kind="matmul"}']["count"] > 0
    assert hist['op_time_us{kind="decode_attention"}']["count"] > 0


def test_sampler_cadence_and_off():
    s = executor.OpTimingSampler(0)
    assert s.tick(None, None, None) is None and s.n_calls == 0
    with pytest.raises(ValueError, match="cadence"):
        executor.OpTimingSampler(-1)
    cfg, _, tree, pair, state, tokens, mask = _decode_setup(
        "smollm-360m", 19, n_layers=1)
    s = executor.OpTimingSampler(3, impl="reference")
    traces = [s.tick(pair.decode, params_from_numpy(tree), tokens,
                     state=state, mask=mask) for _ in range(6)]
    assert [t is not None for t in traces] == [False, False, True] * 2
    assert s.n_samples == 2 and s.n_calls == 6
