"""The port's dense-LM slice against ``repro``'s, on the same numpy
weights and tokens: configs and parameter trees, the (prefill, decode)
Program pair's listings and region plans, the norms and rotary
embedding, the stateless Program forward, prefill + decode logits and
caches (past max_len, windowed ring, dead slots), the serving engine's
token streams, and the serve CLI on the CPU."""
import dataclasses
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.runtime import executor as jax_executor  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402

from repro_torch.configs import REGISTRY, get_config  # noqa: E402
from repro_torch.models import common, params_from_numpy  # noqa: E402
from repro_torch.models import transformer, tree_paths  # noqa: E402
from repro_torch.runtime import executor  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

from test_torch_cnn import _jax_tree, numpy_params  # noqa: E402
from test_torch_compiler import _plain  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5          # f32, same math; sums in another order
DENSE = ["smollm-360m", "llama3-8b", "olmo-1b", "deepseek-7b"]
SMOKE = ["smollm-360m", "llama3-8b", "olmo-1b"]


def _pair_cfgs(name, **over):
    """The same config in both packages' types, smoke-sized unless
    ``name`` ends in ``:full``."""
    base, _, size = name.partition(":")
    cfg, jcfg = REGISTRY[base], JAX_REGISTRY[base]
    if size != "full":
        cfg, jcfg = cfg.smoke(), jcfg.smoke()
    if over:
        cfg = dataclasses.replace(cfg, **over)
        jcfg = dataclasses.replace(jcfg, **over)
    return cfg, jcfg


def _params(jcfg, seed):
    """One numpy parameter tree for both packages."""
    tree = numpy_params(jax_tf.param_defs(jcfg), seed)
    return params_from_numpy(tree), _jax_tree(tree)


# --- configs and parameter trees --------------------------------------------------
@pytest.mark.parametrize("name", DENSE + ["whisper-base",
                                  "llama-3.2-vision-11b"])
def test_config_matches_reference(name):
    cfg, jcfg = _pair_cfgs(name + ":full")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(cfg.smoke()) == dataclasses.asdict(jcfg.smoke())
    assert cfg.hd == jcfg.hd and cfg.n_params() == jcfg.n_params()
    assert cfg.tdtype == torch.bfloat16 and cfg.smoke().tdtype == torch.float32
    assert get_config(name + "-smoke") == cfg.smoke()
    f8 = dataclasses.replace(cfg, kv_dtype="float8")
    assert f8.kv_tdtype == torch.float8_e4m3fn and cfg.kv_tdtype == cfg.tdtype


def test_unported_family_names_its_roadmap_item():
    """Every family of the reference is carried now: the vlm's config is
    the reference's (full and smoke); an unknown name is still a
    KeyError."""
    vlm = get_config("llama-3.2-vision-11b")
    jvlm = JAX_REGISTRY["llama-3.2-vision-11b"]
    assert dataclasses.asdict(vlm) == dataclasses.asdict(jvlm)
    assert get_config("llama-3.2-vision-11b-smoke") == vlm.smoke()
    assert (vlm.family, vlm.cross_attn_every, vlm.n_vision_tokens) == (
        "vlm", 5, 1601)
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("name", ["smollm-360m:full",
                                  "llama-3.2-vision-11b:full",
                                  "llama-3.2-vision-11b"] + SMOKE)
def test_param_defs_match_reference(name):
    cfg, jcfg = _pair_cfgs(name)
    ours, ref = transformer.param_defs(cfg), jax_tf.param_defs(jcfg)
    assert tree_paths(ours) == tree_paths(ref)
    for path in tree_paths(ours):
        a, b = ours, ref
        for part in path.split("/"):
            a, b = a[part], b[part]
        assert (a.shape, a.axes, a.init) == (b.shape, b.axes, b.init)
        assert str(a.dtype).removeprefix("torch.") == jnp.dtype(b.dtype).name


def test_params_from_numpy_carries_the_stacked_lm_tree():
    """``repro``'s own init of smollm-360m-smoke in bf16, as numpy
    arrays, crosses over with its keys, stacked shapes and values."""
    jcfg = dataclasses.replace(JAX_REGISTRY["smollm-360m"].smoke(),
                               dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jax_init_params(
        jax_tf.param_defs(jcfg), jax.random.PRNGKey(0)))
    out = params_from_numpy(tree)
    assert tree_paths(out) == tree_paths(tree)
    assert out["blocks"]["wq"].shape == (jcfg.n_layers, 64, 64)
    for path in tree_paths(tree):
        a, b = out, tree
        for part in path.split("/"):
            a, b = a[part], b[part]
        assert b.dtype == ml_dtypes.bfloat16 and a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.float().numpy(),
                                      b.astype(np.float32))


# --- compiler: the Program pair ---------------------------------------------------
PAIRS = {"smollm-360m-full": ("smollm-360m:full", {}, 8, 512),
         "smollm-360m-smoke": ("smollm-360m", {}, 2, 16),
         "llama3-8b-smoke": ("llama3-8b", {}, 2, 16),
         "olmo-1b-smoke": ("olmo-1b", {}, 2, 16),
         "smollm-360m-smoke-window": ("smollm-360m", {"attn_window": 8}, 2,
                                      16)}


@pytest.mark.parametrize("case", sorted(PAIRS))
def test_program_pair_listing_and_plans_match_reference(case):
    name, over, slots, max_len = PAIRS[case]
    cfg, jcfg = _pair_cfgs(name, **over)
    ours = transformer.compile_program_pair(cfg, slots=slots,
                                            max_len=max_len)
    ref = jax_tf.compile_program_pair(jcfg, slots=slots, max_len=max_len)
    assert ours.listing() == ref.listing()
    for prog, jprog in ((ours.prefill, ref.prefill),
                        (ours.decode, ref.decode)):
        assert _plain(prog.plan) == _plain(jprog.plan)
        assert [_plain(op) for op in prog.ops] == [_plain(op)
                                                   for op in jprog.ops]
    assert (ours.slots, ours.max_len, ours.paged) == (slots, max_len, None)
    assert _plain(ours.caps) == _plain(ref.caps)
    assert transformer.compile_program_pair(cfg, slots=slots,
                                            max_len=max_len) is ours


@pytest.mark.parametrize("name", SMOKE)
def test_stateless_program_listing_matches_reference(name):
    cfg, jcfg = _pair_cfgs(name)
    ours = transformer.compile_program(cfg, batch=2, seq=16)
    ref = jax_tf.compile_program(jcfg, batch=2, seq=16)
    assert ours.listing() == ref.listing()
    assert _plain(ours.plan) == _plain(ref.plan)


def test_unported_plans_and_families_name_their_roadmap_items():
    """The paged plan is ported; paging a windowed config is refused as
    in ``repro``, and the vlm, which has no Program lowering in either
    package, is refused with the reference's blocker list word for
    word (the engine's ``fallback_reason``)."""
    cfg, _ = _pair_cfgs("smollm-360m")
    assert transformer.compile_program_pair(cfg, paged=True).paged
    with pytest.raises(NotImplementedError, match="mutually exclusive"):
        transformer.compile_program_pair(
            dataclasses.replace(cfg, attn_window=8), paged=True)
    vlm, jvlm = _pair_cfgs("llama-3.2-vision-11b")
    with pytest.raises(NotImplementedError) as err:
        transformer.compile_program_pair(vlm)
    with pytest.raises(NotImplementedError) as jerr:
        jax_tf.compile_program_pair(jvlm)
    assert str(err.value) == str(jerr.value)
    assert ("blocked by: family=vlm (not a decoder-only transformer "
            "graph), gated cross-attention (vision bridge), vision-encoder "
            "inputs") in str(err.value)


# --- norms and rotary ---------------------------------------------------------------
def test_norms_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    jx, jw, jb = map(jnp.asarray, (x, w, b))
    pairs = [(common.rms_norm(tx, tw), jax_common.rms_norm(jx, jw)),
             (common.layer_norm(tx, tw, tb),
              jax_common.layer_norm(jx, jw, jb)),
             (common.layer_norm(tx), jax_common.layer_norm(jx))]
    pos = np.asarray([0, 3, 17, 250], np.int32)
    cos, sin = common.Rotary(32, 500000.0).freqs(torch.from_numpy(pos))
    jcos, jsin = jax_common.Rotary(32, 500000.0).freqs(jnp.asarray(pos))
    pairs += [(cos, jcos), (sin, jsin)]
    q = rng.standard_normal((4, 3, 32)).astype(np.float32)
    pairs.append((common.apply_rope(torch.from_numpy(q), cos[:, None],
                                    sin[:, None]),
                  jax_common.apply_rope(jnp.asarray(q), jcos[:, None],
                                        jsin[:, None])))
    for ours, ref in pairs:
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=TOL,
                                   atol=TOL)
    bf = tx.to(torch.bfloat16)
    assert common.rms_norm(bf, tw).dtype == torch.bfloat16


# --- execution ----------------------------------------------------------------------
@pytest.mark.parametrize("name", SMOKE)
def test_program_forward_matches_reference(name):
    cfg, jcfg = _pair_cfgs(name)
    params, jparams = _params(jcfg, seed=1)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, size=(2, 12))
    ours = transformer.program_forward(params, torch.from_numpy(toks), cfg)
    ref = jax_tf.program_forward(jparams, jnp.asarray(toks, jnp.int32), jcfg,
                                 impl="reference")
    assert ours.shape == (2, 12, cfg.vocab)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL)


def _prefill_args(prompt, max_len):
    padded = np.zeros((1, max_len), np.int32)
    padded[0, :len(prompt)] = prompt
    return padded, len(prompt)


# (config, overrides, prompt lengths per slot, decode steps, dead slot)
DECODE = {
    "smollm-360m": ("smollm-360m", {}, (5, 9), 20, None),
    "llama3-8b": ("llama3-8b", {}, (7, 3), 20, None),
    "olmo-1b": ("olmo-1b", {}, (4, 11), 20, None),
    "smollm-360m-window": ("smollm-360m", {"attn_window": 6}, (5, 12), 20,
                           None),
    "smollm-360m-dead-slot": ("smollm-360m", {"attn_window": 6}, (9, 4), 12,
                              1),
}


@pytest.mark.parametrize("case", sorted(DECODE))
def test_prefill_and_decode_match_reference(case):
    """Prefill both slots, then 20 teacher-forced decode ticks (past
    max_len 16: the ring rolls; with a window of 6 it wraps from the
    start); logits at every step, the caches and the lengths within
    1e-5 of ``repro``'s.  With a dead slot, its cache rows and length
    stay as they were."""
    name, over, lens, steps, dead = DECODE[case]
    cfg, jcfg = _pair_cfgs(name, **over)
    slots, max_len = 2, 16
    params, jparams = _params(jcfg, seed=3)
    pair = transformer.compile_program_pair(cfg, slots=slots,
                                            max_len=max_len)
    jpair = jax_tf.compile_program_pair(jcfg, slots=slots, max_len=max_len)
    state = executor.init_program_state(pair, "cpu")
    jstate = jax_executor.init_program_state(jpair)
    rng = np.random.default_rng(4)
    last = np.zeros((slots,), np.int32)
    for slot, n in enumerate(lens):
        padded, length = _prefill_args(rng.integers(0, cfg.vocab, size=n),
                                       max_len)
        ours = executor.run_prefill(pair.prefill, params,
                                    torch.from_numpy(padded), state, slot,
                                    length)
        ref, jstate = jax_executor.run_prefill(
            jpair.prefill, jparams, jnp.asarray(padded), jstate, slot,
            length, impl="reference")
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                                   atol=TOL)
        last[slot] = int(np.argmax(np.asarray(ref)[0, length - 1]))
    mask = np.ones((slots,), bool)
    if dead is not None:
        mask[dead] = False
        frozen = {rid: buf[dead].clone() for rid, buf in state.caches.items()}
    for _ in range(steps):
        ours = executor.run_decode(pair.decode, params,
                                   torch.from_numpy(last), state,
                                   torch.from_numpy(mask))
        ref, jstate = jax_executor.run_decode(
            jpair.decode, jparams, jnp.asarray(last), jstate,
            jnp.asarray(mask), impl="reference")
        live = np.flatnonzero(mask)
        np.testing.assert_allclose(ours.numpy()[live], np.asarray(ref)[live],
                                   rtol=0, atol=TOL)
        last = np.argmax(np.asarray(ref), axis=-1).astype(np.int32)
    np.testing.assert_array_equal(state.lengths.numpy(),
                                  np.asarray(jstate.lengths))
    assert list(state.lengths.numpy()) == [n + (steps if m else 0)
                                           for n, m in zip(lens, mask)]
    assert sorted(state.caches) == sorted(jstate.caches)
    for rid, buf in state.caches.items():
        np.testing.assert_allclose(buf.numpy(), np.asarray(jstate.caches[rid]),
                                   rtol=0, atol=TOL)
        if dead is not None:
            assert torch.equal(buf[dead], frozen[rid])


def test_decode_program_needs_state():
    cfg, jcfg = _pair_cfgs("smollm-360m")
    params, _ = _params(jcfg, seed=8)
    pair = transformer.compile_program_pair(cfg, slots=2, max_len=16)
    with pytest.raises(ValueError, match="ProgramState"):
        executor.run(pair.decode, params, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="persistent"):
        executor.init_program_state(transformer.compile_program(cfg), "cpu")


# --- serving --------------------------------------------------------------------------
# (config overrides, slots, max_len, prompt lengths, max_new, greedy)
ENGINE = {
    "greedy": ({}, 2, 16, (3, 20, 7, 1, 12), 9, True),
    "window": ({"attn_window": 6}, 2, 16, (10, 4, 17, 6), 12, True),
    "sampled": ({}, 3, 16, (5, 8, 2, 9), 7, False),
}


@pytest.mark.parametrize("case", sorted(ENGINE))
def test_engine_streams_match_reference_engine(case):
    """Token streams identical to ``repro``'s ``ServingEngine(
    use_program=True)``: more requests than slots, a prompt longer than
    max_len (its last max_len tokens), a windowed pair, and the seeded
    sampling; every request prefilled once."""
    over, slots, max_len, lens, max_new, greedy = ENGINE[case]
    cfg, jcfg = _pair_cfgs("smollm-360m", **over)
    params, jparams = _params(jcfg, seed=5)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in lens]
    ours = ServingEngine(cfg, params, slots=slots, max_len=max_len,
                         greedy=greedy, device="cpu")
    ref = JaxEngine(jcfg, jparams, slots=slots, max_len=max_len,
                    greedy=greedy, impl="reference", use_program=True)
    for i, p in enumerate(prompts):
        assert ours.submit(Request(uid=i, prompt=p,
                                   max_new_tokens=max_new)).accepted
        ref.submit(JaxRequest(uid=i, prompt=p, max_new_tokens=max_new))
    got = sorted(ours.run_until_drained(), key=lambda r: r.uid)
    want = sorted(ref.run_until_drained(), key=lambda r: r.uid)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(r.done and len(r.out_tokens) == max_new for r in got)
    assert ours.n_prefills == len(prompts) == ref.n_prefills
    assert ours.n_prefill_recomputes == 0
    assert ours.n_decode_ticks == ref.n_decode_ticks
    assert not ours.live and not ours.admission


def test_engine_retires_on_eos_like_the_reference_engine():
    """An EOS id taken from the middle of a greedy stream retires that
    request early, in both engines alike."""
    cfg, jcfg = _pair_cfgs("smollm-360m")
    params, jparams = _params(jcfg, seed=9)
    prompts = [np.asarray(p, np.int32) for p in ([5, 6, 7], [9, 1], [3])]

    def serve(eng, req_cls, **kw):
        for i, p in enumerate(prompts):
            eng.submit(req_cls(uid=i, prompt=p, max_new_tokens=8))
        return [r.out_tokens for r in sorted(eng.run_until_drained(),
                                             key=lambda r: r.uid)]
    free = serve(ServingEngine(cfg, params, slots=2, max_len=16,
                               device="cpu"), Request)
    eos = free[1][3]
    got = serve(ServingEngine(cfg, params, slots=2, max_len=16, eos_id=eos,
                              device="cpu"), Request)
    want = serve(JaxEngine(jcfg, jparams, slots=2, max_len=16, eos_id=eos,
                           impl="reference", use_program=True), JaxRequest)
    assert got == want
    assert got[1] == free[1][:free[1].index(eos) + 1]


def test_engine_queue_capacity_and_slot_stalls_are_typed():
    cfg, jcfg = _pair_cfgs("smollm-360m", n_layers=2)
    params, _ = _params(jcfg, seed=7)
    eng = ServingEngine(cfg, params, slots=1, max_len=8, device="cpu",
                        queue_capacity=2)
    tickets = [eng.submit(Request(uid=i, prompt=np.asarray([1, 2], np.int32),
                                  max_new_tokens=2)) for i in range(3)]
    assert [t.accepted for t in tickets] == [True, True, False]
    assert tickets[2].reason == "queue_full" and eng.admission.n_rejected == 1
    done = eng.step()               # one slot: the second request waits
    assert eng.admission.blocked["no_free_slot"] == 1
    done += eng.run_until_drained()
    assert sorted(r.uid for r in done) == [0, 1]


@pytest.mark.parametrize("option", [dict(chunk_size=4, spec_k=1),
                                    dict(spec_k=2), dict(obs=True)],
                         ids=["chunked-spec", "spec", "obs"])
def test_engine_spec_and_obs_options_serve(option):
    """Speculative decode (with and without chunked prefill) and an
    ``obs`` bundle construct and serve the greedy streams of the plain
    engine; the plane counts what the engine did."""
    from repro_torch.obs import FlightRecorder, Observability
    cfg, jcfg = _pair_cfgs("smollm-360m", n_layers=2)
    params, _ = _params(jcfg, seed=7)
    if option.get("obs"):
        option = dict(obs=Observability(flight=FlightRecorder()))
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in (3, 11, 6)]

    def serve(**kw):
        eng = ServingEngine(cfg, params, slots=2, max_len=16, device="cpu",
                            **kw)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=5))
        done = sorted(eng.run_until_drained(), key=lambda r: r.uid)
        return eng, [r.out_tokens for r in done]
    eng, got = serve(**option)
    assert got == serve()[1]
    if "spec_k" in option:
        assert eng.n_spec_proposed > 0 and eng.n_starved_ticks == 0
    if "obs" in option:
        snap = eng.obs.registry.snapshot()["counters"]
        assert snap["serving_tokens_total"] == 15
        assert sum(e["ev"] == "release"
                   for e in eng.obs.flight.events) == 3


def test_engine_spec_refuses_paged_kv():
    """Speculation over the paged plan is refused at construction, as in
    the reference (the verify burst would need per-row page
    preparation)."""
    cfg, _ = _pair_cfgs("smollm-360m")
    with pytest.raises(NotImplementedError, match="paged"):
        ServingEngine(cfg, {}, device="cpu", paged=True, spec_k=2)


def test_serve_lm_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "smollm-360m", "--smoke", "--device", "cpu", "--slots", "2",
         "--requests", "3", "--max-new", "4", "--max-len", "16",
         "--prompt-len", "2-20", "--window", "8"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "program pair smollm-360m-smoke: prefill" in proc.stdout
    assert "served 3 requests, 12 tokens in" in proc.stdout
    assert "prefills=3 prefill_recomputes=0" in proc.stdout
