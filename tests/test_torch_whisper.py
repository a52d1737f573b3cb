"""The port's audio family (whisper) against ``repro``'s, on the same
numpy weights, frames and tokens: configs and parameter trees, the
encoder and the admission-time memory rows, the (prefill, decode)
Program pair's listings and region plans (smoke and full width),
prefill + decode logits, self-attention caches and encoder memory
against ``repro``'s executor (learned positions at prefill and decode, a
dead slot), the memory regions left bitwise as written by decode ticks,
the engine's greedy streams (a re-admitted slot; eagerly and through the
CUDA-graph stand-in), the refusal of a request without encoder input,
and the serve CLI on the CPU.  f32 smoke config (2 + 2 layers, d_model
64, encoder_seq 16): the same math in another order, held to 1e-5."""
import dataclasses
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.models import whisper as jax_whisper  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.runtime import executor as jax_executor  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402

from repro_torch.configs import REGISTRY, get_config  # noqa: E402
from repro_torch.core import TPU_V5E  # noqa: E402
from repro_torch.models import (param_defs, params_from_numpy,  # noqa: E402
                                transformer, tree_paths, whisper)
from repro_torch.runtime import executor  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

from test_torch_cnn import _jax_tree, numpy_params  # noqa: E402
from test_torch_compiler import _plain  # noqa: E402
from test_torch_graphs import FakeGraph, fake_graph, graphs  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
NAME = "whisper-base"
SLOTS, MAX_LEN = 2, 16


def _cfgs(full=False):
    cfg, jcfg = REGISTRY[NAME], JAX_REGISTRY[NAME]
    return (cfg, jcfg) if full else (cfg.smoke(), jcfg.smoke())


def _params(jcfg, seed):
    """One numpy parameter tree for both packages; the learned position
    table scaled up, so a dropped position term shows in the logits."""
    tree = numpy_params(jax_whisper.param_defs(jcfg), seed)
    tree["pos_embed"] = tree["pos_embed"] * 50.0
    return params_from_numpy(tree), _jax_tree(tree)


def _frames(cfg, rng):
    return rng.standard_normal((cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)


def _close(ours, ref):
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref, np.float32), rtol=0, atol=TOL)


def _padded(prompt, max_len=MAX_LEN):
    padded = np.zeros((1, max_len), np.int32)
    padded[0, :len(prompt)] = prompt
    return padded


# --- configs and parameter trees --------------------------------------------------
def test_config_matches_reference():
    for full in (True, False):
        cfg, jcfg = _cfgs(full)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.n_params() == jcfg.n_params()
        assert get_config(cfg.name) == cfg
    cfg, _ = _cfgs(full=True)
    assert (cfg.family, cfg.n_layers, cfg.n_encoder_layers,
            cfg.encoder_seq, cfg.d_model, cfg.vocab) == (
        "audio", 6, 6, 1500, 512, 51865)
    assert cfg.tie_embeddings and cfg.tdtype == torch.bfloat16


@pytest.mark.parametrize("full", [True, False], ids=["full", "smoke"])
def test_param_defs_match_reference(full):
    cfg, jcfg = _cfgs(full)
    ours, ref = param_defs(cfg), jax_whisper.param_defs(jcfg)
    assert ours.keys() == ref.keys()
    assert tree_paths(ours) == tree_paths(ref)
    for path in tree_paths(ours):
        a, b = ours, ref
        for part in path.split("/"):
            a, b = a[part], b[part]
        assert (a.shape, a.axes, a.init, a.init_scale) == (
            b.shape, b.axes, b.init, b.init_scale)
        assert str(a.dtype).removeprefix("torch.") == jnp.dtype(b.dtype).name


# --- the encoder and its memory rows ------------------------------------------------
def test_encode_and_memory_rows_match_reference():
    """The sinusoid-positioned encoder over a batch of two frame sets and
    the per-layer (T_enc, KV, hd) cross K/V rows of one request."""
    cfg, jcfg = _cfgs()
    params, jparams = _params(jcfg, seed=1)
    rng = np.random.default_rng(2)
    frames = np.stack([_frames(cfg, rng) for _ in range(2)])
    _close(whisper._sinusoid(cfg.encoder_seq, cfg.d_model),
           jax_whisper._sinusoid(cfg.encoder_seq, cfg.d_model))
    _close(whisper.encode(params, torch.from_numpy(frames), cfg),
           jax_whisper.encode(jparams, jnp.asarray(frames), jcfg,
                              impl="reference"))
    rows = whisper.encode_memory(params, torch.from_numpy(frames[0]), cfg)
    jrows = jax_whisper.encode_memory(jparams, jnp.asarray(frames[0]), jcfg,
                                      impl="reference")
    assert list(rows) == list(jrows)
    for name, row in rows.items():
        assert tuple(row.shape) == (cfg.encoder_seq, cfg.n_kv_heads, cfg.hd)
        _close(row, jrows[name])


def test_legacy_entry_points_name_their_roadmap_item():
    """The legacy entry points are ported: ``forward(encoder_frames=,
    return_cache=True, cache_len=)``, ``init_cache`` and two
    ``decode_step``s against ``repro.models.whisper`` (logits and every
    cache leaf, the scaled position table included), and the missing
    encoder input refused with the reference's message."""
    cfg, jcfg = _cfgs()
    params, jparams = _params(jcfg, seed=8)
    rng = np.random.default_rng(8)
    frames = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    toks = rng.integers(0, cfg.vocab, (2, 5)).astype(np.int32)
    out = whisper.forward(params, torch.from_numpy(toks), cfg,
                          encoder_frames=torch.from_numpy(frames),
                          return_cache=True, cache_len=9, impl="reference")
    jout = jax_whisper.forward(jparams, jnp.asarray(toks), jcfg,
                               encoder_frames=jnp.asarray(frames),
                               return_cache=True, cache_len=9,
                               impl="reference")
    _close(out["logits"], jout["logits"])
    cache, jcache = out["cache"], jout["cache"]
    zero = whisper.init_cache(cfg, 2, 9)
    for k, v in jax_whisper.init_cache(jcfg, 2, 9).items():
        assert tuple(zero[k].shape) == v.shape == jcache[k].shape, k
    for t in range(2):
        for k in jcache:
            _close(cache[k], jcache[k])
        tok = rng.integers(0, cfg.vocab, (2,)).astype(np.int32)
        logits, cache = whisper.decode_step(params, cache,
                                            torch.from_numpy(tok), cfg,
                                            impl="reference")
        jlogits, jcache = jax_whisper.decode_step(jparams, jcache,
                                                  jnp.asarray(tok), jcfg,
                                                  impl="reference")
        _close(logits, jlogits)
    with pytest.raises(ValueError, match="whisper needs encoder_frames"):
        whisper.forward(params, torch.from_numpy(toks), cfg)


# --- compiler: the Program pair ---------------------------------------------------
@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
def test_program_pair_listing_and_plans_match_reference(full):
    """Full width at the served geometry (8 slots, max_len 448), smoke at
    (2, 16): compile only, no weights."""
    cfg, jcfg = _cfgs(full)
    slots, max_len = (8, 448) if full else (SLOTS, MAX_LEN)
    ours = transformer.compile_program_pair(cfg, slots=slots,
                                            max_len=max_len, hw=TPU_V5E)
    ref = jax_tf.compile_program_pair(jcfg, slots=slots, max_len=max_len)
    assert ours.listing() == ref.listing()
    for prog, jprog in ((ours.prefill, ref.prefill),
                        (ours.decode, ref.decode)):
        assert prog.listing() == jprog.listing()
        assert _plain(prog.plan) == _plain(jprog.plan)
        assert [_plain(op) for op in prog.ops] == [_plain(op)
                                                   for op in jprog.ops]
    assert _plain(ours.caps) == _plain(ref.caps)
    assert ours.chunk_blocker == ref.chunk_blocker is not None
    kinds = {op.kernel for op in ours.decode.ops}
    assert {"cross_attention", "decode_attention"} <= kinds
    specs, _ = whisper._audio_state_specs(cfg, slots, max_len)
    assert [s.name for s in specs if s.read_only] == [
        f"l{i}.{side}" for i in range(cfg.n_layers)
        for side in ("cross_k", "cross_v")]
    if full:
        mb = {k: sum(r.size_bytes for r in ours.decode.plan
                     .persistent_regions() if r.name.endswith(k)) / 1e6
              for k in ("_cache", "cross_k", "cross_v")}
        assert round(mb["_cache"], 1) == 44.0
        assert round(mb["cross_k"] + mb["cross_v"], 1) == 147.5


# --- execution ----------------------------------------------------------------------
def _write_memory(pair, jpair, params, jparams, state, jstate, slot, frames):
    """Admission's memory write in both packages: the port's rows copied
    into the regions in place, ``repro``'s set functionally."""
    cfg = REGISTRY[NAME].smoke()
    rows = whisper.encode_memory(params, torch.from_numpy(frames), cfg)
    for name, row in rows.items():
        state.caches[pair.persistent[name]][slot].copy_(row)
    jrows = jax_whisper.encode_memory(jparams, jnp.asarray(frames),
                                      JAX_REGISTRY[NAME].smoke(),
                                      impl="reference")
    for name, row in jrows.items():
        rid = jpair.persistent[name]
        jstate.caches[rid] = jstate.caches[rid].at[slot].set(row)


def _setup(seed):
    cfg, jcfg = _cfgs()
    params, jparams = _params(jcfg, seed)
    pair = transformer.compile_program_pair(cfg, slots=SLOTS,
                                            max_len=MAX_LEN)
    jpair = jax_tf.compile_program_pair(jcfg, slots=SLOTS, max_len=MAX_LEN)
    state = executor.init_program_state(pair, "cpu")
    jstate = jax_executor.init_program_state(jpair)
    return cfg, pair, jpair, params, jparams, state, jstate


def _memory_rids(pair):
    """The encoder memory regions (the read-only specs')."""
    return [r.rid for r in pair.decode.plan.persistent_regions()
            if r.name.endswith(("cross_k", "cross_v"))]


def test_prefill_and_decode_match_reference():
    """Memory written and a prompt prefilled in both slots, then 8
    teacher-forced decode ticks, slot 1 dead for the last 3: logits at
    every step, the self-attention caches, the memory regions and the
    lengths within 1e-5 of ``repro``'s executor; the dead slot's rows
    stay as they were.  The learned positions enter at prefill (rows
    [0, S)) and at decode (each slot's own row)."""
    cfg, pair, jpair, params, jparams, state, jstate = _setup(seed=3)
    rng = np.random.default_rng(4)
    prefill = jax_executor.jitted_prefill_runner(jpair.prefill,
                                                 impl="reference")
    last = np.zeros((SLOTS,), np.int32)
    for slot, n in enumerate((5, 9)):
        _write_memory(pair, jpair, params, jparams, state, jstate, slot,
                      _frames(cfg, rng))
        padded = _padded(rng.integers(0, cfg.vocab, size=n))
        ours = executor.run_prefill(pair.prefill, params,
                                    torch.from_numpy(padded), state, slot, n)
        ref, jstate = prefill(jparams, jnp.asarray(padded), jstate, slot, n)
        _close(ours, ref)
        last[slot] = int(np.argmax(np.asarray(ref)[0, n - 1]))
    decode = jax_executor.jitted_decode_runner(jpair.decode, impl="reference")
    mask = np.ones((SLOTS,), bool)
    for step in range(8):
        if step == 5:
            mask[1] = False
            frozen = {rid: buf[1].clone() for rid, buf in state.caches.items()}
        ours = executor.run_decode(pair.decode, params, torch.from_numpy(last),
                                   state, torch.from_numpy(mask))
        ref, jstate = decode(jparams, jnp.asarray(last), jstate,
                             jnp.asarray(mask))
        live = np.flatnonzero(mask)
        _close(ours[live], np.asarray(ref)[live])
        last = np.argmax(np.asarray(ref), axis=-1).astype(np.int32)
    assert list(state.lengths.numpy()) == [5 + 8, 9 + 5]
    assert sorted(state.caches) == sorted(jstate.caches)
    for rid, buf in state.caches.items():
        _close(buf, jstate.caches[rid])
        assert torch.equal(buf[1], frozen[rid])


def test_learned_positions_enter_prefill_and_decode():
    """The embed op adds the position table: zeroing it moves the
    prefill logits and a decode tick's, so the parity above holds the
    position term, not a zero."""
    cfg, pair, jpair, params, jparams, state, _ = _setup(seed=5)
    frames = _frames(cfg, np.random.default_rng(6))
    rows = whisper.encode_memory(params, torch.from_numpy(frames), cfg)
    flat = dict(params, pos_embed=torch.zeros_like(params["pos_embed"]))
    toks = torch.from_numpy(_padded([3, 1, 4, 1, 5]))
    out = []
    for p in (params, flat):
        st = executor.init_program_state(pair, "cpu")
        for name, row in rows.items():
            st.caches[pair.persistent[name]][0].copy_(row)
        pre = executor.run_prefill(pair.prefill, p, toks, st, 0, 5)
        dec = executor.run_decode(pair.decode, p,
                                  torch.tensor([2, 0], dtype=torch.int32), st,
                                  torch.tensor([True, False]))
        out.append((pre[0, :5], dec[0]))
    for a, b in zip(*out):
        assert (a - b).abs().max() > 1e-3


def test_encoder_memory_is_read_only_under_decode():
    """Decode ticks leave every memory region bitwise as admission wrote
    it (``read_only`` regions of the plan), live slot or dead."""
    cfg, pair, jpair, params, jparams, state, jstate = _setup(seed=7)
    rng = np.random.default_rng(8)
    for slot in range(SLOTS):
        _write_memory(pair, jpair, params, jparams, state, jstate, slot,
                      _frames(cfg, rng))
        executor.run_prefill(pair.prefill, params,
                             torch.from_numpy(_padded([7, 8, 9])), state,
                             slot, 3)
    written = {rid: state.caches[rid].clone() for rid in _memory_rids(pair)}
    assert len(written) == 2 * cfg.n_layers
    for step in range(6):
        executor.run_decode(pair.decode, params,
                            torch.tensor([step, step + 1], dtype=torch.int32),
                            state, torch.tensor([True, step < 3]))
    for rid, buf in written.items():
        assert torch.equal(state.caches[rid], buf)


def test_stateless_run_refuses_the_cross_op():
    cfg, pair, _, params, _, _, _ = _setup(seed=9)
    with pytest.raises(ValueError, match="persistent encoder memory"):
        executor.run(pair.prefill, params, torch.from_numpy(_padded([1])))


# --- serving --------------------------------------------------------------------------
def _serve_both(cfg, jcfg, params, jparams, prompts, frames, max_new, **kw):
    ours = ServingEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                         device="cpu", **kw)
    ref = JaxEngine(jcfg, jparams, slots=SLOTS, max_len=MAX_LEN,
                    impl="reference", use_program=True)
    for i, (p, f) in enumerate(zip(prompts, frames)):
        assert ours.submit(Request(uid=i, prompt=p, max_new_tokens=max_new,
                                   extra=f)).accepted
        ref.submit(JaxRequest(uid=i, prompt=p, max_new_tokens=max_new,
                              extra=f))
    got = sorted(ours.run_until_drained(), key=lambda r: r.uid)
    want = sorted(ref.run_until_drained(), key=lambda r: r.uid)
    assert ref.fallback_reason is None
    return ours, ref, got, want


def test_engine_streams_match_reference_engine():
    """Greedy streams identical to ``repro``'s ``ServingEngine(
    use_program=True)`` on 2 slots with 3 requests, so one slot is
    re-admitted with another request's encoder memory; every request
    prefilled once."""
    cfg, jcfg = _cfgs()
    params, jparams = _params(jcfg, seed=10)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in (3, 6, 2)]
    frames = [_frames(cfg, rng) for _ in prompts]
    ours, ref, got, want = _serve_both(cfg, jcfg, params, jparams, prompts,
                                       frames, max_new=6)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(r.done and len(r.out_tokens) == 6 for r in got)
    assert ours.n_prefills == len(prompts) == ref.n_prefills
    assert ours.n_prefill_recomputes == 0
    assert ours.n_decode_ticks == ref.n_decode_ticks


def test_engine_streams_through_graphs_match_reference_engine(graphs):
    """The same serving through the graphed runners (the CUDA-graph
    stand-in): the memory of a re-admitted slot is copied into the
    regions the captured graphs read, so the streams still equal
    ``repro``'s, and the ticks ran off captured graphs."""
    cfg, jcfg = _cfgs()
    params, jparams = _params(jcfg, seed=12)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in (4, 2, 5)]
    frames = [_frames(cfg, rng) for _ in prompts]
    ours, _, got, want = _serve_both(cfg, jcfg, params, jparams, prompts,
                                     frames, max_new=5)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    kinds = {k[2] for k, g in ours.state.graphs.graphs.items()
             if g is not None}
    assert kinds == {"prefill", "decode"}


def test_request_without_encoder_input_is_refused():
    cfg, jcfg = _cfgs()
    params, _ = _params(jcfg, seed=14)
    eng = ServingEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                        device="cpu")
    eng.submit(Request(uid=0, prompt=np.asarray([1, 2], np.int32)))
    with pytest.raises(ValueError, match="encoder"):
        eng.step()


def test_serve_cli_runs_whisper_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", NAME,
         "--smoke", "--device", "cpu", "--requests", "5", "--slots", "2",
         "--max-new", "4"], capture_output=True, text=True, env=env,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "program pair whisper-base-smoke" in proc.stdout
    assert "served 5 requests, 20 tokens in" in proc.stdout
    assert "prefills=5 prefill_recomputes=0" in proc.stdout
