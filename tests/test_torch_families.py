"""The port's recurrent families (zamba2 hybrid, pure-SSD mamba2, rwkv6)
against ``repro``'s, on the same numpy weights and tokens: configs and
parameter trees, the (prefill, decode) Program pair's listings and
region plans (smoke and full width), prefill + decode logits and states
against ``repro``'s executor (a dead slot included), state carried past
``max_len`` against ``repro``'s legacy decode loop, same-tick slot reuse,
the engine's greedy streams, the paged / chunked refusals, and the serve
CLI on the CPU.  f32 smoke configs: the same math in another order,
held to 1e-5."""
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
from repro.models import get_model  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.runtime import executor as jax_executor  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402

from repro_torch.configs import REGISTRY, get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import (param_defs, params_from_numpy,  # noqa: E402
                                transformer, tree_paths)
from repro_torch.runtime import executor  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

from test_torch_cnn import _jax_tree, numpy_params  # noqa: E402
from test_torch_compiler import _plain  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
FAMILIES = ["zamba2-7b", "mamba2", "rwkv6-7b"]


def _cfgs(name, full=False):
    cfg, jcfg = REGISTRY[name], JAX_REGISTRY[name]
    return (cfg, jcfg) if full else (cfg.smoke(), jcfg.smoke())


def _params(jcfg, seed):
    """One numpy parameter tree for both packages."""
    tree = numpy_params(get_model(jcfg).param_defs(jcfg), seed)
    return params_from_numpy(tree), _jax_tree(tree)


def _close(ours, ref):
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref, np.float32), rtol=0, atol=TOL)


def _padded(prompt, max_len):
    padded = np.zeros((1, max_len), np.int32)
    padded[0, :len(prompt)] = prompt
    return padded


# --- configs and parameter trees --------------------------------------------------
@pytest.mark.parametrize("name", FAMILIES)
def test_config_and_param_defs_match_reference(name):
    for full in (True, False):
        cfg, jcfg = _cfgs(name, full)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.n_params() == jcfg.n_params()
        assert get_config(cfg.name) == cfg
        ours, ref = param_defs(cfg), get_model(jcfg).param_defs(jcfg)
        assert tree_paths(ours) == tree_paths(ref)
        for path in tree_paths(ours):
            a, b = ours, ref
            for part in path.split("/"):
                a, b = a[part], b[part]
            assert (a.shape, a.axes, a.init, a.init_scale) == (
                b.shape, b.axes, b.init, b.init_scale)
            assert (str(a.dtype).removeprefix("torch.")
                    == jnp.dtype(b.dtype).name)


def test_params_from_numpy_carries_the_mixed_hybrid_tree():
    """``repro``'s own init of zamba2-7b-smoke in bf16 crosses over with
    its f32 ``A_log`` / ``dt_bias`` / ``D_skip`` beside the bf16 leaves,
    values and dtypes kept."""
    jcfg = dataclasses.replace(JAX_REGISTRY["zamba2-7b"].smoke(),
                               dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jax_init_params(
        get_model(jcfg).param_defs(jcfg), jax.random.PRNGKey(0)))
    out = params_from_numpy(tree)
    assert tree_paths(out) == tree_paths(tree)
    kinds = set()
    for path in tree_paths(tree):
        a, b = out, tree
        for part in path.split("/"):
            a, b = a[part], b[part]
        want = (torch.bfloat16 if b.dtype == ml_dtypes.bfloat16
                else torch.float32)
        assert a.dtype == want and a.shape == b.shape
        kinds.add(want)
        np.testing.assert_array_equal(a.float().numpy(),
                                      b.astype(np.float32))
    assert kinds == {torch.bfloat16, torch.float32}
    assert out["blocks"]["A_log"].dtype == torch.float32


# --- compiler: the Program pair ---------------------------------------------------
PAIRS = [(name, full) for name in FAMILIES for full in (False, True)]


@pytest.mark.parametrize("name,full", PAIRS,
                         ids=[f"{n}-{'full' if f else 'smoke'}"
                              for n, f in PAIRS])
def test_program_pair_listing_and_plans_match_reference(name, full):
    """Full width at the served geometry (8 slots, max_len 512), smoke at
    (2, 16): compile only, no weights."""
    cfg, jcfg = _cfgs(name, full)
    slots, max_len = (8, 512) if full else (2, 16)
    ours = transformer.compile_program_pair(cfg, slots=slots,
                                            max_len=max_len)
    ref = jax_tf.compile_program_pair(jcfg, slots=slots, max_len=max_len)
    assert ours.listing() == ref.listing()
    for prog, jprog in ((ours.prefill, ref.prefill),
                        (ours.decode, ref.decode)):
        assert _plain(prog.plan) == _plain(jprog.plan)
        assert [_plain(op) for op in prog.ops] == [_plain(op)
                                                   for op in jprog.ops]
    assert _plain(ours.caps) == _plain(ref.caps)
    assert ours.chunk_blocker == ref.chunk_blocker is not None


# --- execution ----------------------------------------------------------------------
def _prefill_both(pair, jpair, params, jparams, state, jstate, slot, prompt,
                  max_len):
    padded = _padded(prompt, max_len)
    ours = executor.run_prefill(pair.prefill, params,
                                torch.from_numpy(padded), state, slot,
                                len(prompt))
    ref, jstate = jax_executor.jitted_prefill_runner(
        jpair.prefill, impl="reference")(
            jparams, jnp.asarray(padded), jstate, slot, len(prompt))
    return ours, ref, jstate


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_and_decode_match_reference(name):
    """Prefill both slots, then 12 teacher-forced decode ticks (past
    max_len 16 for the 11-token prompt), slot 1 dead for the last 4:
    logits at every step, every state region and the lengths within 1e-5
    of ``repro``'s executor; the dead slot's rows stay as they were."""
    cfg, jcfg = _cfgs(name)
    slots, max_len = 2, 16
    params, jparams = _params(jcfg, seed=3)
    pair = transformer.compile_program_pair(cfg, slots=slots,
                                            max_len=max_len)
    jpair = jax_tf.compile_program_pair(jcfg, slots=slots, max_len=max_len)
    state = executor.init_program_state(pair, "cpu")
    jstate = jax_executor.init_program_state(jpair)
    rng = np.random.default_rng(4)
    last = np.zeros((slots,), np.int32)
    for slot, n in enumerate((5, 11)):
        ours, ref, jstate = _prefill_both(
            pair, jpair, params, jparams, state, jstate, slot,
            rng.integers(0, cfg.vocab, size=n), max_len)
        _close(ours, ref)
        last[slot] = int(np.argmax(np.asarray(ref)[0, n - 1]))
    decode = jax_executor.jitted_decode_runner(jpair.decode, impl="reference")
    mask = np.ones((slots,), bool)
    for step in range(12):
        if step == 8:
            mask[1] = False
            frozen = {rid: buf[1].clone() for rid, buf in state.caches.items()}
        ours = executor.run_decode(pair.decode, params, torch.from_numpy(last),
                                   state, torch.from_numpy(mask))
        ref, jstate = decode(jparams, jnp.asarray(last), jstate,
                             jnp.asarray(mask))
        live = np.flatnonzero(mask)
        _close(ours[live], np.asarray(ref)[live])
        last = np.argmax(np.asarray(ref), axis=-1).astype(np.int32)
    assert list(state.lengths.numpy()) == [5 + 12, 11 + 8]
    np.testing.assert_array_equal(state.lengths.numpy(),
                                  np.asarray(jstate.lengths))
    assert sorted(state.caches) == sorted(jstate.caches)
    for rid, buf in state.caches.items():
        _close(buf, jstate.caches[rid])
        assert torch.equal(buf[1], frozen[rid])


def test_stateless_run_of_a_prefill_program_matches_reference():
    """``run`` executes a family's prefill Program from zero state
    without a ProgramState, as ``repro``'s does."""
    cfg, jcfg = _cfgs("zamba2-7b")
    params, jparams = _params(jcfg, seed=6)
    pair = transformer.compile_program_pair(cfg, slots=2, max_len=16)
    jpair = jax_tf.compile_program_pair(jcfg, slots=2, max_len=16)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, size=(1, 16))
    ours = executor.run(pair.prefill, params, torch.from_numpy(toks))
    ref = jax_executor.run(jpair.prefill, jparams,
                           jnp.asarray(toks, jnp.int32), impl="reference")
    _close(ours, ref)
    with pytest.raises(ValueError, match="ProgramState"):
        executor.run(pair.decode, params, torch.zeros(2, dtype=torch.int64))


@pytest.mark.parametrize("name", FAMILIES)
def test_state_carries_past_max_len(name):
    """Recurrent state has no sequence axis, so decode runs straight
    past ``max_len``: lengths keep counting, the hybrid's attention ring
    rolls, and the logits match ``repro``'s legacy decode loop fed the
    same tokens (the parity set of ``test_program_families.py``)."""
    cfg, jcfg = _cfgs(name)
    slots, max_len, P, N = 1, 8, 8, 4                 # P + N > max_len
    params, jparams = _params(jcfg, seed=8)
    api = get_model(jcfg)
    pair = transformer.compile_program_pair(cfg, slots=slots,
                                            max_len=max_len)
    state = executor.init_program_state(pair, "cpu")
    prompt = np.arange(1, P + 1, dtype=np.int32)
    cache = api.init_cache(jcfg, slots, max_len)
    for t in range(P):
        leg, cache = api.decode_step(jparams, cache,
                                     jnp.asarray(prompt[t:t + 1]), jcfg,
                                     impl="reference")
    ours = executor.run_prefill(pair.prefill, params,
                                torch.from_numpy(_padded(prompt, max_len)),
                                state, 0, P)
    _close(ours[0, P - 1:P], leg)
    toks = np.argmax(np.asarray(leg), axis=-1).astype(np.int32)
    for _ in range(N):
        leg, cache = api.decode_step(jparams, cache, jnp.asarray(toks), jcfg,
                                     impl="reference")
        ours = executor.run_decode(pair.decode, params,
                                   torch.from_numpy(toks), state)
        _close(ours, leg)
        toks = np.argmax(np.asarray(leg), axis=-1).astype(np.int32)
    assert int(state.lengths[0]) == P + N


# --- serving --------------------------------------------------------------------------
@pytest.mark.parametrize("name", FAMILIES)
def test_same_tick_slot_reuse(name):
    """A slot freed by the prefill token (max_new 1) admits the next
    request in the same tick; the prefill resets the family state, so
    the second stream equals a fresh engine's."""
    cfg, jcfg = _cfgs(name)
    params, _ = _params(jcfg, seed=9)
    prompts = [np.asarray([5, 6], np.int32), np.asarray([7, 8, 9], np.int32)]
    eng = ServingEngine(cfg, params, slots=1, max_len=8, device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=1))
    finished = eng.step()
    assert len(finished) == 2 and not eng.admission and not eng.live
    assert eng.n_prefills == 2 and eng.n_prefill_recomputes == 0
    fresh = ServingEngine(cfg, params, slots=1, max_len=8, device="cpu")
    fresh.submit(Request(uid=1, prompt=prompts[1], max_new_tokens=1))
    assert fresh.step()[0].out_tokens == finished[1].out_tokens


@pytest.mark.parametrize("name", FAMILIES)
def test_engine_streams_match_reference_engine(name):
    """Greedy token streams identical to ``repro``'s ``ServingEngine(
    use_program=True)``: more requests than slots and a prompt longer
    than max_len (its last max_len tokens); every request prefilled
    once."""
    cfg, jcfg = _cfgs(name)
    params, jparams = _params(jcfg, seed=10)
    slots, max_len, max_new = 2, 16, 9
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in (3, 20, 7, 1)]
    ours = ServingEngine(cfg, params, slots=slots, max_len=max_len,
                         device="cpu")
    ref = JaxEngine(jcfg, jparams, slots=slots, max_len=max_len,
                    impl="reference", use_program=True)
    for i, p in enumerate(prompts):
        assert ours.submit(Request(uid=i, prompt=p,
                                   max_new_tokens=max_new)).accepted
        ref.submit(JaxRequest(uid=i, prompt=p, max_new_tokens=max_new))
    got = sorted(ours.run_until_drained(), key=lambda r: r.uid)
    want = sorted(ref.run_until_drained(), key=lambda r: r.uid)
    assert ref.fallback_reason is None
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(r.done and len(r.out_tokens) == max_new for r in got)
    assert ours.n_prefills == len(prompts) == ref.n_prefills
    assert ours.n_prefill_recomputes == 0
    assert ours.n_decode_ticks == ref.n_decode_ticks


@pytest.mark.parametrize("name", FAMILIES)
def test_paged_and_chunked_prefill_are_refused_as_in_reference(name):
    """``--paged``: the reference's error (zamba2's window refuses it
    first; the others' state is not pageable).  ``--chunk-size``: the
    pair's ``chunk_blocker``.  A pair of another config is refused by
    the engine's state-spec check."""
    cfg, jcfg = _cfgs(name)
    with pytest.raises(NotImplementedError) as err:
        transformer.compile_program_pair(cfg, slots=2, max_len=16,
                                         paged=True)
    with pytest.raises(NotImplementedError) as jerr:
        jax_tf.compile_program_pair(jcfg, slots=2, max_len=16, paged=True)
    key = ("mutually exclusive" if cfg.attn_window else "not pageable")
    assert key in str(err.value) and key in str(jerr.value)
    params, _ = _params(jcfg, seed=12)
    with pytest.raises(ValueError, match="not chunkable"):
        ServingEngine(cfg, params, slots=2, max_len=16, device="cpu",
                      chunk_size=4)
    other = "rwkv6-7b" if name != "rwkv6-7b" else "mamba2"
    pair = transformer.compile_program_pair(_cfgs(other)[0], slots=2,
                                            max_len=16)
    with pytest.raises(ValueError, match="ProgramPair compiled"):
        ServingEngine(cfg, params, slots=2, max_len=16, device="cpu",
                      program=pair)


def test_serve_cli_runs_the_families_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "zamba2-7b", "--smoke", "--device", "cpu", "--slots", "2",
         "--requests", "3", "--max-new", "4", "--max-len", "16",
         "--prompt-len", "2-20"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "program pair zamba2-7b-smoke: prefill" in proc.stdout
    assert "served 3 requests, 12 tokens in" in proc.stdout
    assert "prefills=3 prefill_recomputes=0" in proc.stdout
    for arch in ("mamba2", "rwkv6-7b"):
        res = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--slots", "2", "--requests", "3", "--max-new",
                          "3", "--max-len", "16"])
        assert len(res["done"]) == 3 and res["engine"].n_prefills == 3
        assert all(len(r.out_tokens) == 3 for r in res["done"])
