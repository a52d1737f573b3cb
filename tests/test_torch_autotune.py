"""The port's stage 7 (``core/cost.py``, ``runtime/replay.py``,
``core/autotune.py`` and the compile hooks) against ``repro``'s on the
CPU: cost fits and error tables on the same record dicts, tuned-cache
files read and written byte for byte by either package, op signatures
and candidate sets, unmeasured winners, tuned Program listings, replays
on the same operands; then the reference's own autotune cases on the
port (cache hits, no analytic chooser on a full hit, feasibility, fresh
Programs on a new generation, tuned = untuned forwards), the launch keys
the tuner merges candidates by on the card, and both CLIs."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import CNN_REGISTRY as JAX_CNNS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import CNNConfig as JaxCNNConfig  # noqa: E402
from repro.configs.base import CNNLayer as JaxLayer  # noqa: E402
from repro.core import SNOWFLAKE as JAX_SNOWFLAKE  # noqa: E402
from repro.core import TPU_V5E as JAX_TPU_V5E  # noqa: E402
from repro.core import autotune as jax_autotune  # noqa: E402
from repro.core import cost as jax_cost  # noqa: E402
from repro.models import cnn as jax_cnn  # noqa: E402
from repro.models import get_model  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.runtime import executor as jax_executor  # noqa: E402
from repro.runtime import replay as jax_replay  # noqa: E402

from repro_torch.configs import CNN_REGISTRY, get_config  # noqa: E402
from repro_torch.configs.base import CNNConfig, CNNLayer  # noqa: E402
from repro_torch.core import SNOWFLAKE, TPU_V5E, autotune, cost  # noqa: E402
from repro_torch.core import schedule  # noqa: E402
from repro_torch.core.dataflow import Dataflow  # noqa: E402
from repro_torch.core.ir import kernel_kind  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.matmul import ops as matmul_ops  # noqa: E402
from repro_torch.models import cnn, params_from_numpy, transformer  # noqa: E402
from repro_torch.runtime import executor, replay  # noqa: E402

from test_torch_cnn import _jax_tree, numpy_params  # noqa: E402

# The reference's own tuner net (tests/test_autotune.py), in both
# packages' config types: the pool fuses into conv 0.
_TINY_LAYERS = (("conv", dict(c_out=8, k=3, stride=1, pad=1)),
                ("maxpool", dict(k=2, stride=2)),
                ("conv", dict(c_out=16, k=3, stride=1, pad=1)),
                ("fc", dict(c_out=8, activation=None)))
TINY = CNNConfig(name="tiny-tune", input_hw=16, input_ch=4, n_classes=8,
                 layers=tuple(CNNLayer(k, **kw) for k, kw in _TINY_LAYERS))
JAX_TINY = JaxCNNConfig(
    name="tiny-tune", input_hw=16, input_ch=4, n_classes=8,
    layers=tuple(JaxLayer(k, **kw) for k, kw in _TINY_LAYERS))
LM = "smollm-360m-smoke"
SLOTS, MAX_LEN = 2, 16
HWS = {"tpu_v5e": (TPU_V5E, JAX_TPU_V5E, False),
       "snowflake": (SNOWFLAKE, JAX_SNOWFLAKE, True)}


def _close(a, b):
    assert a == pytest.approx(b, rel=1e-12, abs=0), (a, b)


def _cnn_cfgs(name):
    if name == "tiny":
        return TINY, JAX_TINY
    return CNN_REGISTRY[name], JAX_CNNS[name]


def _graphs(model: str):
    """The tuner's graph of ``model`` in both packages (residuals and
    pool fusion marked, as ``tune_cnn`` / ``tune_lm_decode`` mark them),
    with the batch its cache entries are keyed at."""
    if model in ("tiny", "alexnet-owt"):
        cfg, jcfg = _cnn_cfgs(model)
        batch = 2
        pair = (cnn.to_graph(cfg, batch=batch, dtype_bytes=4),
                jax_cnn.to_graph(jcfg, batch=batch, dtype_bytes=4))
    elif model == "smollm-decode":
        batch = SLOTS
        pair = (transformer.to_decode_graph(get_config(LM), slots=SLOTS,
                                            max_len=MAX_LEN),
                jax_tf.to_decode_graph(jax_get_config(LM), slots=SLOTS,
                                       max_len=MAX_LEN))
    else:                                   # the pair's prefill graph
        batch = 1
        pair = (transformer.to_graph(get_config(LM), batch=1, seq=MAX_LEN,
                                     write_cache=True),
                jax_tf.to_graph(jax_get_config(LM), batch=1, seq=MAX_LEN,
                                write_cache=True))
    for g in pair:
        g.mark_residuals()
        g.mark_pool_fusion()
    return pair[0], pair[1], batch


# --- setups: one Program, its params and input, in both packages ---------------
def _setup(model: str, seed: int = 0):
    """(port Program, params, x, state, mask, repro Program, params, x,
    state, mask) on the same numpy weights and inputs."""
    rng = np.random.default_rng(seed)
    if model == "tiny":
        tree = numpy_params(jax_cnn.param_defs(JAX_TINY), seed)
        x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
        return (cnn.compile_program(TINY, batch=2), params_from_numpy(tree),
                torch.from_numpy(x), None, None,
                jax_cnn.compile_program(JAX_TINY, batch=2), _jax_tree(tree),
                jnp.asarray(x), None, None)
    cfg, jcfg = get_config(LM), jax_get_config(LM)
    tree = numpy_params(get_model(jcfg).param_defs(jcfg), seed)
    if model == "smollm-prefill":
        toks = rng.integers(0, cfg.vocab, (1, MAX_LEN)).astype(np.int32)
        return (transformer.compile_program(cfg, batch=1, seq=MAX_LEN),
                params_from_numpy(tree), torch.from_numpy(toks), None, None,
                jax_tf.compile_program(jcfg, batch=1, seq=MAX_LEN),
                _jax_tree(tree), jnp.asarray(toks), None, None)
    pair = transformer.compile_program_pair(cfg, slots=SLOTS, max_len=MAX_LEN)
    state = executor.init_program_state(pair, "cpu")
    for buf in state.caches.values():
        buf.copy_(torch.from_numpy(rng.standard_normal(buf.shape)
                                   .astype(np.float32) * 0.5))
    state.lengths.copy_(torch.tensor([5, 11], dtype=torch.int32))
    toks = rng.integers(0, cfg.vocab, SLOTS).astype(np.int32)
    mask = torch.tensor([True, False])
    jpair = jax_tf.compile_program_pair(jcfg, slots=SLOTS, max_len=MAX_LEN)
    jstate = jax_executor.ProgramState(
        {r: jnp.asarray(t.numpy()) for r, t in state.caches.items()},
        jnp.asarray(state.lengths.numpy()))
    return (pair.decode, params_from_numpy(tree), torch.from_numpy(toks),
            state, mask, jpair.decode, _jax_tree(tree), jnp.asarray(toks),
            jstate, jnp.asarray(mask.numpy()))


def _port_trace(model: str, seed: int = 0, **kw):
    prog, params, x, state, mask = _setup(model, seed)[:5]
    kw.setdefault("measure", False)
    return prog, params, x, state, mask, executor.trace_program(
        prog, params, x, impl="reference", state=state, mask=mask, **kw)


# --- core/cost.py -----------------------------------------------------------------
def _synthetic_records(alpha=2e-13, beta=5e-12, gamma=3e-5, n=8):
    recs = []
    for i in range(1, n + 1):
        # independent columns: a linear relation between flops and
        # traffic would make the coefficients unidentifiable
        flops = i * 1e8
        traffic = ((i * 5) % n + 1) * 1e6
        recs.append({"kind": "conv2d", "flops": flops,
                     "traffic_bytes": traffic,
                     "modeled_time_s": flops / 1e12,
                     "measured_time_s": alpha * flops + beta * traffic
                     + gamma})
    return recs


def _reference_records(source: str) -> list[dict]:
    """Record dicts: from ``repro``'s own measured trace of a Program on
    the CPU, or synthetic (least-squares and scale-mode kinds)."""
    if source == "synthetic-lsq":
        return _synthetic_records()
    if source == "synthetic-scale":
        return _synthetic_records(n=2)
    jprog, jparams, jx = _setup(source)[5:8]
    return jax_executor.trace_program(jprog, jparams, jx, impl="reference",
                                      repeats=2).record_dicts()


@pytest.mark.parametrize("source", ["tiny", "smollm-prefill",
                                    "synthetic-lsq", "synthetic-scale"])
def test_cost_fit_and_error_table_match_reference(source):
    recs = _reference_records(source)
    ours, ref = cost.fit_cost_model(recs), jax_cost.fit_cost_model(recs)
    assert ours.fits and ours.fits.keys() == ref.fits.keys()
    for kind, fit in ours.fits.items():
        want = dataclasses.asdict(ref.fits[kind])
        for name, value in dataclasses.asdict(fit).items():
            if isinstance(value, float):
                _close(value, want[name])
            else:
                assert value == want[name], (kind, name)
    for model, jmodel in ((ours, ref), (None, None)):
        rows = cost.error_table(recs, model)
        jrows = jax_cost.error_table(recs, jmodel)
        assert [r.keys() for r in rows] == [r.keys() for r in jrows]
        for row, jrow in zip(rows, jrows):
            for k, v in row.items():
                if isinstance(v, float):
                    _close(v, jrow[k])
                else:
                    assert v == jrow[k], k
        assert cost.format_error_table(rows) == \
            jax_cost.format_error_table(jrows)
    back = cost.CostModel.from_json(ref.to_json())
    assert back.to_json() == ref.to_json()
    for kind in ours.fits:
        for flops, by, fb in ((1e9, 1e6, 1e-4), (3.3e8, 2.2e6, 7e-5)):
            _close(ours.predict(kind, flops, by, fb),
                   ref.predict(kind, flops, by, fb))


def test_calibration_recovers_synthetic_coefficients():
    model = cost.fit_cost_model(_synthetic_records())
    fit = model.fits["conv2d"]
    assert fit.mode == "lsq" and fit.mean_abs_rel_err < 1e-6
    want = 2e-13 * 3.3e8 + 5e-12 * 2.2e6 + 3e-5
    assert abs(model.predict("conv2d", 3.3e8, 2.2e6, 1.0) - want) / want < 1e-6


def test_calibration_scale_mode_and_json_roundtrip():
    model = cost.fit_cost_model(_synthetic_records(n=2))
    assert model.fits["conv2d"].mode == "scale"
    assert cost.CostModel.from_json(model.to_json()).fits == model.fits
    # an unseen kind passes the analytic estimate through
    assert model.predict("matmul", 1e9, 1e6, 0.123) == 0.123


def test_error_table_emits_calibrated_column():
    recs = _synthetic_records()
    rows = cost.error_table(recs, cost.fit_cost_model(recs))
    assert rows and rows[0]["kind"] == "conv2d"
    assert rows[0]["calibrated_abs_rel_err"] <= \
        rows[0]["analytic_abs_rel_err"] + 1e-12
    assert "conv2d" in cost.format_error_table(rows)


# --- the tuned cache: one file format -----------------------------------------------
@pytest.mark.parametrize("hw_name", ["tpu_v5e", "snowflake"])
def test_cache_files_interchange_byte_for_byte(hw_name, tmp_path):
    """A cache ``repro`` tunes and saves loads in the port with equal
    entries, cost models and generation, and the port saves it back
    byte-equal; a cache the port tunes loads in ``repro`` alike."""
    hw, jhw, pf = HWS[hw_name]
    path = tmp_path / "ref.json"
    ref = jax_autotune.TunedCache.load(str(path))
    jax_autotune.tune_cnn(JAX_TINY, batch=1, hw=jhw, cache=ref,
                          impl="reference", top_k=2, repeats=1,
                          paper_faithful=pf)
    assert ref.entries and ref.cost_models
    ours = autotune.TunedCache.load(str(path))
    assert ours.entries == ref.entries and ours.cost_models == ref.cost_models
    assert ours.generation() == ref.generation() != "empty"
    ours.save(str(tmp_path / "port.json"))
    assert (tmp_path / "port.json").read_bytes() == path.read_bytes()

    mine = autotune.TunedCache.load(str(tmp_path / "mine.json"))
    autotune.tune_cnn(TINY, batch=1, hw=hw, cache=mine, repeats=1, top_k=2,
                      paper_faithful=pf, device="cpu")
    theirs = jax_autotune.TunedCache.load(str(tmp_path / "mine.json"))
    assert theirs.entries == mine.entries and theirs.entries
    assert theirs.generation() == mine.generation()
    theirs.save(str(tmp_path / "back.json"))
    assert ((tmp_path / "back.json").read_bytes()
            == (tmp_path / "mine.json").read_bytes())


# --- signatures, candidates, unmeasured winners -------------------------------------
@pytest.mark.parametrize("hw_name", ["tpu_v5e", "snowflake"])
@pytest.mark.parametrize("model", ["alexnet-owt", "tiny", "smollm-decode",
                                   "smollm-prefill"])
def test_signatures_and_candidates_match_reference(model, hw_name):
    hw, jhw, pf = HWS[hw_name]
    ours, ref, _ = _graphs(model)
    n_tunable = 0
    for node, jnode in zip(ours, ref, strict=True):
        assert node.name == jnode.name
        if kernel_kind(node) not in autotune.TUNABLE:
            continue
        n_tunable += 1
        assert autotune.op_signature(node) == jax_autotune.op_signature(jnode)
        assert (autotune.enumerate_candidates(node, hw, paper_faithful=pf)
                == jax_autotune.enumerate_candidates(jnode, jhw,
                                                     paper_faithful=pf))
    assert n_tunable


def test_op_signature_collapses_identical_blocks():
    graph = transformer.to_decode_graph(get_config(LM), slots=SLOTS,
                                        max_len=MAX_LEN)
    ops = [n for n in graph if kernel_kind(n) in autotune.TUNABLE]
    assert len({autotune.op_signature(n) for n in ops}) < len(ops)


def _scoped(cache) -> dict:
    """Entries keyed without the hardware fingerprint (which names the
    device that measured, so it differs between the packages)."""
    out = {}
    for key, entry in cache.entries.items():
        config, _, rest = key.split("|", 2)
        out[f"{config}|{rest}"] = entry
    return out


def _unmeasured(case: str):
    """(port report, port cache, repro report, repro cache) of one
    ``measure=False`` tune."""
    ours, ref = autotune.TunedCache(), jax_autotune.TunedCache()
    if case == "smollm-decode":
        rep = autotune.tune_lm_decode(get_config(LM), slots=SLOTS,
                                      max_len=MAX_LEN, cache=ours,
                                      measure=False, device="cpu")
        jrep = jax_autotune.tune_lm_decode(jax_get_config(LM), slots=SLOTS,
                                           max_len=MAX_LEN, cache=ref,
                                           impl="reference", measure=False)
        return rep, ours, jrep, ref
    model, hw_name = case.split("@")
    hw, jhw, pf = HWS[hw_name]
    cfg, jcfg = _cnn_cfgs(model)
    rep = autotune.tune_cnn(cfg, batch=1, hw=hw, cache=ours, measure=False,
                            paper_faithful=pf, device="cpu")
    jrep = jax_autotune.tune_cnn(jcfg, batch=1, hw=jhw, cache=ref,
                                 impl="reference", measure=False,
                                 paper_faithful=pf)
    return rep, ours, jrep, ref


@pytest.mark.parametrize("case", ["tiny@tpu_v5e", "tiny@snowflake",
                                  "alexnet-owt@tpu_v5e",
                                  "alexnet-owt@snowflake", "smollm-decode"])
def test_unmeasured_tune_picks_the_reference_winners(case):
    rep, ours, jrep, ref = _unmeasured(case)
    assert _scoped(ours) == _scoped(ref) and ours.entries
    assert ([(r.name, r.sig, r.incumbent, r.winner, r.cached)
             for r in rep.results]
            == [(r.name, r.sig, r.incumbent, r.winner, r.cached)
                for r in jrep.results])
    assert rep.n_measurements == jrep.n_measurements == 0


# --- tuned Programs: the compile hooks ----------------------------------------------
def _pinned_cache(model: str, hw_name: str, path) -> tuple:
    """A ``repro`` cache pinning every tunable op of ``model`` to a
    feasible non-incumbent candidate (the middle of its candidate list)
    plus a fitted cost model, saved at ``path``; and the port's load of
    it with the fingerprints rewritten to the port's CPU one."""
    hw, jhw, pf = HWS[hw_name]
    ref = jax_autotune.TunedCache()
    jfp = jax_autotune.hw_fingerprint(jhw)
    graphs = (["smollm-prefill", "smollm-decode"] if model == "smollm"
              else [model])
    name = LM if model == "smollm" else _cnn_cfgs(model)[1].name
    for g in graphs:
        _, jgraph, batch = _graphs(g)
        for node in jgraph:
            if kernel_kind(node) not in jax_autotune.TUNABLE:
                continue
            cands = jax_autotune.enumerate_candidates(node, jhw,
                                                      paper_faithful=pf)
            if not cands:
                continue
            pick = dict(cands[len(cands) // 2])
            sig = jax_autotune.op_signature(node)
            pick.update(sig=sig, measured_time_s=None, incumbent_time_s=None)
            ref.store(name, jfp, batch, sig, pick)
    recs = _synthetic_records()
    recs += [dict(r, kind="matmul") for r in _synthetic_records(
        alpha=1e-13, beta=7e-12, gamma=1e-5)]
    ref.set_cost_model(jfp, jax_cost.fit_cost_model(recs))
    ref.save(str(path))
    text = path.read_text().replace(jfp, autotune.hw_fingerprint(hw, "cpu"))
    path.write_text(text)
    return ref, autotune.TunedCache.load(str(path))


def _listings(pkg: str, model: str, hw_name: str) -> str:
    hw, jhw, pf = HWS[hw_name]
    if model == "smollm":
        if pkg == "port":
            cfg = get_config(LM)
            return (transformer.compile_program_pair(
                cfg, slots=SLOTS, max_len=MAX_LEN, hw=hw).listing() + "\n"
                + transformer.compile_program(cfg, batch=1, seq=MAX_LEN,
                                              hw=hw).listing())
        jcfg = jax_get_config(LM)
        return (jax_tf.compile_program_pair(
            jcfg, slots=SLOTS, max_len=MAX_LEN, hw=jhw).listing() + "\n"
            + jax_tf.compile_program(jcfg, batch=1, seq=MAX_LEN,
                                     hw=jhw).listing())
    cfg, jcfg = _cnn_cfgs(model)
    if pkg == "port":
        return cnn.compile_program(cfg, batch=2, hw=hw,
                                   paper_faithful=pf).listing()
    return jax_cnn.compile_program(jcfg, batch=2, hw=jhw,
                                   paper_faithful=pf).listing()


@pytest.mark.parametrize("hw_name", ["tpu_v5e", "snowflake"])
@pytest.mark.parametrize("model", ["alexnet-owt", "tiny", "smollm"])
def test_tuned_program_listing_matches_reference(model, hw_name, tmp_path):
    """The same pinned entries and cost model, activated in each
    package, compile to byte-equal listings through every compile entry
    point, and those differ from the untuned ones."""
    untuned = _listings("port", model, hw_name)
    ref, ours = _pinned_cache(model, hw_name, tmp_path / "pinned.json")
    assert ours.entries and len(ours.entries) == len(ref.entries)
    jax_autotune.activate(ref)
    try:
        want = _listings("repro", model, hw_name)
    finally:
        jax_autotune.deactivate()
    autotune.activate(ours, device="cpu")
    try:
        got = _listings("port", model, hw_name)
    finally:
        autotune.deactivate()
    assert got == want
    assert got != untuned
    assert _listings("port", model, hw_name) == untuned


# --- replay ----------------------------------------------------------------------
def _op_operands(op, regions, params, caches):
    """The operands ``op`` reads, in replay's private region ids."""
    rid = replay._RID
    out = {rid["in"]: regions[op.in_region].clone()}
    for role, r in (("k", op.k_region), ("v", op.v_region),
                    ("in2", op.in2_region)):
        if r is not None:
            out[rid[role]] = regions[r].clone()
    if op.fuse_bypass and op.bypass_region is not None:
        out[rid["bypass"]] = regions[op.bypass_region].clone()
    if op.kernel == "decode_attention":
        out[rid["k_cache"]] = caches[op.k_cache_region].clone()
        out[rid["v_cache"]] = caches[op.v_cache_region].clone()
    p = {}
    if op.param_key is not None:
        p["p"] = executor._param(params, op.param_key)
    if op.param_key_b is not None:
        p["p_b"] = executor._param(params, op.param_key_b)
    return out, p


def _feed(monkeypatch, regions, params):
    """Replay on the given operands in place of synthesized ones."""
    monkeypatch.setattr(replay, "synth_operands",
                        lambda rec, seed=0, device=None, scale=0.1:
                        (regions, params))


@pytest.mark.parametrize("model", ["tiny", "smollm-prefill", "smollm-decode"])
def test_replay_reproduces_each_traced_op(model, monkeypatch):
    """Rebuilt from its record alone and fed the operands the traced op
    read, every op's replay equals the executor's output bit for bit,
    at the recorded shape and dtype."""
    prog, params, x, state, mask, trace = _port_trace(model)
    regions = {prog.input_region: x}
    caches = pos = live = None
    if state is not None:
        caches = {r: t.clone() for r, t in state.caches.items()}
        pos, live = state.lengths.clone(), mask
    assert len(trace.records) == len(prog.ops)
    for op, rec in zip(prog.ops, trace.records):
        _feed(monkeypatch, *_op_operands(op, regions, params, caches))
        got = replay.replay_outputs(rec, device="cpu")
        with torch.no_grad():
            want = executor._run_decode_op(op, regions[op.in_region],
                                           regions, params, caches, pos,
                                           live, impl="reference")
        regions[op.out_region] = want
        assert [list(got.shape), str(got.dtype).removeprefix("torch.")] \
            == rec.operands["out"], rec.name
        assert torch.equal(got, want), rec.name


@pytest.mark.parametrize("hw_name", ["tpu_v5e", "snowflake"])
@pytest.mark.parametrize("model", ["tiny", "smollm-decode", "smollm-prefill"])
def test_every_candidate_replays_the_incumbents_output(model, hw_name):
    """Schedule decisions move bytes, never the math: on the plain path
    every feasible candidate's replay equals the incumbent's on the same
    synthesized operands, bit for bit."""
    hw, _, pf = HWS[hw_name]
    graph = _graphs(model)[0]
    nodes = {n.name: n for n in graph}
    trace = _port_trace(model)[-1]
    checked = 0
    for rec in trace.records:
        if rec.kind not in autotune.TUNABLE:
            continue
        base = replay.replay_outputs(rec, seed=3, device="cpu")
        for cand in autotune.enumerate_candidates(nodes[rec.name], hw,
                                                  paper_faithful=pf):
            try:
                rc = autotune.entry_to_replay_candidate(nodes[rec.name],
                                                        cand, hw)
            except ValueError:
                continue
            out = replay.replay_outputs(rec, candidate=rc, seed=3,
                                        device="cpu")
            assert torch.equal(out, base), (rec.name, cand)
            checked += 1
    assert checked


def _numpy_operands(rec, rng):
    """Regions (replay ids) and params of one record as numpy arrays."""
    rid = replay._RID
    vocab = rec.operands["w"][0][0] if rec.kind == "embed" else 2

    def draw(shape, dt):
        if dt == "bool":
            return np.ones(shape, bool)
        if dt.startswith("int"):
            return rng.integers(0, vocab, shape).astype(dt)
        return (rng.standard_normal(shape) * 0.5).astype(np.float32)
    regions = {rid[role]: draw(*rec.operands[role]) for role in rid
               if role in rec.operands and role != "out"}
    params = {}
    if "w" in rec.operands:
        w = draw(*rec.operands["w"])
        b = draw(*rec.operands["b"]) if "b" in rec.operands else None
        if rec.operands["param_dict"][1] == "dict":
            params["p"] = {"w": w} if b is None else {"w": w, "b": b}
        else:
            params["p"] = w
            if b is not None:
                params["p_b"] = b
    return regions, params


def _reference_replay(rec, candidate, regions, params):
    """``repro``'s replay of one record on given operands: its
    ``op_from_record`` and the dispatch its ``replay_record`` makes."""
    op = jax_replay.op_from_record(rec.to_dict(), candidate)
    jreg = {k: jnp.asarray(v) for k, v in regions.items()}
    jpar = jax.tree_util.tree_map(jnp.asarray, params)
    if rec.kind == "decode_attention":
        return jax_executor._run_decode_attention(
            op, jreg[op.in_region], jreg[op.k_region], jreg[op.v_region],
            jreg[op.k_cache_region], jreg[op.v_cache_region],
            jnp.asarray(rec.extras["pos"], jnp.int32),
            jnp.asarray(rec.extras["live"], bool), impl="reference",
            interpret=None)[0]
    return jax_executor._run_op(op, jreg[op.in_region], jreg, jpar,
                                impl="reference", interpret=None)


@pytest.mark.parametrize("model", ["tiny", "smollm-prefill", "smollm-decode"])
def test_replays_match_reference_on_the_same_operands(model, monkeypatch):
    """Each record replayed by both packages on the same numpy operands
    (the incumbent, and for a tunable op a substituted candidate) agrees
    within 1e-5."""
    graph = _graphs(model)[0]
    nodes = {n.name: n for n in graph}
    trace = _port_trace(model)[-1]
    rng = np.random.default_rng(7)
    for rec in trace.records:
        regions, params = _numpy_operands(rec, rng)
        cands = [None]
        if rec.kind in autotune.TUNABLE:
            options = autotune.enumerate_candidates(nodes[rec.name], TPU_V5E)
            cands.append(autotune.entry_to_replay_candidate(
                nodes[rec.name], options[len(options) // 2], TPU_V5E))
        for cand in cands:
            _feed(monkeypatch, {k: torch.from_numpy(v.copy())
                                for k, v in regions.items()},
                  params_from_numpy(params))
            ours = replay.replay_outputs(rec, candidate=cand, device="cpu")
            jcand = None if cand is None else {
                k: (dataclasses.asdict(v) if k == "conv_tiling" else v)
                for k, v in cand.items()}
            ref = _reference_replay(rec, jcand, regions, params)
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=rec.name)


def test_replay_refuses_family_kinds():
    from test_torch_trace import _decode_setup
    _, _, tree, pair, state, tokens, mask = _decode_setup("zamba2-7b", 5)
    trace = executor.trace_program(pair.decode, params_from_numpy(tree),
                                   tokens, impl="reference", measure=False,
                                   state=state, mask=mask)
    recs = [r for r in trace.records if r.kind == "ssm_scan"]
    assert recs and trace.repeats == 0
    with pytest.raises(NotImplementedError, match="ssm_scan"):
        replay.replay_record(recs[0], device="cpu")


def test_synth_operands_are_seeded_on_the_device():
    trace = _port_trace("smollm-decode")[-1]
    rec = next(r for r in trace.records if r.kind == "decode_attention")
    a, pa = replay.synth_operands(rec, 4, device="cpu")
    b, _ = replay.synth_operands(rec, 4, device="cpu")
    c, _ = replay.synth_operands(rec, 5, device="cpu")
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a[replay._RID["in"]], c[replay._RID["in"]])
    assert all(t.device.type == "cpu" for t in a.values())
    assert [list(a[replay._RID["k_cache"]].shape), "float32"] == \
        rec.operands["k_cache"]


@pytest.mark.parametrize("scale, shows", [(0.1, False), (1.0, True)])
def test_decode_replay_at_unit_scale_shows_a_wrong_softmax_scale(
        scale, shows, monkeypatch):
    """Attending at twice the softmax scale moves a decode replay's
    output past the bf16 bar (2^-7) on unit-variance operands, whose
    scores spread by about one, and not at the default std 0.1, where
    the softmax is near uniform: the card's check of each tuned decode
    op replays at ``scale=1`` for this."""
    rec = next(r for r in _port_trace("smollm-decode")[-1].records
               if r.kind == "decode_attention")
    right = replay.replay_outputs(rec, device="cpu", scale=scale)

    def doubled(q, k, v, **kw):
        return decode_ops.decode_attention(
            q, k, v, scale=2 * q.shape[-1] ** -0.5, **kw)

    monkeypatch.setattr(executor, "decode_attention", doubled)
    wrong = replay.replay_outputs(rec, device="cpu", scale=scale)
    assert ((wrong - right).abs().max().item() > 2.0 ** -7) == shows


# --- trace schema and clocks --------------------------------------------------------
def test_trace_roundtrip_and_determinism(tmp_path):
    prog, params, x, _, _, tr = _port_trace("tiny")
    assert len(tr.records) == len(prog.ops) and tr.repeats == 0
    assert all(r.measured_time_s is None and r.repeats == 0
               for r in tr.records)
    path = tmp_path / "t.jsonl"
    tr.save(str(path))
    back = executor.ExecutorTrace.load(str(path))
    assert [r.static_dict() for r in back.records] == \
        [r.static_dict() for r in tr.records]
    again = executor.trace_program(prog, params, x, impl="reference",
                                   measure=False)
    assert [r.static_dict() for r in again.records] == \
        [r.static_dict() for r in tr.records]
    # the reference reads the port's file
    ref = jax_executor.ExecutorTrace.load(str(path))
    assert ref.record_dicts() == tr.record_dicts()


def test_trace_measures_on_the_host_clock_and_refuses_the_device_one():
    prog, params, x, _, _, tr = _port_trace("tiny", measure=True, repeats=2)
    assert tr.repeats == 2
    assert all(r.measured_time_s > 0 and r.repeats == 2 for r in tr.records)
    with pytest.raises(ValueError, match="device clock"):
        executor.trace_program(prog, params, x, clock="device")
    with pytest.raises(ValueError, match="clock"):
        executor.trace_program(prog, params, x, clock="wall")
    with pytest.raises(ValueError, match="CUDA"):
        executor.device_times(lambda: None, 2, 1, torch.device("cpu"))


def test_hw_fingerprint_names_model_and_device():
    cpu = autotune.hw_fingerprint(TPU_V5E, "cpu")
    assert cpu == autotune.hw_fingerprint(TPU_V5E, "cpu")
    assert cpu != autotune.hw_fingerprint(SNOWFLAKE, "cpu")
    if torch.cuda.is_available():
        assert autotune.hw_fingerprint(TPU_V5E) != cpu
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            autotune.hw_fingerprint(TPU_V5E)


# --- the tuner: the reference's cases on the port -----------------------------------
def _tuned_cache(tmp_path, top_k=2):
    cache = autotune.TunedCache.load(str(tmp_path / "tuned.json"))
    rep = autotune.tune_cnn(TINY, batch=1, hw=TPU_V5E, cache=cache,
                            top_k=top_k, repeats=1, device="cpu")
    return cache, rep


def test_tune_populates_cache_and_second_pass_hits(tmp_path):
    cache, rep = _tuned_cache(tmp_path)
    assert rep.n_measurements > 0 and cache.entries and rep.error_rows
    # on the CPU every scored candidate is measured (no launch merging)
    assert all(r.measurements == r.candidates > 0 for r in rep.results)
    assert cache.generation() not in ("empty", "none")
    rep2 = autotune.tune_cnn(TINY, batch=1, hw=TPU_V5E, cache=cache,
                             top_k=2, repeats=1, device="cpu")
    assert rep2.n_measurements == 0
    assert all(r.cached for r in rep2.results)
    assert "cached" in rep2.summary()
    again = autotune.TunedCache.load(str(tmp_path / "tuned.json"))
    assert again.entries == cache.entries


def test_tuned_cache_bypasses_analytic_choosers(tmp_path, monkeypatch):
    cache, _ = _tuned_cache(tmp_path)
    view = cache.view(TINY.name, autotune.hw_fingerprint(TPU_V5E, "cpu"), 1)

    def boom(*a, **k):
        raise AssertionError("analytic chooser called despite tuned hit")

    monkeypatch.setattr(schedule, "select_conv_row_strips", boom)
    sched = schedule.compile_model(cnn.to_graph(TINY, 1, 4), TPU_V5E,
                                   tuned=view)
    convs = [ls for ls in sched.layers if ls.kind.value == "conv2d"]
    assert convs and all("tuned" in ls.notes for ls in convs)


def test_tuned_schedule_never_infeasible(tmp_path):
    cache, _ = _tuned_cache(tmp_path, top_k=4)
    view = cache.view(TINY.name, autotune.hw_fingerprint(TPU_V5E, "cpu"), 1)
    sched = schedule.compile_model(cnn.to_graph(TINY, 1, 4), TPU_V5E,
                                   tuned=view)
    for ls in sched.layers:
        if ls.conv_tiling is not None:
            assert ls.conv_tiling.vmem_bytes <= TPU_V5E.vmem_budget()
    plain = schedule.compile_model(cnn.to_graph(TINY, 1, 4), TPU_V5E)
    assert sched.total_traffic_bytes <= plain.total_traffic_bytes


def _entry_point(name: str):
    cfg = get_config(LM)
    return {"cnn.compile_program": lambda: cnn.compile_program(TINY, batch=1),
            "transformer.compile_program": lambda: transformer.compile_program(
                cfg, batch=1, seq=MAX_LEN),
            "transformer.compile_program_pair":
                lambda: transformer.compile_program_pair(
                    cfg, slots=SLOTS, max_len=MAX_LEN)}[name]


@pytest.mark.parametrize("entry", ["cnn.compile_program",
                                   "transformer.compile_program",
                                   "transformer.compile_program_pair"])
def test_generation_change_gives_fresh_programs(entry, tmp_path):
    """The stale-Program repair: activating a cache, and then any change
    of its content, gives a fresh Program from every compile entry
    point; deactivating gives back the untuned memo."""
    compile_ = _entry_point(entry)
    p0 = compile_()
    cache, _ = _tuned_cache(tmp_path)
    autotune.activate(cache, device="cpu")
    try:
        p1 = compile_()
        assert p1 is not p0 and compile_() is p1
        key = next(iter(cache.entries))
        cache.entries[key] = dict(cache.entries[key], measured_time_s=1.0)
        assert compile_() is not p1, "re-tune served a stale Program"
    finally:
        autotune.deactivate()
    assert compile_() is p0
    assert autotune.active_generation() == "none"


@pytest.mark.parametrize("model", ["tiny", "smollm"])
def test_tuned_and_untuned_forwards_agree(model, tmp_path):
    rng = np.random.default_rng(2)
    if model == "tiny":
        params = params_from_numpy(
            numpy_params(jax_cnn.param_defs(JAX_TINY), 1))
        x = torch.from_numpy(rng.standard_normal((1, 16, 16, 4))
                             .astype(np.float32))
        cache, _ = _tuned_cache(tmp_path)

        def forward():
            return cnn.forward(params, x, TINY)
    else:
        cfg, jcfg = get_config(LM), jax_get_config(LM)
        params = params_from_numpy(
            numpy_params(get_model(jcfg).param_defs(jcfg), 1))
        x = torch.from_numpy(rng.integers(0, cfg.vocab, (1, MAX_LEN))
                             .astype(np.int32))
        cache = autotune.TunedCache()
        autotune.tune_lm_decode(cfg, slots=SLOTS, max_len=MAX_LEN,
                                cache=cache, repeats=1, top_k=2,
                                device="cpu")
        pre = autotune.TunedCache()
        autotune.tune_program(
            transformer.compile_program(cfg, batch=1, seq=MAX_LEN),
            _graphs("smollm-prefill")[0], params, x, config_name=LM,
            batch=1, hw=TPU_V5E, cache=pre, repeats=1, top_k=2)
        cache.entries.update(pre.entries)

        def forward():
            return transformer.program_forward(params, x, cfg)
    y0 = forward()
    autotune.activate(cache, device="cpu")
    try:
        y1 = forward()
    finally:
        autotune.deactivate()
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), rtol=1e-5, atol=1e-5)


# --- launch keys: the candidates the card measures once -----------------------------
def test_skinny_matmul_candidates_are_one_launch():
    """Every (dataflow, block) candidate of a decode projection of
    smollm-360m at 8 slots (M = 8: the skinny path) is one launch; the
    admission's (M = 512: wgmma) are not."""
    cfg = get_config("smollm-360m")
    for graph, one in ((transformer.to_decode_graph(cfg, slots=8,
                                                    max_len=512), True),
                       (transformer.to_graph(cfg, batch=1, seq=512,
                                             write_cache=True), False)):
        nodes = [n for n in graph if kernel_kind(n) == "matmul"]
        assert len(nodes) == 225
        for node in {autotune.op_signature(n): n for n in nodes}.values():
            d = node.dims
            keys = {matmul_ops.launch_key(
                d["M"], d["K"], d["N"], torch.bfloat16,
                dataflow=Dataflow(c["dataflow"]), block=tuple(c["block"]),
                b_transposed=node.meta.get("transpose_w", False))
                for c in autotune.enumerate_candidates(node, TPU_V5E)}
            assert (len(keys) == 1) == one, (node.name, len(keys))


def test_decode_blocks_are_one_launch_and_replay_keys_merge():
    """smollm-360m's decode attention at 8 slots: every block_kv one
    launch; on the smoke trace, ``replay.launch_key`` gives one key per
    skinny matmul and decode op over all its candidates, and tells the
    conv candidates apart only by what reaches the kernels."""
    cfg = get_config("smollm-360m")
    node = next(n for n in transformer.to_decode_graph(cfg, slots=8,
                                                       max_len=512)
                if kernel_kind(n) == "decode_attention")
    cands = autotune.enumerate_candidates(node, TPU_V5E)
    assert len(cands) > 1
    assert len({decode_ops.launch_key((8, cfg.n_heads, cfg.hd),
                                      (8, cfg.n_kv_heads, 512, cfg.hd),
                                      torch.bfloat16)}) == 1
    for model in ("smollm-decode", "tiny"):
        nodes = {n.name: n for n in _graphs(model)[0]}
        trace = _port_trace(model)[-1]
        for rec in trace.records:
            if rec.kind not in autotune.TUNABLE:
                continue
            node = nodes[rec.name]
            keys = {}
            for c in autotune.enumerate_candidates(node, TPU_V5E):
                rc = autotune.entry_to_replay_candidate(node, c, TPU_V5E)
                keys.setdefault(replay.launch_key(rec, rc), []).append(c)
            if rec.kind in ("matmul", "decode_attention"):
                assert len(keys) == 1, rec.name
                continue
            # kernels_per_tile reaches no kernel: candidates that differ
            # only in it are one launch
            by_rest = {}
            for key, group in keys.items():
                for c in group:
                    rest = (c["out_rows"], c["strip_storage"], c["dataflow"])
                    by_rest.setdefault(rest, set()).add(key)
            assert all(len(k) == 1 for k in by_rest.values()), rec.name
            # the loop order always reaches the kernels
            assert len(keys) >= 2, rec.name


# --- the CLIs ---------------------------------------------------------------------
def test_autotune_and_replay_clis(tmp_path, capsys):
    path = str(tmp_path / "cache.json")
    argv = ["--config", LM, "--cache", path, "--slots", str(SLOTS),
            "--max-len", str(MAX_LEN), "--device", "cpu", "--repeats", "1",
            "--top-k", "2"]
    assert autotune.main(argv) == 0
    out = capsys.readouterr().out
    assert "tunable ops" in out and "measured_us" in out
    assert autotune.main(argv) == 0
    assert "0 replay measurements" in capsys.readouterr().out
    assert json.load(open(path))["entries"]
    prog, params, x, state, mask, _ = _port_trace("smollm-decode")
    trace = executor.trace_program(prog, params, x, repeats=1, state=state,
                                   mask=mask)
    tpath = str(tmp_path / "t.jsonl")
    trace.save(tpath)
    assert replay.main([tpath, "--json", str(tmp_path / "rows.json")]) == 0
    out = capsys.readouterr().out
    assert "decode_attention" in out and "calibrated_err" in out
    assert json.load(open(tmp_path / "rows.json"))
