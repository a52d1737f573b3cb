"""The port's MoE family (``models/moe.py``, the MoE parts of
``models/transformer.py``, the executor's ``moe_dispatch`` arm and the
train step's load-balance term) against ``repro``'s, on the same numpy
weights and tokens: configs and parameter trees, ``moe_mlp`` with and
without ``valid_count`` and with tokens dropped past capacity, the
legacy forward's logits and aux (granite: an MoE layer each; llama4:
one every second layer), the Program listings at full size, prefill and
decode runs, engine streams, three ``Trainer`` steps, and the serve and
train CLIs on the CPU.  f32 smoke configs, held to 1e-5; a Program run
through the graphed runners (``test_torch_graphs``' CPU stand-in for
CUDA graphs) bitwise against the eager one."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.models import get_model  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.models.losses import chunked_cross_entropy as jchunked  # noqa
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import cosine_schedule as jcosine  # noqa: E402
from repro.runtime import Trainer as JTrainer  # noqa: E402
from repro.runtime import TrainerConfig as JTrainerConfig  # noqa: E402
from repro.runtime import executor as jax_executor  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.data import SyntheticLM as JSynthetic  # noqa: E402

from repro_torch.configs import REGISTRY, get_config  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.steps import AUX_LOSS_WEIGHT, build_train_step  # noqa
from repro_torch.models import moe, param_defs, params_from_numpy  # noqa
from repro_torch.models import transformer, tree_paths  # noqa: E402
from repro_torch.optim import AdamW, cosine_schedule  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig, executor  # noqa
from repro_torch.serving import Request, ServingEngine  # noqa: E402

from test_torch_cnn import _jax_tree, numpy_params  # noqa: E402
from test_torch_compiler import _plain  # noqa: E402
from test_torch_graphs import graphs  # noqa: E402,F401

TOL = 1e-5          # f32, same math; sums in another order
MOE = ["granite-moe-1b-a400m", "llama4-maverick-400b-a17b"]
GRANITE = MOE[0]


def _cfgs(name, full=False):
    cfg, jcfg = REGISTRY[name], JAX_REGISTRY[name]
    return (cfg, jcfg) if full else (cfg.smoke(), jcfg.smoke())


def _params(jcfg, seed):
    tree = numpy_params(jax_tf.param_defs(jcfg), seed)
    return params_from_numpy(tree), _jax_tree(tree)


def _close(ours, ref, tol=TOL):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=0, atol=tol)


def _padded(prompt, max_len):
    padded = np.zeros((1, max_len), np.int32)
    padded[0, :len(prompt)] = prompt
    return padded


# --- configs and parameter trees --------------------------------------------------
@pytest.mark.parametrize("name", MOE)
def test_config_and_param_defs_match_reference(name):
    """The configs field for field (full and smoke), the analytic
    parameter counts, and the ParamDef trees leaf for leaf: the all-MoE
    layout (granite's experts stacked in "blocks") and the interleaved
    one (llama4's "blocks" + "moe_blocks")."""
    for full in (True, False):
        cfg, jcfg = _cfgs(name, full)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.n_params() == jcfg.n_params()
        ours, ref = transformer.param_defs(cfg), jax_tf.param_defs(jcfg)
        assert ours == param_defs(cfg)
        assert tree_paths(ours) == tree_paths(ref)
        for path in tree_paths(ours):
            a, b = ours, ref
            for part in path.split("/"):
                a, b = a[part], b[part]
            assert (a.shape, a.axes, a.init) == (b.shape, b.axes, b.init)
            assert a.dtype == cfg.tdtype
    assert get_config(name + "-smoke") == _cfgs(name)[0]
    assert ("moe_blocks" in ours) == (cfg.moe_every > 1)


# --- moe_mlp ------------------------------------------------------------------------
# (tokens, experts, top_k, capacity factor, valid_count, gated)
MLP_CASES = {
    "plain": (24, 4, 2, 1.25, None, True),
    "valid_count": (24, 4, 2, 1.25, 13, True),
    "dropping": (40, 4, 2, 0.5, None, True),
    "dropping-valid_count": (40, 4, 2, 0.5, 29, True),
    "top1-ungated": (24, 8, 1, 1.25, 17, False),
}


@pytest.mark.parametrize("case", sorted(MLP_CASES))
def test_moe_mlp_matches_reference(case):
    """Outputs, lb_loss, imbalance and the dropped share within 1e-5 of
    ``repro``'s single-device dispatch; the dropping cases drop real
    rows past capacity."""
    T, E, k, cf, vc, gated = MLP_CASES[case]
    D, F = 16, 32
    rng = np.random.default_rng(len(case))
    x = rng.standard_normal((T, D)).astype(np.float32)
    ws = [(rng.standard_normal(s) * s[-2] ** -0.5).astype(np.float32)
          for s in ((D, E), (E, D, F), (E, D, F), (E, F, D))]
    kw = dict(top_k=k, capacity_factor=cf, gated=gated)
    want, jaux = jax_moe.moe_mlp(
        jnp.asarray(x), *map(jnp.asarray, ws), **kw,
        valid_count=None if vc is None else jnp.asarray(vc, jnp.int32))
    got, aux = moe.moe_mlp(torch.from_numpy(x), *map(torch.from_numpy, ws),
                           **kw, valid_count=vc)
    _close(got, want)
    assert sorted(aux) == sorted(jaux)
    for key in aux:
        _close(aux[key], jaux[key], tol=TOL * max(1.0, abs(float(jaux[key]))))
    pad = 0.0 if vc is None else (T - vc) / T     # pad rows drop too
    assert (float(aux["dropped_frac"]) > pad + 1e-6) == case.startswith(
        "dropping")
    # a (1,) int tensor, the graphed prefill's form, gives the same bits
    if vc is not None:
        again, _ = moe.moe_mlp(torch.from_numpy(x),
                               *map(torch.from_numpy, ws), **kw,
                               valid_count=torch.tensor([vc],
                                                        dtype=torch.int32))
        assert torch.equal(again, got)


def test_moe_mlp_pad_rows_claim_no_capacity():
    """The real rows of a right-padded block route and combine as the
    unpadded block's do: padding does not change their outputs."""
    rng = np.random.default_rng(5)
    T, n, D, E, F = 32, 11, 16, 4, 24
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    ws = [torch.from_numpy((rng.standard_normal(s) * 0.3).astype(np.float32))
          for s in ((D, E), (E, D, F), (E, D, F), (E, F, D))]
    padded, _ = moe.moe_mlp(x, *ws, top_k=2, valid_count=n)
    alone, _ = moe.moe_mlp(x[:n], *ws, top_k=2)
    torch.testing.assert_close(padded[:n], alone, rtol=0, atol=TOL)


# --- the legacy forward ---------------------------------------------------------------
@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_forward_logits_and_aux_match_reference(name, remat):
    cfg, jcfg = _cfgs(name)
    params, jparams = _params(jcfg, seed=1)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 12))
    want = get_model(jcfg).forward(jparams, jnp.asarray(toks, jnp.int32),
                                   jcfg, impl="reference", remat=remat)
    with torch.no_grad():
        got = transformer.forward(params, torch.from_numpy(toks), cfg,
                                  remat=remat)
    _close(got["logits"], want["logits"])
    assert sorted(got["aux"]) == sorted(want["aux"]) == [
        "dropped_frac", "imbalance_pct", "lb_loss"]
    for key, v in got["aux"].items():
        _close(v, want["aux"][key], tol=TOL * max(1.0, abs(float(v))))


# --- Program lowering ------------------------------------------------------------------
CASES = [(name, full) for name in MOE for full in (False, True)]


@pytest.mark.parametrize("name,full", CASES,
                         ids=[f"{n}-{'full' if f else 'smoke'}"
                              for n, f in CASES])
def test_program_pair_listing_and_plans_match_reference(name, full):
    """The serving pair at the served geometry (8 slots, max_len 512)
    at full size, (2, 16) at smoke: listings byte for byte, plans and
    ops field for field, and the pair's chunk blocker."""
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
    n_moe = cfg.n_layers // cfg.moe_every
    for prog in (ours.prefill, ours.decode):
        assert sum(op.kernel == "moe_dispatch" for op in prog.ops) == n_moe


@pytest.mark.parametrize("name", MOE)
def test_stateless_program_matches_reference(name):
    cfg, jcfg = _cfgs(name)
    params, jparams = _params(jcfg, seed=3)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 8))
    ours = transformer.program_forward(params, torch.from_numpy(toks), cfg)
    ref = jax_tf.program_forward(jparams, jnp.asarray(toks, jnp.int32), jcfg,
                                 impl="reference")
    assert transformer.compile_program(cfg, 2, 8).listing() == \
        jax_tf.compile_program(jcfg, 2, 8).listing()
    _close(ours, ref)


@pytest.mark.parametrize("name", MOE)
def test_prefill_and_decode_match_reference(name):
    """Prefill both slots (the prompts' lengths as ``valid_count``),
    then 10 teacher-forced decode ticks with slot 1 dead for the last
    3: logits at every step, the KV caches and the lengths within 1e-5
    of ``repro``'s executor."""
    cfg, jcfg = _cfgs(name)
    slots, max_len = 2, 16
    params, jparams = _params(jcfg, seed=5)
    pair = transformer.compile_program_pair(cfg, slots=slots,
                                            max_len=max_len)
    jpair = jax_tf.compile_program_pair(jcfg, slots=slots, max_len=max_len)
    state = executor.init_program_state(pair, "cpu")
    jstate = jax_executor.init_program_state(jpair)
    jpre = jax_executor.jitted_prefill_runner(jpair.prefill, impl="reference")
    jdec = jax_executor.jitted_decode_runner(jpair.decode, impl="reference")
    rng = np.random.default_rng(6)
    last = np.zeros((slots,), np.int32)
    for slot, n in enumerate((5, 11)):
        padded = _padded(rng.integers(0, cfg.vocab, size=n), max_len)
        ours = executor.run_prefill(pair.prefill, params,
                                    torch.from_numpy(padded), state, slot, n)
        ref, jstate = jpre(jparams, jnp.asarray(padded), jstate, slot, n)
        _close(ours, ref)
        last[slot] = int(np.argmax(np.asarray(ref)[0, n - 1]))
    mask = np.ones((slots,), bool)
    for step in range(10):
        if step == 7:
            mask[1] = False
        ours = executor.run_decode(pair.decode, params,
                                   torch.from_numpy(last), state,
                                   torch.from_numpy(mask))
        ref, jstate = jdec(jparams, jnp.asarray(last), jstate,
                           jnp.asarray(mask))
        live = np.flatnonzero(mask)
        _close(ours[live], np.asarray(ref)[live])
        last = np.argmax(np.asarray(ref), axis=-1).astype(np.int32)
    np.testing.assert_array_equal(state.lengths.numpy(),
                                  np.asarray(jstate.lengths))
    for rid, buf in state.caches.items():
        _close(buf, jstate.caches[rid])


def test_graphed_runs_equal_the_int_form_bit_for_bit(graphs):
    """granite's prefill (``valid_count`` a (1,) tensor inside the
    capture) and decode through the graphed runners and the CPU
    stand-in, against ``run_prefill`` / ``run_decode`` with int scalars
    on a twin state: logits and state bitwise equal, the second call of
    each shape captured."""
    cfg, jcfg = _cfgs(GRANITE)
    params, _ = _params(jcfg, seed=7)
    pair = transformer.compile_program_pair(cfg, slots=2, max_len=16)
    state = executor.init_program_state(pair, "cpu")
    twin = executor.init_program_state(pair, "cpu")
    pre = executor.graphed_prefill_runner(pair.prefill)
    dec = executor.graphed_decode_runner(pair.decode)
    rng = np.random.default_rng(8)
    for slot, n in enumerate((4, 9)):
        padded = torch.from_numpy(
            _padded(rng.integers(0, cfg.vocab, size=n), 16))
        assert torch.equal(pre(params, padded, state, slot, n),
                           executor.run_prefill(pair.prefill, params, padded,
                                                twin, slot, n))
    for step in range(4):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=2)
                                .astype(np.int32))
        mask = torch.tensor([True, step < 2])
        assert torch.equal(dec(params, toks, state, mask),
                           executor.run_decode(pair.decode, params, toks,
                                               twin, mask))
    assert torch.equal(state.lengths, twin.lengths)
    assert all(torch.equal(b, twin.caches[r]) for r, b in state.caches.items())
    assert [g.replays for g in graphs] == [1, 3]


# --- serving ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", MOE)
def test_engine_streams_match_reference_engine(name):
    """Greedy streams identical to ``repro``'s ``ServingEngine(
    use_program=True)`` (the same admissions in the same order, so the
    same batch composition and ``valid_count`` at every call), more
    requests than slots, one prompt longer than max_len."""
    cfg, jcfg = _cfgs(name)
    params, jparams = _params(jcfg, seed=10)
    slots, max_len, max_new = 2, 16, 7
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
    assert ours.n_prefills == len(prompts) and ours.n_prefill_recomputes == 0
    assert ours.n_decode_ticks == ref.n_decode_ticks


def test_chunked_prefill_and_speculation_are_refused_as_in_reference():
    """MoE routing buckets the whole prompt, so a chunk boundary would
    re-bucket it: the pair names its blocker and the engine refuses
    ``chunk_size``, as ``repro``'s does."""
    cfg, jcfg = _cfgs(GRANITE)
    params, _ = _params(jcfg, seed=12)
    pair = transformer.compile_program_pair(cfg, slots=2, max_len=16)
    jpair = jax_tf.compile_program_pair(jcfg, slots=2, max_len=16)
    assert pair.chunk_blocker == jpair.chunk_blocker is not None
    with pytest.raises(ValueError, match="not chunkable"):
        ServingEngine(cfg, params, slots=2, max_len=16, device="cpu",
                      chunk_size=4)
    assert not pair.caps.speculatable and pair.caps.paged


def test_serve_and_train_clis_run_granite_on_cpu(tmp_path, capsys):
    res = serve.main(["--arch", GRANITE, "--smoke", "--device", "cpu",
                      "--slots", "2", "--requests", "3", "--max-new", "3",
                      "--max-len", "16"])
    assert len(res["done"]) == 3 and res["engine"].n_prefills == 3
    assert all(len(r.out_tokens) == 3 for r in res["done"])
    out = train.main(["--arch", GRANITE, "--smoke", "--steps", "2", "--seq",
                      "16", "--batch", "2", "--device", "cpu",
                      "--ckpt-dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert "program pair granite-moe-1b-a400m-smoke" in text
    assert out["step"] == 2 and text.count("moe imbalance") == 2
    hist = out["trainer"].metrics_history
    assert all(np.isfinite(r["loss"]) and "moe_imbalance_pct" in r
               for r in hist)


# --- training ---------------------------------------------------------------------------
def test_trainer_three_steps_with_the_lb_term_match_reference(tmp_path):
    """Three ``Trainer`` steps of granite smoke from the same weights and
    SyntheticLM batches, the loss carrying ``AUX_LOSS_WEIGHT`` x the
    MoE load-balance loss: losses, gradient norms and imbalance within
    1e-5 of ``repro``'s step (``launch/steps.py``'s single-device
    body)."""
    cfg, jcfg = _cfgs(GRANITE)
    params, jparams = _params(jcfg, seed=13)
    api = get_model(jcfg)
    jopt = JAdamW(lr=jcosine(3e-3, warmup=1, total=3))

    def jstep(p, opt_state, batch):
        def loss_fn(q):
            out = api.forward(q, batch["tokens"], jcfg, impl="reference",
                              return_hidden=True)
            loss = jchunked(out["hidden"], q["lm_head"], batch["labels"])
            return loss + AUX_LOSS_WEIGHT * out["aux"]["lb_loss"], out["aux"]
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        p, opt_state, m = jopt.update(grads, opt_state, p)
        return p, opt_state, {"loss": loss, **m,
                              "moe_imbalance_pct": aux["imbalance_pct"]}

    data = dict(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=5)
    jtr = JTrainer(jax.jit(jstep), JSynthetic(**data), JTrainerConfig(
        total_steps=3, ckpt_every=100, ckpt_dir=str(tmp_path / "jax"),
        log_every=1))
    jtr.run(jparams, jopt.init(jparams))
    topt = AdamW(lr=cosine_schedule(3e-3, warmup=1, total=3))
    ttr = Trainer(build_train_step(cfg, topt), SyntheticLM(**data),
                  TrainerConfig(total_steps=3, ckpt_every=100,
                                ckpt_dir=str(tmp_path / "torch"),
                                log_every=1), device="cpu")
    _, _, step = ttr.run(params, topt.init(params))
    assert step == 3
    for key in ("loss", "grad_norm", "lr", "moe_imbalance_pct"):
        want = [r[key] for r in jtr.metrics_history]
        got = [r[key] for r in ttr.metrics_history]
        np.testing.assert_allclose(got, want, rtol=TOL, atol=0)
    losses = [r["loss"] for r in ttr.metrics_history]
    assert losses[2] != losses[0]
