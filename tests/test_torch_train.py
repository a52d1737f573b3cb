"""The port's training slice against ``repro``'s, on the same numpy
inputs: the legacy forward + chunked cross-entropy (loss and every
parameter gradient, remat on and off), ``AdamW`` (32 and 8 bits), the
``Trainer`` end to end, checkpoints in both directions, the synthetic
data stream; and the trainer's fault tolerance (resume, NaN abort,
straggler log) and loss reduction inside the port."""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import PackedFileDataset as JPacked  # noqa: E402
from repro.data import SyntheticLM as JSynthetic  # noqa: E402
from repro.models import cross_entropy_loss as jce_loss  # noqa: E402
from repro.models import get_model, init_params as jinit  # noqa: E402
from repro.models.losses import chunked_cross_entropy as jchunked  # noqa
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import cosine_schedule as jcosine  # noqa: E402
from repro.runtime import Trainer as JTrainer  # noqa: E402
from repro.runtime import TrainerConfig as JTrainerConfig  # noqa: E402

from repro_torch.checkpoint import (latest_step, restore_checkpoint,  # noqa
                                    save_checkpoint)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import PackedFileDataset, SyntheticLM  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import build_train_step  # noqa: E402
from repro_torch.models import params_from_numpy, transformer  # noqa: E402
from repro_torch.models.common import cross_entropy_loss  # noqa: E402
from repro_torch.models.losses import chunked_cross_entropy  # noqa: E402
from repro_torch.optim import (AdamW, Q8State, cosine_schedule,  # noqa: E402
                               dequantize_state)
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402

ARCH = "smollm-360m"


@pytest.fixture(scope="module")
def smoke():
    """The smoke config in both packages and one set of weights, made
    by ``repro`` and carried to the port as numpy arrays."""
    jcfg = jget_config(ARCH).smoke()
    api = get_model(jcfg)
    jparams = jinit(api.param_defs(jcfg), jax.random.PRNGKey(0))
    numpy_params = jax.tree.map(np.asarray, jparams)
    return jcfg, api, jparams, get_config(ARCH).smoke(), numpy_params


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def _batch(vocab, B, S, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (B, S)).astype(np.int32),
            rng.integers(0, vocab, (B, S)).astype(np.int32))


# --- forward + loss ----------------------------------------------------------------
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_forward_loss_and_grads_match_repro(smoke, remat):
    """Loss within 1e-5 and every parameter gradient within 1e-5 of its
    largest value, through the chunked CE (chunk 16 of 64 rows)."""
    jcfg, api, jparams, cfg, numpy_params = smoke
    toks, labels = _batch(cfg.vocab, 2, 64, seed=1)

    def jloss(p):
        out = api.forward(p, jnp.asarray(toks), jcfg, impl="reference",
                          remat=remat, return_hidden=True)
        return jchunked(out["hidden"], p["lm_head"], jnp.asarray(labels),
                        chunk=16)
    want_loss, want_grads = jax.value_and_grad(jloss)(jparams)
    params = jax.tree.map(lambda t: t.requires_grad_(),
                          params_from_numpy(numpy_params))
    out = transformer.forward(params, torch.from_numpy(toks), cfg,
                              remat=remat, return_hidden=True)
    loss = chunked_cross_entropy(out["hidden"], params["lm_head"],
                                 torch.from_numpy(labels), chunk=16)
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    got = _flat(params)
    for path, g in _flat(jax.tree.map(np.asarray, want_grads)).items():
        diff = np.abs(got[path].grad.numpy() - g).max()
        assert diff <= 1e-5 * np.abs(g).max(), (path, diff)


def test_forward_logits_match_repro(smoke):
    jcfg, api, jparams, cfg, numpy_params = smoke
    toks, _ = _batch(cfg.vocab, 2, 24, seed=2)
    want = api.forward(jparams, jnp.asarray(toks), jcfg,
                       impl="reference")["logits"]
    with torch.no_grad():
        got = transformer.forward(params_from_numpy(numpy_params),
                                  torch.from_numpy(toks), cfg)
    assert got["logits"].shape == want.shape
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_losses_match_repro(masked):
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 24, 16)).astype(np.float32)
    w = rng.standard_normal((16, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (2, 24)).astype(np.int32)
    mask = (rng.random((2, 24)) < 0.7).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    want = jchunked(jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels),
                    chunk=10, mask=jm)    # 10 halves to 6 (divides 24)
    got = chunked_cross_entropy(torch.from_numpy(h), torch.from_numpy(w),
                                torch.from_numpy(labels), chunk=10, mask=tm)
    assert abs(got.item() - float(want)) <= 1e-5
    logits = h @ w
    want = jce_loss(jnp.asarray(logits), jnp.asarray(labels), jm)
    got = cross_entropy_loss(torch.from_numpy(logits),
                             torch.from_numpy(labels), tm)
    assert abs(got.item() - float(want)) <= 1e-5


def test_forward_refuses_unported_families(smoke):
    """The vlm forward is ported; called without its vision input it is
    refused with the reference's message."""
    cfg = dataclasses.replace(smoke[3], cross_attn_every=2, n_vision_tokens=8)
    with pytest.raises(ValueError, match="vlm arch requires vision_embeds"):
        transformer.forward({}, torch.zeros((1, 4), dtype=torch.int32), cfg)


# --- optimizer ---------------------------------------------------------------------
def _value(x):
    """A moment or param as f32 numpy; 8-bit states dequantized."""
    if isinstance(x, Q8State):
        return dequantize_state(x).numpy()
    if hasattr(x, "scale"):                       # repro's Q8State
        return np.asarray(x.q, np.float32) * np.asarray(x.scale)
    return np.asarray(x)


@pytest.mark.parametrize("bits", [32, 8])
def test_adamw_matches_repro(bits):
    """Five updates with global-norm clipping on, a warm-up + cosine
    schedule, matrices (decayed), a vector and a scalar: params and
    moments within 1e-6 of ``repro``'s after every step."""
    rng = np.random.default_rng(bits)
    params = {"w": (rng.standard_normal((8, 16)) * 0.1).astype(np.float32),
              "b": {"v": rng.standard_normal(16).astype(np.float32)},
              "s": np.float32(0.3)}
    jopt = JAdamW(lr=jcosine(1e-2, warmup=2, total=6), state_bits=bits,
                  grad_clip=0.5)
    topt = AdamW(lr=cosine_schedule(1e-2, warmup=2, total=6),
                 state_bits=bits, grad_clip=0.5)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.tensor, params)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(5):
        grads = jax.tree.map(
            lambda x: rng.standard_normal(np.shape(x)).astype(np.float32),
            params)
        jp, js, jm = jopt.update(jax.tree.map(jnp.asarray, grads), js, jp)
        tp, ts, tm = topt.update(jax.tree.map(torch.tensor, grads), ts, tp)
        for k in ("lr", "grad_norm"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-6 * max(
                1.0, abs(float(jm[k])))
        for want, got in ((jp, tp), (js["m"], ts["m"]), (js["v"], ts["v"])):
            got_flat = _flat(got)
            for path, w in _flat(want).items():
                np.testing.assert_allclose(_value(got_flat[path]), _value(w),
                                           rtol=0, atol=1e-6)
        assert int(ts["step"]) == int(js["step"])


@pytest.mark.parametrize("bits", [32, 8])
def test_adamw_blocked_matches_repro(bits, monkeypatch):
    """The update a block of rows at a time (the path of leaves past
    ``SLICE_ELEMS``), cut here at 64 elements into blocks of 2 rows that
    divide neither leaf: a stacked (3, 5, 16) leaf and a (7, 16) matrix,
    beside a vector and a scalar that stay whole.  ``global_norm`` over
    the blocks within 1e-6 of the whole leaves' sum and of ``repro``'s;
    five updates with clipping on, params and moments within 1e-6 of
    ``repro``'s whole-leaf update (8-bit: the rms clip over the whole
    leaf, the per-row scales of every block).  The update is handed
    ``repro``'s norm: the two packages sum the squares in other orders,
    and at this seed that one-ulp difference in the clip flips an int8
    rounding tie of the 8-bit moments on the whole-leaf path too."""
    from repro.optim import global_norm as jglobal_norm
    from repro_torch.optim import adamw, global_norm
    monkeypatch.setattr(adamw, "SLICE_ELEMS", 64)
    monkeypatch.setattr(adamw, "BLOCK_ELEMS", 32)
    rng = np.random.default_rng(10 + bits)
    params = {"w": (rng.standard_normal((3, 5, 16)) * 0.1).astype(np.float32),
              "e": (rng.standard_normal((7, 16)) * 0.1).astype(np.float32),
              "b": rng.standard_normal(16).astype(np.float32),
              "s": np.float32(0.3)}
    jopt = JAdamW(lr=jcosine(1e-2, warmup=2, total=6), state_bits=bits,
                  grad_clip=0.5)
    topt = AdamW(lr=cosine_schedule(1e-2, warmup=2, total=6),
                 state_bits=bits, grad_clip=0.5)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.tensor, params)
    js, ts = jopt.init(jp), topt.init(tp)
    assert [len(adamw._parts(tp[k])) for k in ("w", "e", "b", "s")] == [
        8, 4, 1, 1]
    # Each entry a steady gradient over two decades, each row's first
    # column +-100 by turns: that column's v sets the row's int8 scale
    # while its m cancels, so small entries keep an m and lose their v,
    # and the 8-bit update's rms clip engages.
    steady = jax.tree.map(lambda x: np.sign(rng.standard_normal(
        np.shape(x))) * 10.0 ** rng.uniform(-2, 0, np.shape(x)), params)

    def turn(g, i):
        g = g.copy()
        if g.ndim:
            g[..., 0] = 100.0 * (-1) ** i
        return g.astype(np.float32)
    for i in range(5):
        grads = jax.tree.map(lambda g: turn(g, i), steady)
        tg = jax.tree.map(torch.tensor, grads)
        jg = jax.tree.map(jnp.asarray, grads)
        norm, jnorm = float(global_norm(tg)), float(jglobal_norm(jg))
        whole = float(torch.sqrt(sum(torch.sum(torch.square(t))
                                     for t in tg.values())))
        assert abs(norm - whole) <= 1e-6 * whole
        assert abs(norm - jnorm) <= 1e-6 * jnorm
        monkeypatch.setattr(adamw, "global_norm", lambda tree, n=jnorm: (
            torch.tensor(n, dtype=torch.float32)))
        jp, js, jm = jopt.update(jg, js, jp)
        tp, ts, tm = topt.update(tg, ts, tp)
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= 1e-6
        for want, got in ((jp, tp), (js["m"], ts["m"]), (js["v"], ts["v"])):
            got_flat = _flat(got)
            for path, w in _flat(want).items():
                np.testing.assert_allclose(_value(got_flat[path]), _value(w),
                                           rtol=0, atol=1e-6)
        assert int(ts["step"]) == int(js["step"])


# --- trainer -----------------------------------------------------------------------
def test_trainer_three_steps_match_repro(smoke, tmp_path):
    """Three Trainer steps of the smoke config from the same weights and
    the same SyntheticLM batches: losses within 1e-4 relative."""
    jcfg, api, jparams, cfg, numpy_params = smoke
    jopt = JAdamW(lr=jcosine(3e-3, warmup=1, total=3))

    def jstep(params, opt_state, batch):
        def loss_fn(p):
            out = api.forward(p, batch["tokens"], jcfg, impl="reference",
                              return_hidden=True)
            return jchunked(out["hidden"], p["lm_head"], batch["labels"])
        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, opt_state, m = jopt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, **m}

    data = dict(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=5)
    jtr = JTrainer(jax.jit(jstep), JSynthetic(**data), JTrainerConfig(
        total_steps=3, ckpt_every=100, ckpt_dir=str(tmp_path / "jax"),
        log_every=1))
    jtr.run(jparams, jopt.init(jparams))
    topt = AdamW(lr=cosine_schedule(3e-3, warmup=1, total=3))
    params = params_from_numpy(numpy_params)
    ttr = Trainer(build_train_step(cfg, topt), SyntheticLM(**data),
                  TrainerConfig(total_steps=3, ckpt_every=100,
                                ckpt_dir=str(tmp_path / "torch"),
                                log_every=1), device="cpu")
    _, _, step = ttr.run(params, topt.init(params))
    assert step == 3
    want = [r["loss"] for r in jtr.metrics_history]
    got = [r["loss"] for r in ttr.metrics_history]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[2] != got[0]


def _tiny_trainer(tmp_path, total_steps, straggler=None, step_fn=None):
    """A one-vector "model" pulled toward the batch's first tokens."""
    import time as _t
    calls = {"n": 0}

    def step(params, opt_state, batch):
        calls["n"] += 1
        if straggler is not None and calls["n"] == straggler:
            _t.sleep(0.35)
        p = params - 0.1 * (params - batch["tokens"][0, :4].float())
        return p, opt_state, {"loss": torch.sum(p ** 2)}

    data = SyntheticLM(vocab=10, seq_len=8, global_batch=2, seed=0)
    tr = Trainer(step_fn or step, data, TrainerConfig(
        total_steps=total_steps, ckpt_every=5, ckpt_dir=str(tmp_path),
        log_every=1, straggler_factor=3.0, max_nan_steps=3), device="cpu")
    return tr, torch.zeros(4)


def test_trainer_checkpoint_restart(tmp_path):
    tr, w0 = _tiny_trainer(tmp_path, 7)
    p1, _, s1 = tr.run(w0, {"n": torch.zeros((), dtype=torch.int32)})
    assert s1 == 7
    assert latest_step(str(tmp_path)) == 7        # final forced ckpt
    # a restart continues (does not restart) the run, from the saved state
    tr2, _ = _tiny_trainer(tmp_path, 7)
    p2, _, s2 = tr2.run(w0, {"n": torch.zeros((), dtype=torch.int32)})
    assert s2 == 7 and not tr2.metrics_history and torch.equal(p1, p2)
    tr3, _ = _tiny_trainer(tmp_path, 12)
    _, _, s3 = tr3.run(w0, {"n": torch.zeros((), dtype=torch.int32)})
    assert s3 == 12
    assert tr3.metrics_history[0]["step"] == 7


def test_trainer_straggler_detection(tmp_path):
    tr, w0 = _tiny_trainer(tmp_path, 20, straggler=15)
    tr.run(w0, {})
    assert "straggler" in [a["kind"] for a in tr.anomalies]


def test_trainer_nan_abort(tmp_path):
    def bad_step(params, opt_state, batch):
        return params, opt_state, {"loss": torch.tensor(float("nan"))}
    tr, w0 = _tiny_trainer(tmp_path, 50, step_fn=bad_step)
    with pytest.raises(FloatingPointError):
        tr.run(w0, {})
    assert [a["kind"] for a in tr.anomalies] == ["nan"] * 3


def test_trainer_preemption_checkpoints_and_restores_handlers(tmp_path):
    """SIGTERM mid-run: the in-flight step finishes, a checkpoint is
    forced at that step, and the process's own handler is back after
    ``run`` returns."""
    import signal
    mine = lambda signum, frame: None  # noqa: E731
    before = signal.signal(signal.SIGTERM, mine)
    calls = {"n": 0}

    def step(params, opt_state, batch):
        calls["n"] += 1
        if calls["n"] == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return params + 1, opt_state, {"loss": params.sum()}
    try:
        tr, w0 = _tiny_trainer(tmp_path, 50, step_fn=step)
        p, _, s = tr.run(w0, {})
        assert s == 3 and calls["n"] == 3
        assert latest_step(str(tmp_path)) == 3
        assert torch.equal(p, torch.full((4,), 3.0))
        assert signal.getsignal(signal.SIGTERM) is mine
    finally:
        signal.signal(signal.SIGTERM, before)


def test_trainer_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(lambda *a: a, None, TrainerConfig(ckpt_dir=str(tmp_path)))


def test_training_reduces_loss(smoke, tmp_path):
    """The port's counterpart of tests/test_system.py's: 80 steps of the
    smoke config on the structured synthetic stream cut the loss by 30%
    (the reference's schedule and data)."""
    _, _, _, cfg, numpy_params = smoke
    opt = AdamW(lr=cosine_schedule(3e-3, warmup=5, total=80))
    params = params_from_numpy(numpy_params)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=1)
    tr = Trainer(build_train_step(cfg, opt), data, TrainerConfig(
        total_steps=80, ckpt_every=40, ckpt_dir=str(tmp_path),
        log_every=10), device="cpu")
    tr.run(params, opt.init(params))
    first = tr.metrics_history[0]["loss"]
    last = tr.metrics_history[-1]["loss"]
    assert last < first * 0.7, f"loss {first} -> {last}"


def test_train_cli_runs_on_cpu(tmp_path, capsys):
    res = train.main(["--arch", ARCH, "--smoke", "--steps", "3", "--seq",
                      "32", "--batch", "2", "--device", "cpu",
                      "--ckpt-dir", str(tmp_path), "--opt-bits", "8"])
    out = capsys.readouterr().out
    assert res["step"] == 3 and "finished at step 3" in out
    assert out.count("tokens/s") == 3
    assert latest_step(str(tmp_path)) == 3
    assert all(np.isfinite(r["loss"]) for r in res["trainer"].metrics_history)


# --- checkpoints -------------------------------------------------------------------
def _mixed_tree():
    rng = np.random.default_rng(9)
    return {"w": rng.standard_normal((3, 5)).astype(np.float32),
            "emb": {"bf": rng.standard_normal((4, 6)).astype(np.float32)},
            "step": np.int32(17),
            "ids": (rng.integers(-9, 9, 7).astype(np.int32),
                    rng.integers(0, 9, 2).astype(np.int8))}


def _bits(t):
    t = torch.as_tensor(t)
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_checkpoint_from_repro_restores_bit_for_bit(tmp_path):
    tree = _mixed_tree()
    jtree = jax.tree.map(jnp.asarray, tree)
    jtree["emb"]["bf"] = jtree["emb"]["bf"].astype(jnp.bfloat16)
    jstore.save_checkpoint(str(tmp_path), 4, jtree)
    like = jax.tree.map(torch.as_tensor, tree)
    like["emb"]["bf"] = like["emb"]["bf"].bfloat16()
    got, step = restore_checkpoint(str(tmp_path), like)
    assert step == 4
    want = jax.tree.map(np.asarray, jtree)
    assert got["emb"]["bf"].dtype == torch.bfloat16
    assert np.array_equal(_bits(got["emb"]["bf"]).numpy(),
                          want["emb"]["bf"].view(np.int16))
    assert torch.equal(got["w"], torch.from_numpy(want["w"]))
    assert int(got["step"]) == 17 and got["step"].dtype == torch.int32
    for g, w in zip(got["ids"], want["ids"]):
        assert torch.equal(g, torch.from_numpy(w))


def test_checkpoint_from_port_restores_into_repro_bit_for_bit(tmp_path):
    tree = jax.tree.map(torch.as_tensor, _mixed_tree())
    tree["emb"]["bf"] = tree["emb"]["bf"].bfloat16()
    save_checkpoint(str(tmp_path), 6, tree)
    like = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.float32), tree)
    got, step = jstore.restore_checkpoint(str(tmp_path), like)
    assert step == 6
    assert str(got["emb"]["bf"].dtype) == "bfloat16"
    assert np.array_equal(np.asarray(got["emb"]["bf"]).view(np.int16),
                          _bits(tree["emb"]["bf"]).numpy())
    assert np.array_equal(got["w"], tree["w"].numpy())
    assert got["step"].dtype == np.int32 and int(got["step"]) == 17
    for g, w in zip(got["ids"], tree["ids"]):
        assert g.dtype == w.numpy().dtype and np.array_equal(g, w.numpy())


def test_train_state_checkpoint_is_readable_by_repro(smoke, tmp_path):
    """(params, 8-bit AdamW state) saved by the port restores into
    ``repro``'s own (params, state) structure leaf for leaf: the leaf
    order (sorted keys, Q8State as (q, scale)) is the same."""
    jcfg, api, jparams, cfg, numpy_params = smoke
    params = params_from_numpy(numpy_params)
    opt = AdamW(state_bits=8)
    state = opt.init(params)
    grads = jax.tree.map(lambda t: torch.ones_like(t), params)
    params, state, _ = opt.update(grads, state, params)
    save_checkpoint(str(tmp_path), 1, (params, state))
    jopt = JAdamW(state_bits=8)
    (jp, js), step = jstore.restore_checkpoint(
        str(tmp_path), (jparams, jopt.init(jparams)))
    assert step == 1 and int(js["step"]) == 1
    for path, w in _flat(jax.tree.map(np.asarray, jp)).items():
        assert np.array_equal(w, _flat(params)[path].numpy()), path
    got_m = _flat(state["m"])
    for path, w in _flat(js["m"]).items():
        assert np.array_equal(np.asarray(w.q), got_m[path].q.numpy()), path
        assert np.array_equal(np.asarray(w.scale), got_m[path].scale.numpy())
    # and back: repro's copy restores into the port equal to what it saved
    jstore.save_checkpoint(str(tmp_path / "back"), 2, (jp, js))
    (p2, s2), _ = restore_checkpoint(str(tmp_path / "back"), (params, state))
    for path, t in _flat(p2).items():
        assert torch.equal(_bits(t), _bits(_flat(params)[path])), path
    assert torch.equal(s2["v"]["embed"].q, state["v"]["embed"].q)


def test_checkpoint_atomicity_and_gc(tmp_path):
    d = str(tmp_path)
    tree = {"x": torch.zeros((2,))}
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(d, s, tree, keep=2)
    steps = sorted(int(n[5:]) for n in os.listdir(d) if n.startswith("step_"))
    assert steps == [4, 5]
    os.makedirs(os.path.join(d, "step_00000099", "arrays"))
    assert latest_step(d) == 5                  # no COMMITTED marker
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(d, {"x": torch.zeros(2), "y": torch.zeros(1)})


# --- data --------------------------------------------------------------------------
@pytest.mark.parametrize("step,host,n_hosts", [(0, 0, 1), (5, 0, 1),
                                               (5, 1, 2)])
def test_synthetic_batches_equal_repro(step, host, n_hosts):
    kw = dict(vocab=97, seq_len=24, global_batch=4, seed=3)
    want = JSynthetic(**kw).batch_at(step, host, n_hosts)
    got = SyntheticLM(**kw).batch_at(step, host, n_hosts)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_packed_file_batches_equal_repro(tmp_path):
    path = tmp_path / "tokens.bin"
    np.arange(1000, dtype=np.uint16).tofile(path)
    want = JPacked(str(path), 500, 16, 4).batch_at(3)
    got = PackedFileDataset(str(path), 500, 16, 4).batch_at(3)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k], want[k])


def test_serve_cli_loads_trained_params(tmp_path, capsys):
    """``launch.serve --ckpt`` serves the params ``launch.train`` saved,
    and the served streams are those of the trained weights."""
    from repro_torch.launch import serve
    res = train.main(["--arch", ARCH, "--smoke", "--steps", "2", "--seq",
                      "16", "--batch", "2", "--device", "cpu",
                      "--ckpt-dir", str(tmp_path)])
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--slots", "2",
            "--max-len", "32", "--requests", "2", "--max-new", "3"]
    served = serve.main(args + ["--ckpt", str(tmp_path)])
    assert "restored params from step 2" in capsys.readouterr().out
    for path, t in _flat(served["engine"].params).items():
        assert torch.equal(t, _flat(res["params"])[path]), path
    fresh = serve.main(args)
    assert not torch.equal(fresh["engine"].params["embed"],
                           served["engine"].params["embed"])
