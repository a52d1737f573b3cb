"""Training the families with an extra input -- audio (whisper, its
``encoder_frames``) and the vlm (llama-3.2-vision, its
``vision_embeds``) -- through the port's entry points against
``repro``'s, on the same numpy weights and inputs, the vlm's cross gates
non-zero (``repro`` initialises them to zero, and tanh(0) = 0 would
leave every cross weight's gradient zero on both sides): loss and every
gradient, remat off and on; three ``Trainer`` steps with a data wrapper
that adds the seeded extra input to each batch; the graphed step keyed
on and reading each batch's extra input (through the CUDA-graph
stand-in); the CLI's refusal.  f32 smoke configs on the CPU."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.data import SyntheticLM as JSynthetic  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models.losses import chunked_cross_entropy as jchunked  # noqa
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import cosine_schedule as jcosine  # noqa: E402
from repro.runtime import Trainer as JTrainer  # noqa: E402
from repro.runtime import TrainerConfig as JTrainerConfig  # noqa: E402

from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import (build_train_step,  # noqa: E402
                                     loss_and_grads, step_key)
from repro_torch.models import get_model, params_from_numpy  # noqa: E402
from repro_torch.optim import AdamW, cosine_schedule  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig, executor  # noqa

from test_torch_cnn import numpy_params  # noqa: E402
from test_torch_graphs import graphs  # noqa: E402,F401

ARCHS = ("whisper-base", "llama-3.2-vision-11b")
TOL = 1e-5
# Nonzero cross gates, the same on both sides.
GATES = (0.8, -0.6)


def _setup(arch, seed=0):
    cfg, jcfg = REGISTRY[arch].smoke(), JAX_REGISTRY[arch].smoke()
    tree = numpy_params(jax_get_model(jcfg).param_defs(jcfg), seed)
    if "cross_blocks" in tree:
        tree["cross_blocks"]["gate"] = np.asarray(GATES, np.float32)
    return cfg, jcfg, tree


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def _extra_shape(cfg, batch):
    rows = cfg.n_vision_tokens if cfg.family == "vlm" else cfg.encoder_seq
    return (batch, rows, cfg.d_model)


class WithExtra:
    """A token stream whose batches also carry the family's extra input,
    drawn with numpy from the step and ``seed``."""

    def __init__(self, data, cfg, seed):
        self.data, self.seed = data, seed
        self.name = get_model(cfg).extra_input
        self.shape = _extra_shape(cfg, data.global_batch)

    def batch_at(self, step, *args):
        batch = dict(self.data.batch_at(step, *args))
        rng = np.random.default_rng((self.seed, step))
        batch[self.name] = rng.standard_normal(self.shape).astype(np.float32)
        return batch


def _jax_step_loss(jcfg, remat=False):
    """``repro``'s step body (``repro/launch/steps.py:212, 220-233``):
    the forward with the batch's extra input and ``return_hidden``, the
    chunked cross-entropy against the head, ``impl="reference"``."""
    api = jax_get_model(jcfg)

    def loss_fn(p, batch):
        out = api.forward(p, batch["tokens"], jcfg, impl="reference",
                          remat=remat, return_hidden=True,
                          **{api.extra_input: batch[api.extra_input]})
        head = p["embed"].T if jcfg.tie_embeddings else p["lm_head"]
        return jchunked(out["hidden"], head, batch["labels"])
    return loss_fn


def _batch(cfg, seed, B=2, S=16):
    data = WithExtra(SyntheticLM(vocab=cfg.vocab, seq_len=S, global_batch=B,
                                 seed=seed), cfg, seed)
    return data.batch_at(0)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_repro(arch, remat):
    """Loss within 1e-5 and every gradient within 1e-5 of its largest
    value, the encoder's and the cross blocks' (gate included) too."""
    cfg, jcfg, tree = _setup(arch)
    batch = _batch(cfg, 1)
    want_loss, want = jax.value_and_grad(_jax_step_loss(jcfg, remat))(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = loss_and_grads(
        cfg, params_from_numpy(tree),
        {k: torch.from_numpy(v) for k, v in batch.items()}, remat=remat)
    assert abs(float(loss) - float(want_loss)) <= TOL
    got = _flat(grads)
    for path, g in _flat(jax.tree.map(np.asarray, want)).items():
        assert np.abs(g).max() > 0, path            # every leaf reached
        diff = np.abs(got[path].numpy() - g).max()
        assert diff <= TOL * np.abs(g).max(), (path, diff)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_three_steps_match_repro(arch, tmp_path):
    """Three ``Trainer`` steps from the same weights, both trainers fed
    by the same wrapper (tokens, labels and the seeded extra input):
    losses within 1e-4 relative of ``repro``'s."""
    cfg, jcfg, tree = _setup(arch)
    jopt = JAdamW(lr=jcosine(3e-3, warmup=1, total=3))
    loss_fn = _jax_step_loss(jcfg)

    def jstep(params, opt_state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        params, opt_state, m = jopt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, **m}

    data = dict(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=5)
    jparams = jax.tree.map(jnp.asarray, tree)
    jtr = JTrainer(jax.jit(jstep), WithExtra(JSynthetic(**data), cfg, 6),
                   JTrainerConfig(total_steps=3, ckpt_every=100,
                                  ckpt_dir=str(tmp_path / "jax"),
                                  log_every=1))
    jtr.run(jparams, jopt.init(jparams))
    topt = AdamW(lr=cosine_schedule(3e-3, warmup=1, total=3))
    params = params_from_numpy(tree)
    ttr = Trainer(build_train_step(cfg, topt),
                  WithExtra(SyntheticLM(**data), cfg, 6),
                  TrainerConfig(total_steps=3, ckpt_every=100,
                                ckpt_dir=str(tmp_path / "torch"),
                                log_every=1), device="cpu")
    assert ttr.run(params, topt.init(params))[2] == 3
    want = [r["loss"] for r in jtr.metrics_history]
    got = [r["loss"] for r in ttr.metrics_history]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[2] != got[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_step_key_follows_the_extra_input(arch):
    """The graphed step's key holds the extra input beside the tokens and
    labels: another extra shape or type is another graph; another
    address of the same shape is the same graph (a static input, copied
    in on every call)."""
    cfg, _, tree = _setup(arch)
    params = params_from_numpy(tree)
    state = AdamW().init(params)
    toks = torch.zeros((2, 16), dtype=torch.int32)
    x = torch.zeros(_extra_shape(cfg, 2))
    key = step_key([toks, toks, x], params, state)
    assert key == step_key([toks, toks, x.clone()], params, state)
    assert key != step_key([toks, toks], params, state)
    assert key != step_key([toks, toks, x[:, :-1]], params, state)
    assert key != step_key([toks, toks, x.double()], params, state)


@pytest.mark.parametrize("arch", ARCHS)
def test_graphed_step_reads_each_batch_extra_input(graphs, arch):
    """Through the CUDA-graph stand-in: three steps whose batches differ
    only in the extra input (eager, captured, replayed) against three
    under ``disable_graphs()``: every metric and param bit for bit, the
    losses all different (a replay reading the first batch's extra
    input would repeat its loss on the same params)."""
    cfg, _, tree = _setup(arch)
    opt = AdamW(lr=cosine_schedule(0.0, warmup=1, total=4))   # lr 0
    base = _batch(cfg, 2)
    batches = []
    for i in range(3):
        b = {k: torch.from_numpy(v) for k, v in base.items()}
        b[get_model(cfg).extra_input] = torch.from_numpy(
            _batch(cfg, 10 + i)[get_model(cfg).extra_input])
        batches.append(b)
    params = params_from_numpy(tree)
    state = opt.init(params)
    step = build_train_step(cfg, opt)
    got = [step(params, state, b)[2] for b in batches]
    assert len(graphs) == 1 and graphs[0].replays == 2
    eparams = params_from_numpy(tree)
    estate = opt.init(eparams)
    with executor.disable_graphs():
        estep = build_train_step(cfg, opt)
        want = [estep(eparams, estate, b)[2] for b in batches]
    for g, w in zip(got, want):
        assert all(torch.equal(g[k], w[k]) for k in w), (g, w)
    assert len({float(m["loss"]) for m in got}) == 3
    for a, b in zip(_flat(params).values(), _flat(eparams).values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_without_the_extra_input_is_refused(arch):
    cfg, _, tree = _setup(arch)
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="vision_embeds|encoder_frames"):
        loss_and_grads(cfg, params_from_numpy(tree),
                       {"tokens": toks, "labels": toks})


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_refuses_the_family(arch, tmp_path):
    """The synthetic stream carries no extra input, so the CLI refuses
    these families (as the reference's cannot train them either)."""
    name = get_model(REGISTRY[arch]).extra_input
    with pytest.raises(ValueError, match=f"needs {name}, which the "
                       "synthetic token stream does not carry"):
        train.main(["--arch", arch, "--smoke", "--steps", "1", "--device",
                    "cpu", "--ckpt-dir", str(tmp_path)])
