"""Training the hybrid (zamba2, mamba2) and ssm (rwkv6) families through
the port's entry points (``launch/steps.py::loss_and_grads`` /
``build_train_step`` under ``runtime.Trainer``, and the
``launch.train`` CLI) against ``repro``'s, on the same numpy weights:
loss and every gradient, remat off and on; three ``Trainer`` steps; the
CLI.  f32 smoke configs, both sides ``impl="reference"`` (the port's
"auto" on a CPU tensor).  The scan kernels' autograd Functions are in
``test_torch_train_scan.py``."""
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

from repro_torch.checkpoint import latest_step  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import (build_train_step,  # noqa: E402
                                     loss_and_grads)
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.optim import AdamW, cosine_schedule  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402

from test_torch_cnn import numpy_params  # noqa: E402

ARCHS = ("zamba2-7b", "mamba2", "rwkv6-7b")
TOL = 1e-5


def _setup(arch, seed=0):
    cfg, jcfg = REGISTRY[arch].smoke(), JAX_REGISTRY[arch].smoke()
    tree = numpy_params(jax_get_model(jcfg).param_defs(jcfg), seed)
    return cfg, jcfg, tree


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def _jax_step_loss(jcfg, remat=False):
    """``repro``'s step body (``repro/launch/steps.py:220-233``) for one
    family: the legacy forward with ``return_hidden`` and the chunked
    cross-entropy against the head, ``impl="reference"``."""
    api = jax_get_model(jcfg)

    def loss_fn(p, batch):
        out = api.forward(p, batch["tokens"], jcfg, impl="reference",
                          remat=remat, return_hidden=True)
        head = p["embed"].T if jcfg.tie_embeddings else p["lm_head"]
        return jchunked(out["hidden"], head, batch["labels"])
    return loss_fn


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_repro(arch, remat):
    """Loss within 1e-5 and every gradient within 1e-5 of its largest
    value, through ``loss_and_grads`` on both sides' legacy forward."""
    cfg, jcfg, tree = _setup(arch)
    rng = np.random.default_rng(1)
    toks, labels = (rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
                    for _ in range(2))
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    want_loss, want = jax.value_and_grad(_jax_step_loss(jcfg, remat))(
        jax.tree.map(jnp.asarray, tree), jbatch)
    loss, grads = loss_and_grads(
        cfg, params_from_numpy(tree), {"tokens": torch.from_numpy(toks),
                                       "labels": torch.from_numpy(labels)},
        remat=remat)
    assert abs(float(loss) - float(want_loss)) <= TOL
    got = _flat(grads)
    for path, g in _flat(jax.tree.map(np.asarray, want)).items():
        diff = np.abs(got[path].numpy() - g).max()
        assert diff <= TOL * np.abs(g).max(), (path, diff)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_three_steps_match_repro(arch, tmp_path):
    """Three ``Trainer`` steps from the same weights and SyntheticLM
    batches: losses within 1e-4 relative of ``repro``'s."""
    cfg, jcfg, tree = _setup(arch)
    jopt = JAdamW(lr=jcosine(3e-3, warmup=1, total=3))
    loss_fn = _jax_step_loss(jcfg)

    def jstep(params, opt_state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        params, opt_state, m = jopt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, **m}

    data = dict(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=5)
    jparams = jax.tree.map(jnp.asarray, tree)
    jtr = JTrainer(jax.jit(jstep), JSynthetic(**data), JTrainerConfig(
        total_steps=3, ckpt_every=100, ckpt_dir=str(tmp_path / "jax"),
        log_every=1))
    jtr.run(jparams, jopt.init(jparams))
    topt = AdamW(lr=cosine_schedule(3e-3, warmup=1, total=3))
    params = params_from_numpy(tree)
    ttr = Trainer(build_train_step(cfg, topt), SyntheticLM(**data),
                  TrainerConfig(total_steps=3, ckpt_every=100,
                                ckpt_dir=str(tmp_path / "torch"),
                                log_every=1), device="cpu")
    assert ttr.run(params, topt.init(params))[2] == 3
    want = [r["loss"] for r in jtr.metrics_history]
    got = [r["loss"] for r in ttr.metrics_history]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[2] != got[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_trains_the_family_on_cpu(arch, tmp_path, capsys):
    res = train.main(["--arch", arch, "--smoke", "--steps", "2", "--seq",
                      "16", "--batch", "2", "--device", "cpu",
                      "--ckpt-dir", str(tmp_path), "--opt-bits", "8"])
    out = capsys.readouterr().out
    assert res["step"] == 2 and "finished at step 2" in out
    assert res["cfg"].family in ("hybrid", "ssm")
    assert latest_step(str(tmp_path)) == 2
    assert all(np.isfinite(r["loss"]) for r in res["trainer"].metrics_history)
