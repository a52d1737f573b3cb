"""The compiled training step (``launch/steps.py::build_train_step``, the
counterpart of ``repro``'s ``jax.jit(train_step, donate_argnums=(0, 1))``)
on the CPU, through ``test_torch_graphs``' stand-in for
``torch.cuda.CUDAGraph`` / ``torch.cuda.graph`` (records each aten op
of the captured call without running it, raises on a host read,
re-runs the record on replay): the first call eager, the second
captured, later ones replayed; the params and the optimizer state
updated in place; replays bitwise equal to eager steps over three
steps (smollm and granite smoke, 32- and 8-bit moments); a resume from
a checkpoint; exact launch counts through replays, the flash kernels
counted by stand-ins that run their plain versions."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.models import get_model  # noqa: E402

from repro_torch.checkpoint import tree_leaves  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels.flash_attention import bwd_kernel as bwd_k  # noqa
from repro_torch.kernels.flash_attention import kernel as fwd_k  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa
from repro_torch.kernels.matmul import kernel as mm_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as dec_kernel  # noqa
from repro_torch.launch.steps import build_train_step  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.optim import AdamW, cosine_schedule  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig, executor  # noqa

from test_torch_cnn import numpy_params  # noqa: E402
from test_torch_graphs import counting, graphs  # noqa: E402,F401

ARCHS = ("smollm-360m", "granite-moe-1b-a400m")


@pytest.fixture
def flash_counting(monkeypatch):
    """The flash forward and backward down their kernel path on CPU
    tensors, each wrapper's plain version in its place, counting in the
    real wrappers' ``launches`` and ``path_launches`` (f32: simt)."""
    def fwd(q, k, v, **kw):
        fwd_k.flash_attention_cuda.launches += 1
        fwd_k.flash_attention_cuda.path_launches["simt"] += 1
        return fwd_k.flash_attention_plain(q, k, v, **kw)

    def bwd(q, k, v, out, lse, do, **kw):
        bwd_k.flash_attention_bwd_cuda.launches += 1
        bwd_k.flash_attention_bwd_cuda.path_launches["simt"] += 1
        return bwd_k.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    monkeypatch.setattr(flash_ops, "use_kernel", lambda impl, x: True)
    monkeypatch.setattr(flash_ops, "flash_attention_cuda", fwd)
    monkeypatch.setattr(flash_ops, "flash_attention_bwd_cuda", bwd)
    for fn in (fwd_k.flash_attention_cuda, bwd_k.flash_attention_bwd_cuda):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "path_launches", {"mma": 0, "simt": 0})


def _setup(name, bits=32, seed=0):
    cfg = REGISTRY[name].smoke()
    jcfg = JAX_REGISTRY[name].smoke()
    tree = numpy_params(get_model(jcfg).param_defs(jcfg), seed)
    opt = AdamW(lr=cosine_schedule(3e-3, warmup=1, total=4),
                state_bits=bits)
    return cfg, tree, opt


def _state(tree, opt):
    params = params_from_numpy(tree)
    return params, opt.init(params)


def _batches(cfg, n, B=2, S=16):
    data = SyntheticLM(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=7)
    return [{k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}
            for i in range(n)]


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
        for x, y in zip(la, lb))


def test_first_call_is_eager_the_second_captures_later_ones_replay(graphs):
    cfg, tree, opt = _setup("smollm-360m")
    params, state = _state(tree, opt)
    step = build_train_step(cfg, opt)
    for i, batch in enumerate(_batches(cfg, 5)):
        step(params, state, batch)
        if i == 0:
            assert graphs == [] and list(step.graphs.graphs.values()) == [
                None]
        else:
            assert len(graphs) == 1 and graphs[0].replays == i
    assert graphs[0].ops                 # recorded, not run, at capture
    assert int(state["step"]) == 5
    assert step.graphs.capture_seconds > 0


@pytest.mark.parametrize("bits", [32, 8])
def test_state_is_updated_in_place(graphs, bits):
    """The step returns the params and state it was given, written
    through the storage they had (the reference's donation): every
    leaf at its old address, with new values."""
    cfg, tree, opt = _setup("granite-moe-1b-a400m", bits)
    params, state = _state(tree, opt)
    ptrs = [t.data_ptr() for t in tree_leaves((params, state))]
    before = [t.clone() for t in tree_leaves(params)]
    step = build_train_step(cfg, opt)
    for batch in _batches(cfg, 3):
        p, s, _ = step(params, state, batch)
        assert p is params and s is state
    assert [t.data_ptr() for t in tree_leaves((params, state))] == ptrs
    assert all(not torch.equal(a, b) for a, b in
               zip(before, tree_leaves(params)) if a.ndim >= 2)
    assert int(state["step"]) == 3
    assert len(graphs) == 1 and graphs[0].replays == 2


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("bits", [32, 8])
def test_replays_match_eager_steps_bit_for_bit(graphs, name, bits):
    """Three steps through the graph (eager, capture + replay, replay)
    and three under ``disable_graphs()`` from the same weights and
    batches: every metric, param and optimizer-state leaf bitwise
    equal, and the metrics handed out are fresh tensors."""
    cfg, tree, opt = _setup(name, bits)
    batches = _batches(cfg, 3)
    params, state = _state(tree, opt)
    step = build_train_step(cfg, opt)
    got = [step(params, state, b)[2] for b in batches]
    eparams, estate = _state(tree, opt)
    with executor.disable_graphs():
        estep = build_train_step(cfg, opt)
        want = [estep(eparams, estate, b)[2] for b in batches]
    assert len(graphs) == 1 and graphs[0].replays == 2
    assert not estep.graphs.graphs
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert ("moe_imbalance_pct" in g) == (cfg.n_experts > 0)
        assert all(torch.equal(g[k], w[k]) for k in g), (g, w)
    assert got[1]["loss"] is not got[2]["loss"]
    assert len({float(m["loss"]) for m in got}) == 3
    assert _same(params, eparams) and _same(state, estate)


def test_a_resumed_trainer_trains_on(graphs, tmp_path):
    """Four graphed steps straight, against two, a checkpoint, and a
    fresh trainer that resumes from it with the same step function: the
    restored state is new tensors, so the step captures a graph of its
    own (keeping one), and losses and the final state are bitwise those
    of the straight run."""
    cfg, tree, opt = _setup("granite-moe-1b-a400m")
    data = SyntheticLM(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=3)

    def trainer(step, total, where):
        return Trainer(step, data, TrainerConfig(
            total_steps=total, ckpt_every=2, ckpt_dir=str(tmp_path / where),
            log_every=1), device="cpu")
    params, state = _state(tree, opt)
    straight = trainer(build_train_step(cfg, opt), 4, "a")
    p1, s1, _ = straight.run(params, state)
    step = build_train_step(cfg, opt)
    first = trainer(step, 2, "b")
    params, state = _state(tree, opt)
    first.run(params, state)
    resumed = trainer(step, 4, "b")
    p2, s2, n = resumed.run(*_state(_setup(cfg.name[:-6], seed=9)[1], opt))
    assert n == 4 and [r["step"] for r in resumed.metrics_history] == [2, 3]
    assert [r["loss"] for r in first.metrics_history
            + resumed.metrics_history] == [
        r["loss"] for r in straight.metrics_history]
    assert _same(p1, p2) and _same(s1, s2)
    # the graph captured on the first run's state was dropped
    live = [g for g in step.graphs.graphs.values() if g is not None]
    assert len(live) == 1 and live[0].graph.replays == 1


@pytest.mark.parametrize("remat", [False, True])
def test_launch_counts_are_exact_through_replays(graphs, counting,
                                                 flash_counting, remat):
    """With the flash kernels' plain versions counting as launches: n
    steps make n x (L forward, 2L under remat; L backward) launches,
    the capture's bumps rolled back and each replay adding the captured
    count; no matmul or decode launch (the training forward's
    projections are plain products, as in the reference)."""
    cfg, tree, opt = _setup("smollm-360m")
    params, state = _state(tree, opt)
    step = build_train_step(cfg, opt, remat=remat)
    L = cfg.n_layers
    fwd, bwd = fwd_k.flash_attention_cuda, bwd_k.flash_attention_bwd_cuda
    per_fwd = 2 * L if remat else L
    for n, batch in enumerate(_batches(cfg, 4), start=1):
        step(params, state, batch)
        assert (fwd.launches, bwd.launches) == (n * per_fwd, n * L)
    assert fwd.path_launches["simt"] == 4 * per_fwd
    assert bwd.path_launches["simt"] == 4 * L
    assert mm_kernel.matmul_cuda.launches == 0
    assert dec_kernel.decode_attention_cuda.launches == 0
    (graph,) = [g for g in step.graphs.graphs.values() if g is not None]
    assert {k: added["launches"] for k, added in graph.launches} == {
        fwd: per_fwd, bwd: L}
    with executor.disable_graphs():
        step(params, state, _batches(cfg, 1)[0])
    assert (fwd.launches, bwd.launches) == (5 * per_fwd, 5 * L)


def test_a_host_read_under_capture_raises(graphs):
    """A learning-rate schedule that reads the step back to the host
    runs eagerly on the first call and raises out of the capture on the
    second; nothing is kept as captured and the state is as the first
    step left it."""
    cfg, tree, _ = _setup("smollm-360m")
    opt = AdamW(lr=lambda step: torch.full((), 1e-3 * float(step)))
    params, state = _state(tree, opt)
    step = build_train_step(cfg, opt)
    batches = _batches(cfg, 2)
    step(params, state, batches[0])
    before = [t.clone() for t in tree_leaves((params, state))]
    with pytest.raises(RuntimeError, match="host"):
        step(params, state, batches[1])
    assert all(torch.equal(a, b) for a, b in
               zip(before, tree_leaves((params, state))))
    assert list(step.graphs.graphs.values()) == [None]


def test_the_cpu_runs_every_step_eagerly():
    """Without the stand-in's switch a CPU step never graphs."""
    cfg, tree, opt = _setup("smollm-360m")
    params, state = _state(tree, opt)
    step = build_train_step(cfg, opt)
    assert not executor._graphable(torch.device("cpu"))
    for batch in _batches(cfg, 3):
        step(params, state, batch)
    assert not step.graphs.graphs and int(state["step"]) == 3
