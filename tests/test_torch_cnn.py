"""The port's compiled-Program CNN forward against ``repro``'s, on the
same numpy weights and inputs: full width (alexnet-owt, resnet18) on
the plain path, their paper-faithful Programs (SNOWFLAKE and TPU_V5E,
every conv on materialized strips) on the plain path and through the
strip wrapper with the kernels' plain versions standing in, and the
small TINY net (zero-copy and paper-faithful) against the Pallas
kernels in interpret mode; plus the weight bridge."""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import CNN_REGISTRY as JAX_CNNS  # noqa: E402
from repro.core import SNOWFLAKE as JAX_SNOWFLAKE  # noqa: E402
from repro.core import TPU_V5E as JAX_TPU_V5E  # noqa: E402
from repro.models import cnn as jax_cnn  # noqa: E402
from repro.runtime import executor as jax_executor  # noqa: E402

from repro_torch.configs import CNN_REGISTRY  # noqa: E402
from repro_torch.core import SNOWFLAKE, TPU_V5E  # noqa: E402
from repro_torch.kernels.conv2d import kernel as conv_kernel  # noqa: E402
from repro_torch.kernels.conv2d import ops as conv_ops  # noqa: E402
from repro_torch.models import cnn, params_from_numpy, tree_paths  # noqa: E402
from repro_torch.runtime import executor  # noqa: E402

from test_torch_compiler import JAX_TINY, TINY  # noqa: E402


def numpy_params(defs, seed):
    """A parameter tree drawn with numpy from ``seed``: fan-in scaled
    normal weights and small random biases, one array per ParamDef."""
    rng = np.random.default_rng(seed)

    def go(sub):
        out = {}
        for k, d in sub.items():
            if isinstance(d, dict):
                out[k] = go(d)
                continue
            scale = (0.1 if len(d.shape) == 1
                     else math.prod(d.shape[:-1]) ** -0.5)
            out[k] = (rng.standard_normal(d.shape) * scale).astype(
                np.float32)
        return out
    return go(defs)


def _jax_tree(tree):
    return {k: _jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("name", ["alexnet-owt", "resnet18"])
def test_full_width_program_matches_reference(name):
    cfg, jcfg = CNN_REGISTRY[name], JAX_CNNS[name]
    params = numpy_params(jax_cnn.param_defs(jcfg), seed=0)
    x = np.random.default_rng(1).standard_normal(
        (2, cfg.input_hw, cfg.input_hw, cfg.input_ch)).astype(np.float32)
    ref = jax_executor.run(jax_cnn.compile_program(jcfg, batch=2),
                           _jax_tree(params), jnp.asarray(x),
                           impl="reference")
    out = executor.run(cnn.compile_program(cfg, batch=2),
                       params_from_numpy(params), torch.from_numpy(x))
    assert out.shape == (2, cfg.n_classes)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def test_tiny_program_matches_pallas_interpret():
    params = numpy_params(jax_cnn.param_defs(JAX_TINY), seed=2)
    x = np.random.default_rng(3).standard_normal(
        (2, 16, 16, 4)).astype(np.float32)
    ref = jax_executor.run(jax_cnn.compile_program(JAX_TINY, batch=2),
                           _jax_tree(params), jnp.asarray(x),
                           impl="pallas", interpret=True)
    p = params_from_numpy(params)
    out = cnn.forward(p, torch.from_numpy(x), TINY)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    oracle = cnn.reference_forward(p, torch.from_numpy(x), TINY)
    np.testing.assert_allclose(out.numpy(), oracle.numpy(), rtol=0,
                               atol=1e-5)


HW = {"snowflake": (SNOWFLAKE, JAX_SNOWFLAKE),
      "tpu_v5e": (TPU_V5E, JAX_TPU_V5E)}


def use_strip_stand_ins(monkeypatch):
    """On CPU tensors, route the port's conv2d down its kernel path with
    each CUDA wrapper's plain version in its place, so the strip copy,
    the strip conv and the trim run as they run on the card.  Returns
    the list of the strip convs' dataflows, one per call."""
    calls = []

    def strips(s, w, g, *, dataflow, **kw):
        calls.append(dataflow)
        return conv_kernel.conv2d_strips_plain(s, w, g, **kw)

    def virtual(x, w, g, *, dataflow, row_starts, **kw):
        return conv_kernel.conv2d_virtual_plain(x, w, g, **kw)

    monkeypatch.setattr(conv_ops, "use_kernel", lambda impl, x: True)
    monkeypatch.setattr(conv_ops, "conv2d_strips_cuda", strips)
    monkeypatch.setattr(conv_ops, "conv2d_virtual_cuda", virtual)
    return calls


@pytest.fixture
def strip_stand_ins(monkeypatch):
    return use_strip_stand_ins(monkeypatch)


@pytest.mark.parametrize("hw", sorted(HW))
@pytest.mark.parametrize("name", ["alexnet-owt", "resnet18"])
def test_paper_faithful_program_matches_reference(name, hw, monkeypatch):
    cfg, jcfg = CNN_REGISTRY[name], JAX_CNNS[name]
    port_hw, jax_hw = HW[hw]
    params = numpy_params(jax_cnn.param_defs(jcfg), seed=7)
    x = np.random.default_rng(8).standard_normal(
        (2, cfg.input_hw, cfg.input_hw, cfg.input_ch)).astype(np.float32)
    jprog = jax_cnn.compile_program(jcfg, batch=2, hw=jax_hw,
                                    paper_faithful=True)
    ref = np.asarray(jax_executor.run(jprog, _jax_tree(params),
                                      jnp.asarray(x), impl="reference"))
    prog = cnn.compile_program(cfg, batch=2, hw=port_hw,
                               paper_faithful=True)
    p, xt = params_from_numpy(params), torch.from_numpy(x)
    out = executor.run(prog, p, xt)
    assert out.shape == (2, cfg.n_classes)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    calls = use_strip_stand_ins(monkeypatch)
    strips = executor.run(prog, p, xt)
    assert len(calls) == sum(op.kernel == "conv2d" for op in prog.ops)
    np.testing.assert_allclose(strips.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("hw", sorted(HW))
def test_tiny_paper_faithful_program_matches_pallas_interpret(
        hw, strip_stand_ins):
    port_hw, jax_hw = HW[hw]
    params = numpy_params(jax_cnn.param_defs(JAX_TINY), seed=9)
    x = np.random.default_rng(10).standard_normal(
        (2, 16, 16, 4)).astype(np.float32)
    jprog = jax_cnn.compile_program(JAX_TINY, batch=2, hw=jax_hw,
                                    paper_faithful=True)
    ref = jax_executor.run(jprog, _jax_tree(params), jnp.asarray(x),
                           impl="pallas", interpret=True)
    prog = cnn.compile_program(TINY, batch=2, hw=port_hw,
                               paper_faithful=True)
    out = executor.run(prog, params_from_numpy(params), torch.from_numpy(x))
    assert len(strip_stand_ins) == 3
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name", ["alexnet-owt", "resnet18", "resnet50"])
def test_param_defs_match_reference(name):
    ours = cnn.param_defs(CNN_REGISTRY[name])
    ref = jax_cnn.param_defs(JAX_CNNS[name])
    assert tree_paths(ours) == tree_paths(ref)
    for path in tree_paths(ours):
        a, b = ours, ref
        for part in path.split("/"):
            a, b = a[part], b[part]
        assert (a.shape, a.axes, a.init) == (b.shape, b.axes, b.init)
        assert a.dtype == torch.float32 and b.dtype == jnp.float32


def test_params_from_numpy_round_trips_keys_shapes_dtypes():
    rng = np.random.default_rng(4)
    tree = {"layer_00": {"w": rng.standard_normal((3, 3, 2, 4)).astype(
                             np.float32),
                         "b": np.zeros(4, np.float32)},
            "blocks": {"wq": rng.standard_normal((2, 8, 8)).astype(
                ml_dtypes.bfloat16)}}
    out = params_from_numpy(tree)
    assert tree_paths(out) == tree_paths(tree)
    assert out["layer_00"]["w"].dtype == torch.float32
    assert out["blocks"]["wq"].dtype == torch.bfloat16
    assert tuple(out["layer_00"]["w"].shape) == (3, 3, 2, 4)
    np.testing.assert_array_equal(out["layer_00"]["w"].numpy(),
                                  tree["layer_00"]["w"])
    np.testing.assert_array_equal(
        out["blocks"]["wq"].float().numpy(),
        tree["blocks"]["wq"].astype(np.float32))


def test_non_cnn_op_kinds_name_their_roadmap_item():
    """The stateless runner refuses what it cannot run: a cross-attention
    op (it reads persistent encoder memory, so only the stateful runs
    take it) and an unknown kernel.  Every op kind is ported now, so no
    ROADMAP item is left to name."""
    import dataclasses
    prog = cnn.compile_program(TINY, batch=1)
    op = dataclasses.replace(prog.ops[0], kernel="cross_attention")
    with pytest.raises(ValueError, match="persistent encoder memory"):
        executor._run_op(op, None, {}, {}, impl="reference")
    op = dataclasses.replace(prog.ops[0], kernel="no_such_kernel")
    with pytest.raises(NotImplementedError, match="no_such_kernel"):
        executor._run_op(op, None, {}, {}, impl="reference")


def test_walk_yields_each_op_with_its_operands():
    params = params_from_numpy(
        numpy_params(jax_cnn.param_defs(JAX_TINY), seed=5))
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 16, 16, 4)).astype(np.float32))
    prog = cnn.compile_program(TINY, batch=2)
    seen = list(executor.walk(prog, params, x, impl="reference"))
    assert [s[0] for s in seen] == list(prog.ops)
    op, src, p, byp = seen[0]
    assert src is x and p["w"] is params[op.param_key]["w"]
    for op, src, p, byp in seen:
        assert (byp is not None) == (op.fuse_bypass
                                     and op.bypass_region is not None)
        assert (p is None) == (op.param_key is None)
