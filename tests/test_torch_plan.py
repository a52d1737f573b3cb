"""The port's sharding plan and spec functions against ``repro``'s, entry
for entry: ``make_plan`` (strategy, rules, overrides, activation specs,
batch spec, decisions), ``param_pspecs``, ``opt_state_pspecs`` (8 and 32
bits), ``batch_pspecs``, ``cache_pspecs`` (the port's cache on the
``meta`` device against the reference's ``jax.eval_shape`` one) and
``ActivationRules``' fixed specs, for every LM arch of the registry, its
assigned shapes and the smoke train / prefill / decode shapes, on five
meshes and under the three strategies.  Pure Python: no ranks."""
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import REGISTRY as JREGISTRY  # noqa: E402
from repro.configs.base import ShapeSpec as JShapeSpec  # noqa: E402
from repro.core.hw import MeshDescriptor as JMesh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.models import param_pspecs as jparam_pspecs  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.parallel.act_sharding import ActivationRules as JRules  # noqa
from repro.parallel.rules import make_plan as jmake_plan  # noqa: E402

from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.core.hw import MeshDescriptor  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import get_model, param_pspecs  # noqa: E402
from repro_torch.optim import AdamW, Q8State  # noqa: E402
from repro_torch.parallel import P, make_plan  # noqa: E402
from repro_torch.parallel.act_sharding import ActivationRules  # noqa: E402

MESHES = {"single_pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
STRATEGIES = ("tp", "fsdp", "auto")
SMOKE_SHAPES = [("t", 64, 8, "train"), ("p", 64, 8, "prefill"),
                ("d", 64, 8, "decode")]
ARCHS = sorted(REGISTRY)


def _t(spec):
    """A spec as a plain tuple of entries (JAX's and the port's alike)."""
    return tuple(spec)


def _specs(tree):
    """A spec tree as nested dicts of tuples (Q8State as a pair)."""
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        return ("Q8", _t(tree.q), _t(tree.scale))
    return _t(tree)


def _plan(plan):
    return {"strategy": plan.strategy, "rules": plan.rules,
            "overrides": plan.overrides,
            "act_specs": {k: _t(v) for k, v in plan.act_specs.items()},
            "batch_spec": _t(plan.batch_spec), "decisions": plan.decisions}


def _cells(name):
    """(port cfg, reference cfg, port shape, reference shape) of every
    cell the arch is checked on: its assigned shapes at full size, the
    smoke shapes on its smoke config."""
    cfg, jcfg = REGISTRY[name], JREGISTRY[name]
    assert [s.name for s in cfg.shapes()] == [s.name for s in jcfg.shapes()]
    assert cfg.skipped_shapes() == jcfg.skipped_shapes()
    assert cfg.n_active_params() == jcfg.n_active_params()
    out = [(cfg, jcfg, s, JShapeSpec(s.name, s.seq_len, s.global_batch,
                                     s.kind)) for s in cfg.shapes()]
    out += [(cfg.smoke(), jcfg.smoke(), ShapeSpec(*a), JShapeSpec(*a))
            for a in SMOKE_SHAPES]
    return out


_JCACHE = {}


def _jcache(jcfg, batch, max_len):
    key = (jcfg.name, batch, max_len)
    if key not in _JCACHE:
        _JCACHE[key] = jsteps.abstract_cache(jcfg, batch, max_len)
    return _JCACHE[key]


def _act_shapes(cfg, shape):
    """Representative activations of each named spec at the cell's
    shape (and one of a lower rank, which the spec is trimmed to)."""
    GB, S, D = shape.global_batch, shape.seq_len, cfg.d_model
    E = max(cfg.n_experts, 1)
    return {"hidden": [(GB, S, D), (GB, D)],
            "logits": [(GB, S, cfg.vocab), (GB, cfg.vocab)],
            "attn_q": [(GB, cfg.n_heads, S, cfg.hd)],
            "attn_kv": [(GB, cfg.n_kv_heads, S, cfg.hd)],
            "moe_buf": [(E, 8, D)], "moe_h": [(E, 8, cfg.d_ff)],
            "unnamed": [(GB, D)]}


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_and_specs_match_repro(arch, strategy, monkeypatch):
    # The reference applies its fixed activation spec through
    # with_sharding_constraint: hand the spec back instead.
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: spec)
    n_checked = 0
    for cfg, jcfg, shape, jshape in _cells(arch):
        defs = get_model(cfg).param_defs(cfg)
        jdefs = jget_model(jcfg).param_defs(jcfg)
        cache = cache_j = None
        if shape.kind != "train":
            cache = steps.abstract_cache(cfg, shape.global_batch,
                                         shape.seq_len)
            cache_j = _jcache(jcfg, jshape.global_batch, jshape.seq_len)
            assert all(v.device.type == "meta" for v in cache.values())
            assert {k: tuple(v.shape) for k, v in cache.items()} == {
                k: tuple(v.shape) for k, v in cache_j.items()}
        for mname, (mshape, axes) in MESHES.items():
            desc, jdesc = MeshDescriptor(mshape, axes), JMesh(mshape, axes)
            sizes = dict(zip(axes, mshape))
            where = (arch, shape.name, shape.kind, mname, strategy)
            plan = make_plan(cfg, shape, desc, strategy)
            jplan = jmake_plan(jcfg, jshape, jdesc, strategy)
            assert _plan(plan) == _plan(jplan), where
            p_specs = param_pspecs(defs, plan.rules, plan.overrides,
                                   axis_sizes=sizes)
            jp_specs = jparam_pspecs(jdefs, jplan.rules, jplan.overrides,
                                     axis_sizes=sizes)
            assert _specs(p_specs) == _specs(jp_specs), where
            for bits in (8, 32):
                got = steps.opt_state_pspecs(p_specs, bits)
                want = jsteps.opt_state_pspecs(jp_specs, bits)
                assert _specs(got) == _specs(want), where + (bits,)
            got = steps.batch_pspecs(cfg, shape, plan, sizes)
            want = jsteps.batch_pspecs(jcfg, jshape, jplan, sizes)
            assert _specs(got) == _specs(want), where
            if cache is not None:
                got = steps.cache_pspecs(cache, plan, sizes)
                want = jsteps.cache_pspecs(cache_j, jplan, sizes)
                assert _specs(got) == _specs(want), where
            rules = ActivationRules(plan.act_specs, desc)
            jrules = JRules(jplan.act_specs,
                            types.SimpleNamespace(shape=sizes))
            for name, shapes in _act_shapes(cfg, shape).items():
                for shp in shapes:
                    x = jax.ShapeDtypeStruct(shp, jax.numpy.float32)
                    want = jrules.constrain(x, name)
                    got = rules.spec_for(shp, name)
                    assert (got is None and want is x) or \
                        _t(got) == _t(want), where + (name, shp)
            n_checked += 1
    assert n_checked == len(_cells(arch)) * len(MESHES)


def test_spec_normalises_as_partition_spec():
    from jax.sharding import PartitionSpec as JP
    for entries in [(("data",), None), ((), "model"),
                    (("pod", "data"), None, "model"), ()]:
        assert _t(P(*entries)) == _t(JP(*entries))
    assert P(("data",)) == P("data") and P() == ()


def test_abstract_train_state_allocates_nothing():
    """llama4-maverick's whole train state (8-bit moments) on the meta
    device, shaped as the reference's ``jax.eval_shape`` one, and its
    specs on the two-pod mesh."""
    name = "llama4-maverick-400b-a17b"
    cfg, jcfg = REGISTRY[name], JREGISTRY[name]
    params, opt, defs = steps.abstract_train_state(cfg, AdamW(state_bits=8))
    jparams, jopt, _ = jsteps.abstract_train_state(jcfg,
                                                   JAdamW(state_bits=8))
    from repro_torch.checkpoint import tree_leaves
    leaves = tree_leaves((params, opt))
    assert all(t.device.type == "meta" for t in leaves)
    assert [tuple(t.shape) for t in leaves] == [
        tuple(t.shape) for t in jax.tree.leaves((jparams, jopt))]
    assert isinstance(opt["m"]["embed"], Q8State)
    shape = cfg.shapes()[0]
    jshape = jcfg.shapes()[0]
    desc = MeshDescriptor((2, 16, 16), ("pod", "data", "model"))
    plan = make_plan(cfg, shape, desc, "auto")
    jplan = jmake_plan(jcfg, jshape, JMesh(desc.shape, desc.axes), "auto")
    sizes = dict(zip(desc.axes, desc.shape))
    got = param_pspecs(defs, plan.rules, plan.overrides, axis_sizes=sizes)
    want = jparam_pspecs(jget_model(jcfg).param_defs(jcfg), jplan.rules,
                         jplan.overrides, axis_sizes=sizes)
    assert _specs(got) == _specs(want)
