"""The port's step analyzer (``core/step_analysis.py``) against
``repro``'s HLO analyzer and against hand counts.

* ``tests/test_hlo_analysis.py``'s own cases, through ``analyze_step``:
  the FLOPs of a plain dot, 17 chained products, 3 x 5 nested products
  and a batched einsum each equal ``repro``'s ``analyze_hlo_text`` count
  of the same function within that file's 1%; the bytes of 10
  elementwise iterations (``c * 2.0 + 1.0``) hold its lower bound and
  are at least ``repro``'s count.  They are not equal: eager torch runs
  the multiply and the add as two ops, each reading and writing the
  array, where XLA fuses them into one.
* On a fake world of 8 ranks, in a subprocess (one default process
  group per process): an all-gather over a group of 4 (list and
  into-tensor forms), an all-reduce over 2, a reduce-scatter over 4
  (both forms), an all-to-all and one ring step of ``all_gather_matmul``
  (a send counted as a collective-permute, its receive not): counts,
  result bytes and link bytes exact; and ``argument_size_in_bytes`` of
  the sharded steps equal to the local block bytes the spec functions
  give (the batch arrives whole on every rank: the port's step takes the
  global inputs and cuts its rows).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.hlo_analysis import analyze_hlo_text  # noqa: E402

from repro_torch.core.step_analysis import StepStats, analyze_step  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hlo_stats(fn, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return analyze_hlo_text(jax.jit(fn).lower(*args).compile().as_text(), 1)


def _tensors(*shapes):
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in shapes]


def _chain(a, b, n):
    for _ in range(n):
        a = a @ b
    return a


def _j_scan(n):
    def f(a, b):
        def body(c, _):
            return c @ b, None
        return jax.lax.scan(body, a, None, length=n)[0]
    return f


def _j_nested(a, b):
    def outer(c, _):
        def inner(d, _):
            return d @ b, None
        return jax.lax.scan(inner, c, None, length=3)[0], None
    return jax.lax.scan(outer, a, None, length=5)[0]


def _t_nested(a, b):
    for _ in range(5):
        for _ in range(3):
            a = a @ b
    return a


# name: (port function, reference function, operand shapes, hand count)
FLOP_CASES = {
    "plain_dot": (lambda a, b: a @ b, lambda a, b: a @ b,
                  [(256, 512), (512, 128)], 2 * 256 * 512 * 128),
    "scan_17": (lambda a, b: _chain(a, b, 17), _j_scan(17),
                [(128, 128), (128, 128)], 17 * 2 * 128 ** 3),
    "nested_3x5": (_t_nested, _j_nested, [(64, 64), (64, 64)],
                   15 * 2 * 64 ** 3),
    "batched_einsum": (lambda a, b: torch.einsum("bhij,bhjk->bhik", a, b),
                       lambda a, b: jnp.einsum("bhij,bhjk->bhik", a, b),
                       [(4, 8, 32, 16), (4, 8, 16, 24)],
                       2 * 4 * 8 * 32 * 16 * 24),
}


@pytest.mark.parametrize("case", list(FLOP_CASES))
def test_flops_match_reference_hlo_analysis(case):
    fn, jfn, shapes, expect = FLOP_CASES[case]
    ref = _hlo_stats(jfn, *shapes).flops
    st = analyze_step(fn, *_tensors(*shapes))
    assert abs(ref - expect) / expect < 0.01
    assert abs(st.flops - ref) / ref < 0.01, (st.flops, ref)
    assert st.coll_counts == {} and st.coll_link_bytes == 0.0


def test_elementwise_bytes_hold_reference_bound():
    def f(x):
        for _ in range(10):
            x = x * 2.0 + 1.0
        return x

    def jf(x):
        def body(c, _):
            return c * 2.0 + 1.0, None
        return jax.lax.scan(body, x, None, length=10)[0]
    ref = _hlo_stats(jf, (1024, 1024)).hbm_bytes
    st = analyze_step(f, *_tensors((1024, 1024)))
    assert st.hbm_bytes >= 10 * 2 * 1024 * 1024 * 4 * 0.9
    assert st.hbm_bytes >= ref
    # Exactly two ops an iteration, each reading and writing 4 MB (the
    # scalar operand is no tensor).
    assert st.hbm_bytes == 10 * 2 * 2 * 1024 * 1024 * 4
    assert st.flops == 0


def test_views_are_free_and_memory_is_tracked():
    def f(x):
        y = x.view(64, 256).t().reshape(128, 128)   # the reshape copies
        z = torch.zeros(1024, 16)
        return y.sum(0), z
    x, = _tensors((128, 128))
    st = analyze_step(f, x)
    n = 128 * 128 * 4
    # the reshape's copy (read + write), the sum (read + 128 floats),
    # the zeros (its write)
    assert st.hbm_bytes == 2 * n + n + 128 * 4 + 1024 * 16 * 4
    assert st.memory["argument_size_in_bytes"] == n
    assert st.memory["output_size_in_bytes"] == 128 * 4 + 1024 * 16 * 4
    assert st.memory["temp_size_in_bytes"] >= n + 1024 * 16 * 4
    assert st.memory["generated_code_size_in_bytes"] is None


def test_stats_add_scales_every_count():
    a = StepStats(1.0, 2.0, 3.0, {"all-gather": 1}, {"all-gather": 8.0})
    a.add(StepStats(1.0, 1.0, 1.0, {"all-gather": 2, "all-reduce": 1},
                    {"all-gather": 4.0, "all-reduce": 2.0}), 3.0)
    assert (a.flops, a.hbm_bytes, a.coll_link_bytes) == (4.0, 5.0, 6.0)
    assert a.coll_counts == {"all-gather": 7, "all-reduce": 3}
    assert a.coll_bytes == {"all-gather": 20.0, "all-reduce": 6.0}


FAKE_WORLD = r"""
import json, sys, warnings
sys.path.insert(0, SRC)
import torch
import torch.distributed as dist
from repro_torch.core.hw import MeshDescriptor
from repro_torch.core.step_analysis import analyze_step
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import make_mesh_from_descriptor
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.optim import AdamW, Q8State
from repro_torch.parallel import all_gather_matmul, make_plan
from repro_torch.parallel.placement import axes_of
warnings.simplefilter("ignore", FutureWarning)
torch.set_num_threads(1)
dryrun.fake_world(8)
out = {}
mesh = make_mesh_from_descriptor(MeshDescriptor((2, 4), ("data", "model")),
                                 "cpu")
g4, g2 = mesh.get_group("model"), mesh.get_group("data")

def body(t, x, w):
    parts = [torch.empty_like(t) for _ in range(4)]
    dist.all_gather(parts, t, group=g4)                      # list
    whole = torch.empty(32, 16)
    dist.all_gather_into_tensor(whole, t, group=g4)          # into a tensor
    dist.all_reduce(t, group=g2)
    part = torch.empty(2, 16)
    dist.reduce_scatter(part, list(t.chunk(4)), group=g4)    # list
    dist.reduce_scatter_tensor(part, t, group=g4)            # from a tensor
    a2a = torch.empty_like(t)
    dist.all_to_all_single(a2a, t, group=g4)
    return parts, whole, part, a2a, all_gather_matmul(x, w, g2)

st = analyze_step(body, torch.ones(8, 16), torch.ones(4, 8),
                  torch.ones(8, 6), n_chips=8)
cs = st.collective_stats()
out["collectives"] = {"counts": st.coll_counts, "bytes": st.coll_bytes,
                      "link": st.coll_link_bytes,
                      "collective_stats": [cs.counts, cs.op_bytes,
                                           cs.link_bytes_per_chip]}

# argument bytes of the sharded steps against the specs' local blocks
sizes = {"data": 2, "model": 4}

def local_bytes(t, spec):
    n = t.element_size()
    for d, dim in enumerate(t.shape):
        k = 1
        for a in axes_of(spec[d] if d < len(spec) else None):
            k *= sizes[a]
        n *= dim // k
    return n

def walk(tree, specs):
    if isinstance(tree, dict):
        return sum(walk(tree[k], specs[k]) for k in tree)
    if isinstance(tree, Q8State):
        return walk(tree.q, specs.q) + walk(tree.scale, specs.scale)
    return local_bytes(tree, specs)

cfg = get_config("smollm-360m").smoke()
desc = MeshDescriptor((2, 4), ("data", "model"))
for strategy, kind, bits in (("fsdp", "train", 32), ("tp", "train", 8),
                             ("auto", "prefill", 32), ("auto", "decode", 32)):
    shape = ShapeSpec(kind, 64, 8, kind)
    opt = AdamW(state_bits=bits)
    bundle, st = dryrun.count_step(cfg, shape, make_plan(cfg, shape, desc,
                                                         strategy), mesh,
                                   optimizer=opt)
    params, opt_state, _ = steps.abstract_train_state(cfg, opt)
    want = walk(params, bundle.specs["params"])
    want += sum(t.numel() * t.element_size()
                for t in steps.input_specs(cfg, shape).values())
    if kind == "train":
        want += walk(opt_state, bundle.specs["opt_state"])
    if kind == "decode":
        want += walk(steps.abstract_cache(cfg, 8, 64), bundle.specs["cache"])
    out[f"{strategy}|{kind}|{bits}"] = {"got": st.memory, "want": want}
print("RESULTS_JSON:" + json.dumps(out))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def fake_world():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    code = f"SRC = {os.path.join(ROOT, 'src')!r}\n" + FAKE_WORLD
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    line = [l for l in proc.stdout.splitlines()
            if l.startswith("RESULTS_JSON:")]
    assert line, proc.stdout[-2000:]
    return json.loads(line[0][len("RESULTS_JSON:"):])


def test_collectives_on_a_fake_world_counted_exactly(fake_world):
    got = fake_world["collectives"]
    f32 = 4
    # result bytes: the gathered (32, 16); the reduced (8, 16); the
    # scattered (2, 16); the exchanged (8, 16); the sent (8, 6) shard
    raw = {"all-gather": 2 * 32 * 16 * f32, "all-reduce": 8 * 16 * f32,
           "reduce-scatter": 2 * 2 * 16 * f32, "all-to-all": 8 * 16 * f32,
           "collective-permute": 8 * 6 * f32}
    assert got["counts"] == {"all-gather": 2, "all-reduce": 1,
                             "reduce-scatter": 2, "all-to-all": 1,
                             "collective-permute": 1}
    assert got["bytes"] == raw
    link = (3 / 4 * raw["all-gather"] + 2 * 1 / 2 * raw["all-reduce"]
            + 3 / 4 * raw["reduce-scatter"] + 3 / 4 * raw["all-to-all"]
            + raw["collective-permute"])
    assert got["link"] == link
    assert got["collective_stats"] == [got["counts"], got["bytes"], link]


@pytest.mark.parametrize("cell", ["fsdp|train|32", "tp|train|8",
                                  "auto|prefill|32", "auto|decode|32"])
def test_argument_bytes_are_the_specs_local_blocks(fake_world, cell):
    r = fake_world[cell]
    assert r["got"]["argument_size_in_bytes"] == r["want"]
    assert r["got"]["output_size_in_bytes"] > 0
    # weight-gathered: the whole model is live beside the blocks
    assert r["got"]["temp_size_in_bytes"] > r["want"]
