"""The split execution's head-case decision (``parallel/split.py``):
``head_case`` over every case of (H, KV, hd, g), the registry's dense
configs at the reference's "model" sizes among them, and each case run
by the dense family's sharded train, prefill and decode steps
(``launch/steps.py::build_step``) on a fake world of 8 ranks
(``launch/dryrun.fake_world``: fake tensors, collectives that move
nothing; one default process group per process, so in a subprocess),
read back from ``split.COUNTS``: the head counts each flash and decode
launch saw, the weights gathered over "model", the cache exchanges, no
whole cache leaf gathered, and in training the forward and backward
all-reduces and the gathers' reduce-scatters.  The values are held on
gloo ranks (``tests/test_torch_sharded.py``).

On gloo ranks (``tests/_torch_ranks.py``, f32): the split's autograd
functions against autograd through the unsplit product on 2 ranks
(``to_model`` before a column-parallel product, ``from_model`` after a
row-parallel one, ``gather_columns`` with each rank's share of the
downstream loss), within 1e-6 in outputs and gradients, each counted
once; the vocab-parallel ``chunked_cross_entropy`` against the unsplit
one within 1e-6 in loss and gradients on 2 ranks (3 chunks, a mask),
and bit for bit at a group of one, where every function is the identity
and counts nothing."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.parallel.split import HEAD_CASES, head_case  # noqa: E402

from _torch_ranks import run_ranks  # noqa: E402
from _torch_ranks import split_train_counts as _train  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


@pytest.mark.parametrize("H,KV,hd,g,case", [
    (4, 2, 16, 1, "whole"),           # a group of one
    (4, 4, 16, 4, "whole"),           # olmo-1b smoke on 4
    (16, 16, 128, 16, "whole"),       # olmo-1b on the reference's 16
    (32, 32, 128, 16, "whole"),       # deepseek-7b on 16
    (15, 5, 64, 5, "whole"),          # smollm-360m on 5
    (4, 2, 16, 4, "shared_kv"),       # smollm-360m smoke on 4
    (32, 8, 128, 16, "shared_kv"),    # llama3-8b on 16
    (4, 1, 16, 4, "shared_kv"),       # one KV head for every rank
    (15, 5, 64, 4, "cut"),            # smollm-360m on 4: cut heads
    (15, 5, 64, 16, "cut"),           # smollm-360m on 16
    (4, 2, 16, 8, "cut"),             # more ranks than heads
    (6, 3, 16, 2, "cut"),             # H divides, KV neither way
    (15, 5, 64, 7, "unsplit"),        # no spec splits 960 columns by 7
])
def test_head_case(H, KV, hd, g, case):
    assert case in HEAD_CASES
    assert head_case(H, KV, hd, g) == case


# (id, arch, smoke, "model" size, expected counters of the prefill; of
# one decode step; of a train step), smoke configs: 4 layers, 4 / 2
# heads of 16 (smollm) or 4 / 4 (olmo), vocab 256; smollm-360m at full
# width: 32 layers (remat), 15 / 5 of 64, vocab 49152 (not split by 5).
def _gathers(L, names):
    return {f"model_gather:{n}": L for n in names}


CELLS = [
    ("olmo-whole-4", "olmo-1b", True, 4,
     {"flash:whole:1/1": 4}, {"decode:whole:1/1": 4},
     _train(4, "flash:whole:1/1")),
    ("smollm-whole-2", "smollm-360m", True, 2,
     {"flash:whole:2/1": 4}, {"decode:whole:2/1": 4},
     _train(4, "flash:whole:2/1")),
    ("smollm-shared-4", "smollm-360m", True, 4,
     {"flash:shared_kv:1/1": 4, **_gathers(4, ("wk", "wv")),
      "kv_exchange": 8},
     {"decode:shared_kv:1/1": 4, **_gathers(4, ("wk", "wv")),
      "kv_exchange": 8},
     _train(4, "flash:shared_kv:1/1", gathered=("wk", "wv"))),
    ("smollm-cut-8", "smollm-360m", True, 8,
     {"flash:cut:4/2": 4, **_gathers(4, ("wq", "wk", "wv"))},
     {"decode:cut:4/2": 4, **_gathers(4, ("wq", "wk", "wv")),
      "kv_layer_gather": 8},
     _train(4, "flash:cut:4/2", gathered=("wq", "wk", "wv"))),
    ("smollm-full-cut-4", "smollm-360m", False, 4,
     {"flash:cut:15/5": 32, **_gathers(32, ("wq", "wk", "wv"))},
     {"decode:cut:15/5": 32, **_gathers(32, ("wq", "wk", "wv")),
      "kv_layer_gather": 64},
     _train(32, "flash:cut:15/5", remat=True, gathered=("wq", "wk", "wv"))),
    ("smollm-full-whole-5", "smollm-360m", False, 5,
     {"flash:whole:3/1": 32}, {"decode:whole:3/1": 32},
     _train(32, "flash:whole:3/1", remat=True, vocab=False)),
]

SCRIPT = r"""
import json, sys, warnings
sys.path.insert(0, SRC)
import torch
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.hw import MeshDescriptor
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh_from_descriptor
from repro_torch.parallel import make_plan
from repro_torch.parallel.split import COUNTS
warnings.simplefilter("ignore", FutureWarning)
torch.set_num_threads(1)
dryrun.fake_world(8)
out = {}
for cid, arch, smoke, g, *_ in CELLS:
    cfg = get_config(arch)
    cfg = cfg.smoke() if smoke else cfg
    desc = MeshDescriptor((1, g), ("data", "model"))
    mesh = make_mesh_from_descriptor(desc, "cpu")
    out[cid] = []
    for kind in ("prefill", "decode", "train"):
        shape = ShapeSpec(kind, 64, 8, kind)
        COUNTS.clear()
        dryrun.count_step(cfg, shape, make_plan(cfg, shape, desc, "tp"),
                          mesh)
        out[cid].append(dict(COUNTS))
print("RESULTS_JSON:" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def counted():
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=SRC)
    prelude = f"SRC = {SRC!r}\nCELLS = {CELLS!r}\n"
    run = subprocess.run([sys.executable, "-c", prelude + SCRIPT],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-4000:]
    line = [l for l in run.stdout.splitlines()
            if l.startswith("RESULTS_JSON:")]
    assert line, run.stdout[-2000:]
    return json.loads(line[0][len("RESULTS_JSON:"):])


@pytest.mark.parametrize("cell", [pytest.param(c, id=c[0]) for c in CELLS])
def test_split_steps_on_a_fake_world(counted, cell):
    """tp's prefill, one decode step and one train step of each cell,
    counted: every layer's flash and decode launch at the rank's head
    counts, exactly the expected gathers and exchanges, no whole cache
    leaf, and in training exactly the expected all-reduces forward and
    backward and reduce-scatters."""
    cid, _, _, _, prefill, decode, train = cell
    assert counted[cid] == [prefill, decode, train], (cid, counted[cid])


# --- the autograd functions and the vocab-parallel cross-entropy ----------
UNIT_SCRIPT = r"""
import numpy as np
from repro_torch.models.losses import chunked_cross_entropy
from repro_torch.parallel.split import (COUNTS, from_model, gather_columns,
                                        to_model)
torch.set_default_dtype(torch.float32)
arrs = dict(np.load(os.path.join(WORK, "in.npz")))
t = {k: torch.from_numpy(v) for k, v in arrs.items()}
group = dist.group.WORLD
n = WORLD


def block(x, dim):
    size = x.shape[dim] // n
    return x.narrow(dim, RANK * size, size).detach().clone()


def leaf(x):
    return x.detach().clone().requires_grad_()


out = {}
counts = {}
# to_model: the same x on every rank, the rank's columns of w.
COUNTS.clear()
x, w = leaf(t["x"]), leaf(block(t["w"], 1))
y = to_model(x, group) @ w
(y * block(t["gy"], 1)).sum().backward()
out.update(to_y=y.detach(), to_dx=x.grad, to_dw=w.grad)
counts["to_model"] = dict(COUNTS)
# from_model: the rank's columns of x against its rows of w.
COUNTS.clear()
x, w = leaf(block(t["x"], 1)), leaf(block(t["w2"], 0))
y = from_model(x @ w, group)
(y * t["gy2"]).sum().backward()
out.update(from_y=y.detach(), from_dx=x.grad, from_dw=w.grad)
counts["from_model"] = dict(COUNTS)
# gather_columns: the rank's columns of w gathered; each rank takes its
# rows of the downstream loss, as a cut head's ranks do.
COUNTS.clear()
x, w = leaf(t["x"]), leaf(block(t["w"], 1))
y = x @ gather_columns(w, group, "w")
rows = y.shape[0] // n
(y.narrow(0, RANK * rows, rows) * block(t["gy"], 0)).sum().backward()
out.update(gather_y=y.detach(), gather_dx=x.grad, gather_dw=w.grad)
counts["gather_columns"] = dict(COUNTS)
# The cross-entropy: the rank's vocab columns, 3 chunks, a mask.
for name, grp in (("ce", group), ("ce_plain", None)):
    COUNTS.clear()
    h = leaf(t["h"])
    head = leaf(block(t["head"], 1) if grp is not None else t["head"])
    loss = chunked_cross_entropy(h, head, t["labels"], chunk=4,
                                 mask=t["mask"], group=grp)
    loss.backward()
    out.update({name: loss.detach(), name + "_dh": h.grad,
                name + "_dhead": head.grad})
    counts[name] = dict(COUNTS)
torch.save({"out": out, "counts": counts},
           os.path.join(WORK, f"out{RANK}.pt"))
"""


def _unit_inputs():
    rng = np.random.default_rng(7)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    B, S, D, V = 2, 12, 8, 16
    return {"x": f(6, 8), "w": f(8, 4), "gy": f(6, 4), "w2": f(8, 4),
            "gy2": f(6, 4), "h": f(B, S, D), "head": f(D, V) * 0.5,
            "labels": rng.integers(0, V, (B, S)).astype(np.int64),
            "mask": (rng.random((B, S)) > 0.25).astype(np.float32)}


@pytest.fixture(scope="module")
def unit_runs(tmp_path_factory):
    """The unit script's outputs on a world of 2 gloo ranks and of 1."""
    arrs = _unit_inputs()
    runs = {}
    for world in (2, 1):
        work = str(tmp_path_factory.mktemp(f"units{world}"))
        np.savez(os.path.join(work, "in.npz"), **arrs)
        run_ranks(UNIT_SCRIPT, work, world, timeout=120)
        runs[world] = [torch.load(os.path.join(work, f"out{r}.pt"))
                       for r in range(world)]
    return arrs, runs


def _near(got, want, what):
    diff = (got.double() - torch.as_tensor(want).double()).abs().max()
    assert float(diff) <= 1e-6, (what, float(diff))


def _unsplit(arrs):
    """Autograd through the unsplit products and loss."""
    t = {k: torch.from_numpy(v) for k, v in arrs.items()}
    want = {}
    x, w = t["x"].clone().requires_grad_(), t["w"].clone().requires_grad_()
    y = x @ w
    (y * t["gy"]).sum().backward()
    want["col"] = (y.detach(), x.grad, w.grad)
    x, w = t["x"].clone().requires_grad_(), t["w2"].clone().requires_grad_()
    y = x @ w
    (y * t["gy2"]).sum().backward()
    want["row"] = (y.detach(), x.grad, w.grad)
    return want


@pytest.mark.parametrize("fn", ["to_model", "from_model", "gather_columns"])
def test_autograd_function_against_the_unsplit_product(unit_runs, fn):
    """On 2 ranks each function's output and gradients equal autograd
    through the unsplit product's (each rank's block of them) within
    1e-6; each counts one collective; at a group of one it moves and
    counts nothing and the output is the product's, bit for bit."""
    arrs, runs = unit_runs
    want = _unsplit(arrs)
    key = {"to_model": "to", "from_model": "from",
           "gather_columns": "gather"}[fn]
    y, dx, dw = want["row" if fn == "from_model" else "col"]
    for r, got in enumerate(runs[2]):
        o = got["out"]
        cols = slice(2 * r, 2 * r + 2)
        if fn == "to_model":
            _near(o["to_y"], y[:, cols], fn)
            _near(o["to_dx"], dx, fn)
            _near(o["to_dw"], dw[:, cols], fn)
        elif fn == "from_model":
            _near(o["from_y"], y, fn)
            _near(o["from_dx"], dx[:, 4 * r:4 * r + 4], fn)
            _near(o["from_dw"], dw[4 * r:4 * r + 4], fn)
        else:
            _near(o["gather_y"], y, fn)
            _near(o["gather_dw"], dw[:, cols], fn)
        assert got["counts"][fn] == {
            "to_model": {"model_all_reduce:bwd": 1},
            "from_model": {"model_all_reduce:fwd": 1},
            "gather_columns": {"model_reduce_scatter:w": 1}}[fn], got
    if fn == "gather_columns":
        # Each rank's dx is its rows' part: "to model" would sum them.
        _near(sum(got["out"]["gather_dx"] for got in runs[2]), dx, fn)
    one = runs[1][0]
    assert one["counts"][fn] == {}, one["counts"]
    assert torch.equal(one["out"][key + "_y"], y)
    assert torch.equal(one["out"][key + "_dx"], dx)
    assert torch.equal(one["out"][key + "_dw"], dw)


def test_vocab_parallel_cross_entropy(unit_runs):
    """On 2 ranks, each holding half the vocab columns of the head: the
    loss equals the unsplit ``chunked_cross_entropy``'s and the gradients
    its (the head's: the rank's block) within 1e-6, through 1 "to model"
    all-reduce and 3 forward all-reduces a chunk, each again in the
    chunk's recompute; at a group of one it is the unsplit function, bit
    for bit, counting nothing."""
    _, runs = unit_runs
    plain = runs[1][0]["out"]
    for r, got in enumerate(runs[2]):
        o = got["out"]
        _near(o["ce"], plain["ce_plain"], "loss")
        _near(o["ce_dh"], plain["ce_plain_dh"], "dh")
        _near(o["ce_dhead"], plain["ce_plain_dhead"][:, 8 * r:8 * r + 8],
              "dhead")
        assert got["counts"]["ce"] == {"model_all_reduce:fwd": 3 * 3 * 2,
                                       "model_all_reduce:bwd": 1}, got
        assert got["counts"]["ce_plain"] == {}, got
    one = runs[1][0]
    assert one["counts"]["ce"] == {}, one["counts"]
    for k in ("", "_dh", "_dhead"):
        assert torch.equal(one["out"]["ce" + k], plain["ce_plain" + k]), k
