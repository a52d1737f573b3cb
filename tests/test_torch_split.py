"""The split execution's head-case decision (``parallel/split.py``):
``head_case`` over every case of (H, KV, hd, g), the registry's dense
configs at the reference's "model" sizes among them, and each case run
by the dense family's sharded prefill and decode
(``launch/steps.py::build_step``) on a fake world of 8 ranks
(``launch/dryrun.fake_world``: fake tensors, collectives that move
nothing; one default process group per process, so in a subprocess),
read back from ``split.COUNTS``: the head counts each flash and decode
launch saw, the weights gathered over "model", the cache exchanges, and
no whole cache leaf gathered.  The values are held on gloo ranks
(``tests/test_torch_sharded.py``)."""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from repro_torch.parallel.split import HEAD_CASES, head_case  # noqa: E402

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
# one decode step), smoke configs: 4 layers, 4 / 2 heads of 16 (smollm)
# or 4 / 4 (olmo); smollm-360m at full width: 32 layers, 15 / 5 of 64.
def _gathers(L, names):
    return {f"model_gather:{n}": L for n in names}


CELLS = [
    ("olmo-whole-4", "olmo-1b", True, 4,
     {"flash:whole:1/1": 4}, {"decode:whole:1/1": 4}),
    ("smollm-whole-2", "smollm-360m", True, 2,
     {"flash:whole:2/1": 4}, {"decode:whole:2/1": 4}),
    ("smollm-shared-4", "smollm-360m", True, 4,
     {"flash:shared_kv:1/1": 4, **_gathers(4, ("wk", "wv")),
      "kv_exchange": 8},
     {"decode:shared_kv:1/1": 4, **_gathers(4, ("wk", "wv")),
      "kv_exchange": 8}),
    ("smollm-cut-8", "smollm-360m", True, 8,
     {"flash:cut:4/2": 4, **_gathers(4, ("wq", "wk", "wv"))},
     {"decode:cut:4/2": 4, **_gathers(4, ("wq", "wk", "wv")),
      "kv_layer_gather": 8}),
    ("smollm-full-cut-4", "smollm-360m", False, 4,
     {"flash:cut:15/5": 32, **_gathers(32, ("wq", "wk", "wv"))},
     {"decode:cut:15/5": 32, **_gathers(32, ("wq", "wk", "wv")),
      "kv_layer_gather": 64}),
    ("smollm-full-whole-5", "smollm-360m", False, 5,
     {"flash:whole:3/1": 32}, {"decode:whole:3/1": 32}),
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
for cid, arch, smoke, g, _, _ in CELLS:
    cfg = get_config(arch)
    cfg = cfg.smoke() if smoke else cfg
    desc = MeshDescriptor((1, g), ("data", "model"))
    mesh = make_mesh_from_descriptor(desc, "cpu")
    out[cid] = []
    for kind in ("prefill", "decode"):
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
    """tp's prefill and one decode step of each cell, counted: every
    layer's flash and decode launch at the rank's head counts, exactly
    the expected gathers and exchanges, no whole cache leaf."""
    cid, _, _, _, prefill, decode = cell
    assert counted[cid] == [prefill, decode], (cid, counted[cid])
