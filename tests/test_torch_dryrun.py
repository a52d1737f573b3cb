"""Mini dry-run (counterpart of ``tests/test_sharding_mini.py``): every
LM family's ``smoke()`` config, all three step kinds, counted by
``repro_torch.launch.dryrun`` on a (2, 4) ("data", "model") and a
(2, 2, 2) ("pod", "data", "model") mesh of a fake world of 8 ranks, in
one subprocess (one default process group per process).  Every record
has FLOPs > 0 and the keys of ``repro``'s dry-run record.

Parity with ``repro``'s mini dry-run (its script: 8 forced host
devices, ``analyze_hlo_text``, in a subprocess of its own, run while the
port's runs) on smollm-360m's ``smoke()``, batch 8 x 64, on (2, 4),
within 0.1%: under ``fsdp`` the port's FLOPs per chip equal the
reference's.  Under ``tp`` the prefill and the train step run split over
"model" (``parallel/split.py``) and exceed the reference's by the K / V
projections alone: each of the 2 KV heads serves 2 of the 4 "model"
ranks (the "shared_kv" head case) and both compute its 16 K and 16 V
columns where GSPMD computes a rank's 8.  In the prefill that is
1.0908 times the reference's.  In the train step each duplicate
product runs three times (forward, and dx and dw backward), so the
excess is 3 x 2 (K and V) x 2 x 256 tokens a rank x 64 x 8 x 4 layers
= 6,291,456 FLOPs over the reference's 79,691,776: 1.0789 times.
"""
import ast
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

ARCHS = ["smollm-360m", "granite-moe-1b-a400m", "rwkv6-7b", "zamba2-7b",
         "whisper-base", "llama-3.2-vision-11b", "llama4-maverick-400b-a17b"]
KINDS = ["train", "prefill", "decode"]
MESHES = ["single", "multi"]
PARITY = [("fsdp", "prefill", 1), ("fsdp", "train", 1),
          ("tp", "prefill", 1.0908), ("tp", "train", 1.0789)]

PORT = r"""
import json, sys, warnings
sys.path.insert(0, SRC)
import torch
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.hw import MeshDescriptor
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh_from_descriptor
from repro_torch.optim import AdamW
from repro_torch.parallel import make_plan
warnings.simplefilter("ignore", FutureWarning)
torch.set_num_threads(1)
dryrun.fake_world(8)
SHAPES = [ShapeSpec("t", 64, 8, "train"), ShapeSpec("p", 64, 8, "prefill"),
          ShapeSpec("d", 64, 8, "decode")]
out = {}
for pod in (False, True):
    desc = (MeshDescriptor((2, 2, 2), ("pod", "data", "model")) if pod
            else MeshDescriptor((2, 4), ("data", "model")))
    mesh = make_mesh_from_descriptor(desc, "cpu")
    cells = [(arch, "auto") for arch in ARCHS]
    if not pod:
        cells += [("smollm-360m", "fsdp"), ("smollm-360m", "tp")]
    for arch, strategy in cells:
        cfg = get_config(arch).smoke()
        for shape in SHAPES:
            if strategy != "auto" and shape.kind == "decode":
                continue
            rec = dryrun.cell_record(
                cfg, shape, make_plan(cfg, shape, desc, strategy), mesh,
                arch=arch, mesh_name="x".join(map(str, desc.shape)),
                optimizer=AdamW())
            key = f"{arch}|{strategy}|{shape.kind}|{'multi' if pod else 'single'}"
            out[key] = rec
print("RESULTS_JSON:" + json.dumps(out))
"""

REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
sys.path.insert(0, SRC)
import jax
from repro.configs import get_config, ShapeSpec
from repro.core.hw import MeshDescriptor
from repro.parallel.rules import make_plan
from repro.launch.mesh import make_mesh_from_descriptor
from repro.launch.steps import build_step
from repro.optim import AdamW
from repro.core.hlo_analysis import analyze_hlo_text

desc = MeshDescriptor((2, 4), ("data", "model"))
mesh = make_mesh_from_descriptor(desc)
cfg = get_config("smollm-360m").smoke()
out = {}
for strategy, kind, _ in PARITY:
    shape = ShapeSpec(kind[0], 64, 8, kind)
    with mesh:
        plan = make_plan(cfg, shape, desc, strategy)
        b = build_step(cfg, shape, plan, mesh, optimizer=AdamW())
        compiled = b.fn.lower(*b.args).compile()
        st = analyze_hlo_text(compiled.as_text(), desc.n_chips)
    out[f"{strategy}|{kind}"] = st.flops
print("RESULTS_JSON:" + json.dumps(out))
"""


def _start(code: str, **names):
    prelude = "".join(f"{k} = {v!r}\n" for k, v in names.items())
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", prelude + code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def _results(proc, timeout=600) -> dict:
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out[-2000:] + err[-4000:]
    line = [l for l in out.splitlines() if l.startswith("RESULTS_JSON:")]
    assert line, out[-2000:]
    return json.loads(line[0][len("RESULTS_JSON:"):])


@pytest.fixture(scope="module")
def runs():
    """Both mini dry-runs, the reference's and the port's, at once."""
    ref = _start(REFERENCE, SRC=SRC, PARITY=PARITY)
    port = _start(PORT, SRC=SRC, ARCHS=ARCHS)
    try:
        return {"port": _results(port), "reference": _results(ref)}
    finally:
        for p in (ref, port):
            if p.poll() is None:
                p.kill()


def _reference_record_keys() -> set:
    """The keys of the record ``repro.launch.dryrun.run_cell`` writes."""
    tree = ast.parse(open(os.path.join(SRC, "repro", "launch",
                                       "dryrun.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "record"
                        for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no record dict in repro/launch/dryrun.py")


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_mini_dryrun_every_family_counts(runs, arch, kind, mesh):
    rec = runs["port"][f"{arch}|auto|{kind}|{mesh}"]
    assert set(rec) == _reference_record_keys()
    assert rec["hlo_flops"] > 0, rec
    assert rec["chips"] == 8 and rec["kind"] == kind
    assert rec["mesh"] == ("2x2x2" if mesh == "multi" else "2x4")
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0
    assert mem["temp_size_in_bytes"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")
    # every sharded step gathers its weights
    assert rec["coll_counts"].get("all-gather", 0) > 0


@pytest.mark.parametrize("strategy,kind,times", PARITY)
def test_flops_per_chip_against_the_reference(runs, strategy, kind, times):
    ref = runs["reference"][f"{strategy}|{kind}"]
    rec = runs["port"][f"smollm-360m|{strategy}|{kind}|single"]
    got = rec["hlo_flops"] / rec["chips"]
    assert ref > 0
    assert abs(got - times * ref) / (times * ref) < 1e-3, (got, ref, times)
