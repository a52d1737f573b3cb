"""The port stands alone: no module of ``repro_torch`` and nothing in
``chip_smoke.py`` imports jax or the ``repro`` package."""
import ast
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 15, names
"""


def test_importing_every_port_module_loads_no_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# The training slice's subpackages and the multi-device ones, each
# imported alone in a fresh interpreter: none of them may pull in jax or
# repro.
TRAINING_MODULES = ["repro_torch.optim", "repro_torch.data", "repro_torch.obs",
                    "repro_torch.checkpoint", "repro_torch.runtime.trainer",
                    "repro_torch.launch.train", "repro_torch.parallel",
                    "repro_torch.launch.mesh"]


@pytest.mark.parametrize("module", TRAINING_MODULES)
def test_training_modules_load_no_jax_or_repro(module):
    probe = (f"import importlib, sys; importlib.import_module({module!r}); "
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'repro')); assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# The recurrent families' modules and kernels, each imported alone.
FAMILY_MODULES = ["repro_torch.kernels.mamba2", "repro_torch.kernels.rwkv6",
                  "repro_torch.models.zamba2", "repro_torch.models.rwkv"]


@pytest.mark.parametrize("module", FAMILY_MODULES)
def test_family_modules_load_no_jax_or_repro(module):
    test_training_modules_load_no_jax_or_repro(module)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_repro_import_in_source(path):
    for mod in _imported_roots(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), (path, mod)


# The dry-run tooling's modules, each imported alone.
DRYRUN_MODULES = ["repro_torch.core.roofline",
                  "repro_torch.core.step_analysis",
                  "repro_torch.launch.dryrun", "repro_torch.launch.report"]


@pytest.mark.parametrize("module", DRYRUN_MODULES)
def test_dryrun_modules_load_no_jax_or_repro(module):
    test_training_modules_load_no_jax_or_repro(module)


# Every entry point (a module with a ``main``) runs on the card unless
# the caller names another device; these take no device by design: the
# dry-run counts on the CPU over fake tensors, the report and the
# replay's error table read files.
CARD_ENTRY_POINTS = {
    "repro_torch.launch.serve": ["--arch", "smollm-360m", "--smoke"],
    "repro_torch.launch.train": ["--arch", "smollm-360m", "--smoke",
                                 "--steps", "1"],
    "repro_torch.core.autotune": ["--config", "smollm-360m-smoke",
                                  "--cache", "{tmp}/tuned.json"],
}
HOST_ENTRY_POINTS = {"repro_torch.launch.dryrun", "repro_torch.launch.report",
                     "repro_torch.runtime.replay"}


def test_every_entry_point_is_classified():
    found = set()
    for d, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py") and "\ndef main(" in open(
                    os.path.join(d, f)).read():
                rel = os.path.relpath(os.path.join(d, f[:-3]),
                                      os.path.dirname(PORT))
                found.add(rel.replace(os.sep, "."))
    assert found == set(CARD_ENTRY_POINTS) | HOST_ENTRY_POINTS


@pytest.mark.parametrize("module", sorted(CARD_ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(module, tmp_path):
    """Without ``--device`` an entry point asks for the card: on a host
    with none it raises rather than carry on quietly on the CPU."""
    import importlib
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    main = importlib.import_module(module).main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([a.format(tmp=tmp_path) for a in CARD_ENTRY_POINTS[module]])
    assert not list(tmp_path.iterdir())


def test_dryrun_runs_on_the_cpu_by_design():
    from repro_torch.launch import dryrun
    assert "runs on the CPU by design" in " ".join(dryrun.__doc__.split())
    assert not any("--device" in a for a in dryrun.main.__code__.co_consts
                   if isinstance(a, str))
