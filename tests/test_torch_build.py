"""The kernel build helper, driven through a stand-in ``nvcc``: one
compiler process per source, libraries named by source hash, reuse of
a finished build, a rebuild when an included header changes, and a
failed build raising with the compiler's log."""
import os
import shutil
import stat

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import common  # noqa: E402

FAKE_NVCC = """#!/bin/sh
# Stand-in compiler: log the call, build an empty shared library at -o.
echo "$@" >> "$(dirname "$0")/calls.log"
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  shift
done
echo "ptxas info    : Used 1 registers"
exec cc -shared -fPIC -x c /dev/null -o "$out"
"""


@pytest.fixture
def fake_toolkit(tmp_path, monkeypatch):
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(common, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(common, "_LIBS", {})
    monkeypatch.setattr(common, "BUILD_LOGS", {})
    return bindir


def test_build_kernels_compiles_each_source_once(fake_toolkit):
    secs = common.build_kernels()
    assert set(secs) == set(common.KERNEL_SOURCES)
    calls = (fake_toolkit / "calls.log").read_text().splitlines()
    assert len(calls) == len(common.KERNEL_SOURCES)
    for call in calls:
        assert "arch=compute_90a,code=sm_90a" in call
        assert call.split()[-1].endswith(".cu")
    for name in common.KERNEL_SOURCES:
        assert common._lib_path(name).exists()
        assert "registers" in common.BUILD_LOGS[name]
    # Loaded libraries and finished builds are reused, not rebuilt.
    assert common.load_library("conv2d") is common._LIBS["conv2d"]
    common._LIBS.clear()
    assert common.build_kernels() == {n: 0.0 for n in common.KERNEL_SOURCES}
    assert len((fake_toolkit / "calls.log").read_text().splitlines()) == len(
        common.KERNEL_SOURCES)
    assert not [p for p in os.listdir(common.BUILD_DIR) if p.endswith(".tmp")]


def test_failed_build_raises_with_the_compiler_log(fake_toolkit):
    (fake_toolkit / "nvcc").write_text(
        "#!/bin/sh\necho 'error: no such intrinsic' >&2\nexit 1\n")
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        common.build_kernels(["matmul"])
    assert not common._lib_path("matmul").exists()


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(common, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(common, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        common.build_kernels(["conv2d"])


def test_editing_an_included_header_rebuilds(fake_toolkit, tmp_path,
                                             monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(common.CSRC_DIR, csrc)
    monkeypatch.setattr(common, "CSRC_DIR", csrc)
    assert b'#include "hopper.cuh"' in (csrc / "matmul.cu").read_bytes()
    common.build_kernels(["matmul"])
    before, conv = common._lib_path("matmul"), common._lib_path("conv2d")
    assert before.exists()
    with open(csrc / "hopper.cuh", "a") as f:
        f.write("\n// an edited helper\n")
    after = common._lib_path("matmul")
    assert after != before and not after.exists()
    assert common._lib_path("conv2d") == conv     # includes no header
    common._LIBS.clear()
    common.build_kernels(["matmul"])
    assert after.exists()
    assert len((fake_toolkit / "calls.log").read_text().splitlines()) == 2
