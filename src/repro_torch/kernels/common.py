"""Shared kernel utilities: activations, padding, impl dispatch, and the
build of the hand-written CUDA kernels.

Counterpart of ``repro/kernels/common.py``.  ``ACTIVATIONS`` matches it
exactly (``gelu`` is the tanh approximation, ``silu``/``swish`` are one
function), so a fused epilogue computes the same values on both sides.

Dispatch (``use_kernel``): ``impl="reference"`` runs the plain PyTorch
version on any device; ``"auto"`` runs the CUDA kernel on a CUDA tensor
and the plain version on a CPU tensor; ``"cuda"`` runs the kernel and
raises on a CPU tensor.  Nothing falls back from a failed build or
launch to the plain version.

Kernels are CUDA C++ sources under ``csrc/``, compiled at first use by
``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the repository root
(one shared library with a plain C interface per source, loaded with
``ctypes``).  The library name carries a hash of its source and of every
header it includes (``csrc/hopper.cuh``: the TMA, mbarrier, mma and
wgmma helpers), so an edited source or header is rebuilt and a stale
library is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch
import torch.nn.functional as F

__all__ = ["ACTIVATIONS", "ACT_CODES", "apply_activation", "pad_to", "unpad",
           "resolve_device", "use_kernel", "build_kernels", "load_library",
           "check_launch", "recompute_grads", "BUILD_DIR", "CSRC_DIR"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNEL_SOURCES = {"conv2d": "conv2d.cu", "conv2d_strips": "conv2d_strips.cu",
                  "matmul": "matmul.cu",
                  "flash_attention": "flash_attention.cu",
                  "flash_attention_bwd": "flash_attention_bwd.cu",
                  "decode_attention": "decode_attention.cu",
                  "paged_decode_attention": "paged_decode_attention.cu",
                  "mamba2_scan": "mamba2_scan.cu", "wkv6": "wkv6.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def pad_to(x: torch.Tensor, multiples: tuple[int, ...]) -> torch.Tensor:
    """Zero-pad trailing dims of ``x`` up to the given multiples."""
    pads = []
    for dim, m in zip(reversed(x.shape[-len(multiples):]),
                      reversed(multiples)):
        pads += [0, -dim % m]
    if not any(pads):
        return x
    return F.pad(x, pads)


def unpad(x: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    if tuple(x.shape) == tuple(shape):
        return x
    return x[tuple(slice(0, s) for s in shape)]


def recompute_grads(fn, saved, need, upstream):
    """The gradients of ``fn(*saved)`` (a tuple of outputs) in the
    inputs ``need`` marks, for the upstream gradients given (None for an
    output nobody read); None for the rest.  ``fn`` is recomputed under
    autograd on detached copies of the saved inputs."""
    grads = [None] * len(saved)
    outs = [(i, g) for i, g in enumerate(upstream) if g is not None]
    wanted = [i for i, n in enumerate(need) if n]
    if not outs or not wanted:
        return grads
    with torch.enable_grad():
        xs = [None if t is None else t.detach().requires_grad_(n)
              for t, n in zip(saved, need)]
        res = fn(*xs)
        got = torch.autograd.grad([res[i] for i, _ in outs],
                                  [xs[i] for i in wanted],
                                  [g for _, g in outs], allow_unused=True)
    for i, g in zip(wanted, got):
        grads[i] = g
    return grads


def _silu(x):
    return x * torch.sigmoid(x)


ACTIVATIONS = {
    None: lambda x: x,
    "none": lambda x: x,
    "relu": torch.relu,
    "silu": _silu,
    "swish": _silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
}

# The kernels' activation switch (csrc/*.cu ``activate``).
ACT_CODES = {None: 0, "none": 0, "relu": 1, "silu": 2, "swish": 2,
             "gelu": 3, "tanh": 4}


def apply_activation(x: torch.Tensor, name: str | None) -> torch.Tensor:
    return ACTIVATIONS[name](x)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    names another.  Raises when the card is asked for (or defaulted to)
    and none is present, so nothing carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def use_kernel(impl: str, x: torch.Tensor) -> bool:
    """True to launch the CUDA kernel, False for the plain version."""
    if impl == "reference":
        return False
    if impl == "auto":
        return x.is_cuda
    if impl == "cuda":
        if not x.is_cuda:
            raise RuntimeError(
                f"impl='cuda' needs CUDA tensors, got one on {x.device}")
        return True
    raise ValueError(f"impl must be auto|cuda|reference, got {impl!r}")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built from source at first use")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen: list[Path]) -> list[Path]:
    """``path`` and every header it includes by quotes, transitively,
    resolved against the including file's directory (as nvcc does)."""
    if path in seen:
        return seen
    seen.append(path)
    for inc in _INCLUDE.findall(path.read_bytes()):
        dep = path.parent / inc.decode()
        if dep.exists():
            _sources(dep, seen)
    return seen


def _lib_path(name: str) -> Path:
    """The library's path, named by a hash of its source, every header
    the source includes and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(CSRC_DIR / KERNEL_SOURCES[name], []):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}


def build_kernels(names=None) -> dict[str, float]:
    """Compile the named kernel sources (default: all), one ``nvcc`` per
    source, all started together; load each library.  Returns the
    seconds each build took (0.0 for one already built).  Raises with
    the compiler's output when a build fails."""
    names = tuple(KERNEL_SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if name in _LIBS or out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / KERNEL_SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds = {name: 0.0 for name in names}
    for name, (proc, _, _) in procs.items():     # wait for every build
        BUILD_LOGS[name] = proc.communicate()[0]
        seconds[name] = time.perf_counter() - t0
    failed = [name for name, (proc, _, _) in procs.items()
              if proc.returncode != 0]
    for name, (proc, tmp, out) in procs.items():
        if proc.returncode == 0:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(
            f"{name}:\n{BUILD_LOGS[name]}" for name in failed))
    for name in names:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return seconds


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    if name not in _LIBS:
        build_kernels((name,))
    return _LIBS[name]


def check_launch(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise on a non-zero ``cudaGetLastError`` a C launcher returned."""
    if err:
        fn = getattr(lib, f"{name}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{fn(err).decode()} (cudaError {err})")
