"""Scheduled matmul: the Hopper kernel and its plain version.

``matmul_cuda`` replaces ``repro/kernels/matmul/kernel.py::matmul_pallas``
(its ``pallas_call`` at line 161): ``(M,K) x (K,N)`` with f32
accumulation and the epilogue bias -> activation -> bypass, in float32
or bfloat16 (every operand and the output in the one type, as the
reference writes ``out_dtype = a.dtype``).  The source is
``csrc/matmul.cu``.

What bounds it on an H100: the FC layers of the CNN Programs and the LM
decode projections have M = batch or slots (a few rows) and 0.6-151 MB
of weights, about M/2 FLOP per weight byte in f32 (M in bf16), far
below the card's ridge, so the weight bytes over HBM bound it (fc_08 at
batch 8: 151 MB, 45 us at 3.35 TB/s).  The kernel streams disjoint
32-column weight slabs per CTA with a deep K slice and a register
prefetch, and masks the ragged edges of M, N and K instead of padding
the operands to the schedule's block (``repro/kernels/matmul/ops.py:
57-69`` pads).

The three dataflows keep their meaning as CTA orders (see the source):
the schedule's ``block`` and ``dataflow`` are taken verbatim.
``matmul_plain`` computes the same function with PyTorch ops.
"""
from __future__ import annotations

import ctypes

import torch

from ...core.dataflow import Dataflow
from ..common import ACT_CODES, check_launch, load_library
from .ref import matmul_ref

__all__ = ["matmul_cuda", "matmul_plain"]

_DATAFLOW_CODES = {Dataflow.MAPS_RESIDENT: 0, Dataflow.WEIGHTS_RESIDENT: 1,
                   Dataflow.OUTPUT_STATIONARY: 2}


def matmul_plain(a, b, *, bias=None, activation: str | None = None,
                 bypass=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch ops (a: (M,K), b: (K,N));
    the schedule's dataflow and block change the order of work, not the
    result, so it takes neither."""
    return matmul_ref(a, b, bias=bias, activation=activation, bypass=bypass)


def launch_args(a, b, out, *, dataflow: Dataflow,
                block: tuple[int, int, int], bias=None,
                activation: str | None = None, bypass=None) -> list:
    """Checks the operands and returns ``matmul_f32`` / ``matmul_bf16``'s
    arguments after the five pointers' tensors and before the stream."""
    if a.dtype not in _LAUNCHERS:
        raise TypeError(f"matmul_cuda: a must be float32 or bfloat16, got "
                        f"{a.dtype}")
    M, K = a.shape
    N = b.shape[1]
    want = {"a": (a, (M, K)), "b": (b, (K, N)), "out": (out, (M, N))}
    if bias is not None:
        want["bias"] = (bias, (N,))
    if bypass is not None:
        want["bypass"] = (bypass, (M, N))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != a.dtype:
            raise TypeError(f"matmul_cuda: {name} must be {a.dtype} "
                            f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.device != a.device:
            raise ValueError(f"matmul_cuda: {name} must be contiguous on "
                             f"{a.device}")
    bm, _, bn = block
    return [M, K, N, _DATAFLOW_CODES[dataflow], bm, bn,
            ACT_CODES[activation]]


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_LAUNCHERS = {torch.float32: "matmul_f32", torch.bfloat16: "matmul_bf16"}


def _launcher(dtype):
    lib = load_library("matmul")
    fn = getattr(lib, _LAUNCHERS[dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return lib, fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def matmul_cuda(a, b, *, dataflow: Dataflow = Dataflow.OUTPUT_STATIONARY,
                block: tuple[int, int, int] = (128, 128, 128), bias=None,
                activation: str | None = None, bypass=None) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors: a (M,K), b (K,N), bias
    (N,), bypass (M,N), all float32 or all bfloat16, and contiguous;
    ragged shapes are fine.  Raises on a CPU tensor."""
    if not a.is_cuda:
        raise RuntimeError(f"matmul_cuda needs CUDA tensors, got one on "
                           f"{a.device}")
    out = torch.empty((a.shape[0], b.shape[1]), dtype=a.dtype,
                      device=a.device)
    args = launch_args(a, b, out, dataflow=dataflow, block=block, bias=bias,
                       activation=activation, bypass=bypass)
    lib, fn = _launcher(a.dtype)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(_ptr(a), _ptr(b), _ptr(bias), _ptr(bypass), _ptr(out),
                 *args, stream)
    check_launch(lib, "matmul", err)
    matmul_cuda.launches += 1
    return out


matmul_cuda.launches = 0
